"""Heuristics to segment model controls into discrete notes.

Port of ddsp_tpu/eval/heuristics.py, in numpy on the host: segment_notes
(_batch), the binarizers (amp_pooled_outliers, strided_freq_change,
power_pooled_outliers, midi_heuristic, midi_heuristic_power), the pickers
(mean_f0, median_f0, median_amps), remove_short and pad_for_frame. Notes
are plain dataclasses, with `to_note_seq` where the note_seq package is
installed. power_pooled_outliers computes the power with the port's
ops/spectral.py on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from ddsp_torch.ops import spectral
from ddsp_torch.ops.core import hz_to_midi

DDSP_DEFAULT_FRAME_RATE = 250
DB_RANGE = 80.0


@dataclasses.dataclass
class Note:
  """One segmented note."""

  pitch: int
  start_time: float
  end_time: float
  velocity: int = 127


@dataclasses.dataclass
class NoteSequence:
  """A monophonic sequence of segmented notes."""

  notes: List[Note] = dataclasses.field(default_factory=list)
  total_time: float = 0.0

  def to_note_seq(self):
    """Convert to a note_seq.NoteSequence proto (optional dependency)."""
    import note_seq  # pylint: disable=g-import-not-at-top
    sequence = note_seq.NoteSequence()
    for n in self.notes:
      note = sequence.notes.add()
      note.pitch = n.pitch
      note.start_time = n.start_time
      note.end_time = n.end_time
      note.velocity = n.velocity
    sequence.total_time = self.total_time
    return sequence


def _midi(f0_hz) -> np.ndarray:
  """hz_to_midi of host values, as numpy (float32, as in the JAX package)."""
  return hz_to_midi(np.asarray(f0_hz, np.float32)).numpy()


def _frame(x: np.ndarray, frame_length: int, frame_step: int) -> np.ndarray:
  """Strided framing of a 1-D array -> [n_frames, frame_length]."""
  n = len(x)
  n_frames = max(0, 1 + (n - frame_length) // frame_step)
  idx = (np.arange(n_frames)[:, None] * frame_step +
         np.arange(frame_length)[None, :])
  return x[idx]


def get_active_frame_indices(piano_roll: np.ndarray) -> np.ndarray:
  """Per-note frame counters since onset, [time, pitch]."""
  active = np.zeros_like(piano_roll)
  for i in range(1, active.shape[0]):
    active[i, :] = (active[i - 1, :] + 1) * piano_roll[i, :]
  return active


def unbatch(batch: Dict) -> List[Dict]:
  """Split a dict of batched arrays into a list of per-example dicts."""
  unbatched: List[Dict] = []
  for key, val in batch.items():
    if val is None:
      continue
    if isinstance(val, dict):
      sub = unbatch(val)
      if not unbatched:
        unbatched = [{} for _ in sub]
      for i, s in enumerate(sub):
        unbatched[i][key] = s
    else:
      val = np.asarray(val)
      if not unbatched:
        unbatched = [{} for _ in range(val.shape[0])]
      assert val.shape[0] == len(unbatched), (
          f'batch size mismatch: {val.shape[0]} vs {len(unbatched)}')
      for i in range(val.shape[0]):
        unbatched[i][key] = val[i]
  return unbatched


def segment_notes(binarize_f: Callable, pick_f0_f: Callable,
                  pick_amps_f: Callable, controls: Dict,
                  frame_rate: int = DDSP_DEFAULT_FRAME_RATE) -> NoteSequence:
  """Split a (single-example) controls dict into discrete notes."""
  sequence = NoteSequence()

  def construct_note(curr_ind, duration):
    note_start = curr_ind - duration
    f0 = pick_f0_f(controls, start=note_start, stop=curr_ind)
    pick_amps_f(controls, start=note_start, stop=curr_ind)  # TODO velocity.
    sequence.notes.append(Note(
        pitch=int(np.round(_midi(f0))),
        start_time=note_start / frame_rate,
        end_time=(note_start + duration) / frame_rate,
        velocity=127))

  binary_sample = np.asarray(binarize_f(controls))
  has_been_on = 0
  for i, sample_i in enumerate(binary_sample):
    if sample_i:
      has_been_on += 1
    elif has_been_on > 0:
      construct_note(i, has_been_on)
      has_been_on = 0
  if has_been_on > 0:
    construct_note(len(binary_sample), has_been_on)

  sequence.total_time = len(binary_sample) / frame_rate
  return sequence


def segment_notes_batch(binarize_f: Callable, pick_f0_f: Callable,
                        pick_amps_f: Callable, controls_batch: Dict,
                        frame_rate: int = DDSP_DEFAULT_FRAME_RATE
                        ) -> List[NoteSequence]:
  """segment_notes over every example in a batch of controls."""
  return [segment_notes(binarize_f, pick_f0_f, pick_amps_f, controls,
                        frame_rate)
          for controls in unbatch(controls_batch)]


# ----- PICK_F0_F candidates ---------------------------------------------------
def mean_f0(controls, start, stop):
  return np.mean(np.asarray(controls['f0_hz'])[start:stop])


def median_f0(controls, start, stop):
  return np.median(np.asarray(controls['f0_hz'])[start:stop])


# ----- PICK_AMPS_F candidates ---------------------------------------------------
def median_amps(controls, start, stop):
  amps = np.squeeze(
      np.asarray(controls['harmonic']['controls']['amplitudes']))
  return np.median(amps[start:stop])


# ----- BINARIZE_F candidates ----------------------------------------------------
def remove_short(is_on_vec: np.ndarray, min_samples: int = 20,
                 glue_back: bool = False) -> np.ndarray:
  """Remove short on-stretches (optionally merging them backwards)."""
  has_been_on = 0
  prev_note_end = 0
  for i, is_on in enumerate(is_on_vec):
    if is_on:
      has_been_on += 1
    else:
      if has_been_on < min_samples:
        if glue_back:
          is_on_vec[prev_note_end:i] = True
        else:
          is_on_vec[i - has_been_on:i] = False
      has_been_on = 0
      prev_note_end = i
  return is_on_vec


def pad_for_frame(vec: np.ndarray, mode: str, frame_width: int,
                  axis: int = 0) -> np.ndarray:
  """Edge-value padding so each element centers (or leads/trails) a frame."""
  if mode == 'front':
    pad = (frame_width - 1, 0)
  elif mode == 'center':
    pad = (frame_width // 2, frame_width - frame_width // 2 - 1)
  elif mode == 'end':
    pad = (0, frame_width - 1)
  else:
    raise ValueError(f'Unrecognized pad mode {mode}.')
  return np.pad(vec, pad, mode='constant',
                constant_values=(np.take(vec, 0, axis),
                                 np.take(vec, -1, axis)))


def amp_pooled_outliers(controls, frame_width: int = 80,
                        num_devs: float = 2, pad_mode: str = 'center'
                        ) -> np.ndarray:
  """True where amps are NOT n std devs below their neighborhood mean."""
  log_amps = np.log(np.squeeze(
      np.asarray(controls['harmonic']['controls']['amplitudes'])))
  padded = pad_for_frame(log_amps, pad_mode, frame_width)
  frames = _frame(padded, frame_width, 1)
  low_pooled = np.mean(frames, -1) - num_devs * np.std(frames, -1)
  return low_pooled < log_amps


def strided_freq_change(controls, frame_widths=(2, 4, 8, 16, 32),
                        pad_mode: str = 'front') -> np.ndarray:
  """False at f0 transitions >= ~1 semitone at any stride; True elsewhere."""
  f0 = np.squeeze(np.asarray(controls['f0_hz']))
  f0_midi = _midi(f0)
  transitions = np.ones(len(f0), dtype=bool)
  for frame_width in frame_widths:
    padded_f0 = pad_for_frame(f0_midi, pad_mode, frame_width)
    frames = _frame(padded_f0, frame_width, 1)
    semitone_changes = np.abs(frames[..., 0] - frames[..., -1]) > 0.75

    padded_transitions = pad_for_frame(transitions, pad_mode, frame_width)
    prev = _frame(padded_transitions, frame_width, 1)
    boundary = np.argwhere(np.all(prev, axis=-1) & semitone_changes)
    transitions[boundary] = False
  return transitions & (f0 > 0)


def power_pooled_outliers(controls, frame_width: int = 80,
                          num_devs: float = 2.5, pad_mode: str = 'center'
                          ) -> np.ndarray:
  """Like amp_pooled_outliers, on power computed from the audio."""
  power = np.squeeze(spectral.compute_power(
      np.asarray(controls['audio'], np.float32)[np.newaxis],
      frame_size=256).numpy())
  shifted_power = power + DB_RANGE
  padded = pad_for_frame(shifted_power, pad_mode, frame_width)
  frames = _frame(padded, frame_width, 1)
  low_pooled = np.mean(frames, -1) - num_devs * np.std(frames, -1)
  return (low_pooled < shifted_power) & (shifted_power > 0)


def midi_heuristic(controls) -> np.ndarray:
  """Combined note-extraction heuristic on amps + f0 transitions."""
  return remove_short(
      strided_freq_change(controls) & amp_pooled_outliers(controls),
      min_samples=10)


def midi_heuristic_power(controls) -> np.ndarray:
  """midi_heuristic using audio power instead of extracted amplitudes."""
  return remove_short(
      strided_freq_change(controls) & power_pooled_outliers(controls),
      min_samples=10)
