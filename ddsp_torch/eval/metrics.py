"""Evaluation metrics: loudness, f0 and MIDI (numpy-side, outside the model).

Port of ddsp_tpu/eval/metrics.py. Loudness and CREPE's f0 are computed by
the port's torch ops on the metric's `device` (CUDA unless the caller says
otherwise); YIN, the distances, RPA/RCA and the MIDI note and frame counts
are numpy. Raw/chroma pitch accuracy follow mir_eval.melody's definition
(50-cent tolerance), note matching mir_eval.transcription's.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional

import numpy as np

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import crepe
from ddsp_torch.ops import spectral
from ddsp_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger('ddsp_torch')

MIN_F0_CONFIDENCE = 0.85
OUTLIER_MIDI_THRESH = 12


def _hz_to_midi(f0_hz) -> np.ndarray:
  return ops_core.hz_to_midi(np.asarray(f0_hz)).numpy()


def _midi_to_hz(notes) -> np.ndarray:
  return ops_core.midi_to_hz(np.asarray(notes)).numpy()


def _loudness(audio, sample_rate: int, frame_rate: int, device,
              n_fft: int = 512) -> np.ndarray:
  """spectral.compute_loudness of host audio on `device`, as numpy."""
  audio = ops_core.torch_float32(audio).to(device)
  return spectral.compute_loudness(audio, sample_rate=sample_rate,
                                   frame_rate=frame_rate,
                                   n_fft=n_fft).cpu().numpy()


def compute_audio_features(audio: np.ndarray,
                           n_fft: int = 512,
                           sample_rate: int = 16000,
                           frame_rate: int = 250,
                           device: DeviceLike = None
                           ) -> Dict[str, np.ndarray]:
  """Loudness features of audio [(batch,) n_samples], on `device`."""
  audio = np.asarray(audio)
  if audio.ndim == 1:
    audio = audio[np.newaxis, :]
  loudness_db = _loudness(audio, sample_rate, frame_rate,
                          resolve_device(device), n_fft)
  return {'audio': audio, 'loudness_db': loudness_db}


def l1_distance(prediction: np.ndarray, ground_truth: np.ndarray):
  """L1 distance, trimming to the shorter length."""
  prediction, ground_truth = np.asarray(prediction), np.asarray(ground_truth)
  min_length = min(prediction.shape[-1], ground_truth.shape[-1])
  return np.abs(prediction[..., :min_length] - ground_truth[..., :min_length])


def f0_dist_conf_thresh(f0_hz: np.ndarray,
                        f0_hz_gen: np.ndarray,
                        f0_confidence: Optional[np.ndarray] = None,
                        f0_confidence_thresh: float = MIN_F0_CONFIDENCE):
  """L1 MIDI distance between f0s, masked by confidence; None if outlier
  (a mean distance over 12 MIDI, or no confident frame)."""
  f0_hz = np.asarray(f0_hz).squeeze()
  f0_hz_gen = np.asarray(f0_hz_gen).squeeze()
  if f0_confidence is None:
    f0_confidence = np.ones_like(f0_hz)
  else:
    f0_confidence = np.asarray(f0_confidence).squeeze()

  if np.max(f0_confidence) < f0_confidence_thresh:
    return None

  f0_midi = _hz_to_midi(f0_hz)
  f0_midi_gen = _hz_to_midi(f0_hz_gen)
  freq_dist = l1_distance(f0_midi_gen, f0_midi)
  mask = (f0_confidence[..., :freq_dist.shape[-1]]
          >= f0_confidence_thresh).astype(np.float32)
  freq_dist = np.sum(freq_dist * mask) / max(np.sum(mask), 1e-8)
  if freq_dist > OUTLIER_MIDI_THRESH:
    return None
  return float(freq_dist)


def _cents_diff(f0_ref: np.ndarray, f0_est: np.ndarray) -> np.ndarray:
  ref = np.maximum(np.asarray(f0_ref, np.float64), 1e-8)
  est = np.maximum(np.asarray(f0_est, np.float64), 1e-8)
  return 1200.0 * np.log2(est / ref)


def raw_pitch_accuracy(f0_ref, f0_est, voicing, cent_tolerance=50.0):
  """Fraction of voiced frames within cent_tolerance (mir_eval definition)."""
  voicing = np.asarray(voicing, bool)
  if voicing.sum() == 0:
    return 0.0
  diff = np.abs(_cents_diff(f0_ref, f0_est))
  return float(np.mean(diff[voicing] <= cent_tolerance))


def raw_chroma_accuracy(f0_ref, f0_est, voicing, cent_tolerance=50.0):
  """Like RPA but octave errors are forgiven."""
  voicing = np.asarray(voicing, bool)
  if voicing.sum() == 0:
    return 0.0
  diff = _cents_diff(f0_ref, f0_est)
  diff = np.abs(diff - 1200.0 * np.round(diff / 1200.0))
  return float(np.mean(diff[voicing] <= cent_tolerance))


class BaseMetrics:
  """Base object for computing metrics on generated audio samples."""

  def __init__(self, sample_rate: int, frame_rate: int, name: str):
    self._sample_rate = sample_rate
    self._frame_rate = frame_rate
    self._name = name
    self._metrics: Dict[str, list] = {}

  @property
  def metrics(self):
    return self._metrics

  def _add(self, key: str, value: float):
    self._metrics.setdefault(key, []).append(float(value))

  def update_state(self, batch, audio_gen):
    raise NotImplementedError

  def flush(self, step: int) -> Dict[str, float]:
    """Return mean metrics and reset accumulators."""
    results = {f'metrics/{self._name}/{k}': float(np.mean(v))
               for k, v in self._metrics.items() if v}
    for k, v in results.items():
      logger.info('step %d %s = %.4f', step, k, v)
    self._metrics = {}
    return results


class LoudnessMetrics(BaseMetrics):
  """Mean L1 loudness difference in dB between real and generated audio."""

  def __init__(self, sample_rate=16000, frame_rate=250, name='loudness',
               device: DeviceLike = None):
    super().__init__(sample_rate, frame_rate, name)
    self._device = resolve_device(device)

  def update_state(self, batch: Dict[str, Any], audio_gen: np.ndarray):
    if 'loudness_db' in batch:
      loudness_original = np.asarray(batch['loudness_db'])
    else:
      loudness_original = _loudness(batch['audio'], self._sample_rate,
                                    self._frame_rate, self._device)
    loudness_gen = _loudness(audio_gen, self._sample_rate, self._frame_rate,
                             self._device)
    ld_dist = float(np.mean(l1_distance(loudness_original, loudness_gen)))
    self._add('loudness_db_l1', ld_dist)


class F0Metrics(BaseMetrics):
  """F0 metrics against resynthesized f0.

  Compares ground-truth f0 against the f0 the model used for synthesis
  (available in outputs), with RPA/RCA at 50-cent tolerance and mean L1
  MIDI distance.
  """

  def __init__(self, sample_rate=16000, frame_rate=250, rpa_tolerance=50.0,
               name='f0'):
    super().__init__(sample_rate, frame_rate, name)
    self._rpa_tolerance = rpa_tolerance

  def update_state(self, batch: Dict[str, Any], f0_hz_predict: np.ndarray):
    f0_ref = np.asarray(batch['f0_hz']).squeeze()
    f0_est = np.asarray(f0_hz_predict).squeeze()
    if f0_ref.ndim == 1:
      f0_ref, f0_est = f0_ref[np.newaxis], f0_est[np.newaxis]
    conf = batch.get('f0_confidence')
    for i in range(f0_ref.shape[0]):
      ref = f0_ref[i]
      n = min(len(ref), f0_est[i].shape[-1])
      ref, est = ref[:n], f0_est[i][:n]
      voicing = ref > 0
      self._add('raw_pitch_accuracy',
                raw_pitch_accuracy(ref, est, voicing, self._rpa_tolerance))
      self._add('raw_chroma_accuracy',
                raw_chroma_accuracy(ref, est, voicing, self._rpa_tolerance))
      conf_i = np.asarray(conf)[i][:n] if conf is not None else None
      dist = f0_dist_conf_thresh(ref, est, conf_i)
      if dist is not None:
        self._add('f0_dist_midi_l1', dist)


def crepe_weights_available(model_capacity: str = 'tiny') -> bool:
  """True when CREPE weights exist ($CREPE_WEIGHTS_DIR or the repository's
  assets/crepe; ops/crepe.py default_weights_path)."""
  return crepe.default_weights_path(model_capacity) is not None


def compute_f0_yin(audio: np.ndarray,
                   sample_rate: int = 16000,
                   frame_rate: int = 250,
                   frame_size: int = 2048,
                   fmin: float = 60.0,
                   fmax: float = 2000.0,
                   threshold: float = 0.1):
  """Classical YIN pitch tracker (numpy, weights-free).

  de Cheveigne & Kawahara (2002): per frame, the cumulative-mean-normalized
  difference function d'(tau) is searched for the first dip below
  `threshold` (walked to its local minimum, refined by parabolic
  interpolation); f0 = sample_rate / tau. Implemented fully vectorized
  over [batch, n_frames] with an FFT-based difference function.

  The weights-free estimator of the eval pitch metrics: RPA/RCA need only
  *an* f0 estimate.

  Args:
    audio: [n_samples] or [batch, n_samples] at sample_rate.
    sample_rate: Hz.
    frame_rate: Rate of f0 frames in Hz.
    frame_size: Analysis frame length (integration window = frame_size/2).
    fmin / fmax: F0 search band in Hz.
    threshold: YIN absolute threshold on d'.

  Returns:
    (f0_hz, f0_confidence): numpy float32, shape [(batch,) n_frames] with
    n_frames matching spectral.get_framed_lengths(..., 'center'). The
    confidence is 1 - d'(tau) (energy-gated to 0 on silent frames).
  """
  audio = np.asarray(audio, np.float32)
  was_1d = audio.ndim == 1
  audio = np.atleast_2d(audio)
  hop = sample_rate // frame_rate
  n_frames, _ = spectral.get_framed_lengths(audio.shape[1], frame_size,
                                            hop, 'center')
  pad = frame_size // 2
  x = np.pad(audio, ((0, 0), (pad, pad)))
  idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_size)[None, :]
  frames = x[:, idx].astype(np.float64)  # [B, F, N]

  w = frame_size // 2
  tau_max = min(w, int(sample_rate / fmin))
  tau_min = max(2, int(round(sample_rate / fmax)))
  taus = np.arange(tau_max + 1)

  # Difference function d(tau) = E0 + E(tau) - 2 c(tau) over a w-sample
  # integration window, with the cross term via FFT.
  head = frames[..., :w]
  nfft = int(2 ** np.ceil(np.log2(frame_size + w)))
  cc = np.fft.irfft(np.conj(np.fft.rfft(head, nfft)) *
                    np.fft.rfft(frames, nfft), nfft)[..., :tau_max + 1]
  e0 = np.sum(head ** 2, axis=-1, keepdims=True)
  csq = np.concatenate(
      [np.zeros(frames.shape[:-1] + (1,)), np.cumsum(frames ** 2, -1)], -1)
  e_tau = csq[..., taus + w] - csq[..., taus]
  d = np.maximum(e0 + e_tau - 2.0 * cc, 0.0)

  # Cumulative-mean normalization; d'(0) = 1 by definition.
  cum = np.cumsum(d[..., 1:], axis=-1)
  dprime = np.ones_like(d)
  dprime[..., 1:] = d[..., 1:] * taus[1:] / np.maximum(cum, 1e-12)

  band = dprime[..., tau_min:tau_max + 1]
  below = band < threshold
  any_below = below.any(axis=-1)
  t = np.where(any_below, np.argmax(below, axis=-1),
               np.argmin(band, axis=-1))
  # Walk the threshold crossing down to its local minimum (vectorized
  # fixed point; dips are a few samples wide, so this converges fast).
  for _ in range(64):
    nxt = np.minimum(t + 1, band.shape[-1] - 1)
    val_n = np.take_along_axis(band, nxt[..., None], -1)[..., 0]
    val_t = np.take_along_axis(band, t[..., None], -1)[..., 0]
    go = (val_n < val_t) & any_below & (nxt > t)
    if not go.any():
      break
    t = np.where(go, nxt, t)

  ta = t + tau_min  # absolute lag
  ta_c = np.clip(ta, 1, tau_max - 1)
  g = lambda off: np.take_along_axis(dprime, (ta_c + off)[..., None],
                                     -1)[..., 0]
  d0, d1, d2 = g(-1), g(0), g(1)
  denom = d0 - 2.0 * d1 + d2
  shift = np.where(np.abs(denom) > 1e-12, 0.5 * (d0 - d2) / denom, 0.0)
  shift = np.clip(shift, -0.5, 0.5)
  period = np.where((ta > tau_min) & (ta < tau_max), ta_c + shift,
                    ta).astype(np.float64)
  f0_hz = sample_rate / np.maximum(period, 1e-6)

  dp_best = np.take_along_axis(dprime, ta[..., None], -1)[..., 0]
  confidence = 1.0 - np.clip(dp_best, 0.0, 1.0)
  # Silence gate: an all-zero frame has d == 0 everywhere, which would
  # read as a perfectly periodic (confident) detection.
  silent = (e0[..., 0] / w) < 1e-9
  confidence = np.where(silent, 0.0, confidence)

  f0_hz = f0_hz.astype(np.float32)
  confidence = confidence.astype(np.float32)
  return (f0_hz[0], confidence[0]) if was_1d else (f0_hz, confidence)


class F0GenMetrics(BaseMetrics):
  """Pitch metrics of *generated audio* via a pitch estimator.

  Per sample, the pitch track of the generated audio against the dataset
  f0 (or the estimator run on the input audio), with outlier accounting,
  and RPA/RCA of the generated audio's pitch (50-cent tolerance).

  Attributes:
    estimator: 'yin' (classical, weights-free, numpy) or 'crepe' (with
      Viterbi, on `device`).
  """

  def __init__(self, sample_rate=16000, frame_rate=250, name=None,
               estimator='yin', rpa_tolerance=50.0,
               device: DeviceLike = None):
    if estimator not in ('yin', 'crepe'):
      raise ValueError(f'Unknown f0 estimator: {estimator!r}')
    super().__init__(sample_rate, frame_rate,
                     name if name else f'f0_{estimator}')
    self._estimator = estimator
    self._rpa_tolerance = rpa_tolerance
    self._outliers = []
    self._device = resolve_device(device) if estimator == 'crepe' else None

  def _estimate(self, audio: np.ndarray):
    if self._estimator == 'crepe':
      return spectral.compute_f0(np.asarray(audio),
                                 frame_rate=self._frame_rate, viterbi=True,
                                 device=self._device)
    return compute_f0_yin(np.asarray(audio), sample_rate=self._sample_rate,
                          frame_rate=self._frame_rate)

  def update_state(self, batch: Dict[str, Any], audio_gen: np.ndarray):
    batch_size = int(audio_gen.shape[0])
    for i in range(batch_size):
      f0_hz_gen, f0_conf_gen = self._estimate(audio_gen[i])
      if 'f0_hz' in batch:
        f0_hz_gt = np.asarray(batch['f0_hz'][i]).squeeze()
        if 'f0_confidence' in batch:
          f0_conf_gt = np.asarray(batch['f0_confidence'][i]).squeeze()
        else:
          f0_conf_gt = np.ones_like(f0_hz_gt)
      else:
        f0_hz_gt, f0_conf_gt = self._estimate(np.asarray(batch['audio'][i]))

      if np.max(f0_conf_gt) < MIN_F0_CONFIDENCE:
        continue  # Unreliable ground truth; discard sample.

      # Pitch accuracy of the generated audio (voiced, confident frames).
      n = min(f0_hz_gt.shape[-1], f0_hz_gen.shape[-1])
      ref, est = f0_hz_gt[:n], f0_hz_gen[:n]
      voicing = (ref > 0) & (f0_conf_gt[:n] >= MIN_F0_CONFIDENCE)
      self._add('raw_pitch_accuracy',
                raw_pitch_accuracy(ref, est, voicing, self._rpa_tolerance))
      self._add('raw_chroma_accuracy',
                raw_chroma_accuracy(ref, est, voicing, self._rpa_tolerance))

      f0_dist = f0_dist_conf_thresh(f0_hz_gt, f0_hz_gen, f0_conf_gt)
      if f0_dist is None:
        self._outliers.append(1.0)
        logger.info('sample %d has untrackable pitch content', i)
      else:
        self._outliers.append(0.0)
        self._add('f0_dist', f0_dist)

  def flush(self, step: int) -> Dict[str, float]:
    results = super().flush(step)
    if self._outliers:
      key = f'metrics/{self._name}/outlier_ratio'
      results[key] = float(np.mean(self._outliers))
      logger.info('step %d %s = %.4f', step, key, results[key])
      self._outliers = []
    if self._estimator == 'crepe':
      spectral.reset_crepe()
    return results


class F0CrepeMetrics(F0GenMetrics):
  """F0GenMetrics with CREPE."""

  def __init__(self, sample_rate=16000, frame_rate=250, name='f0_crepe',
               device: DeviceLike = None):
    super().__init__(sample_rate, frame_rate, name, estimator='crepe',
                     device=device)


# ------------------------------------------------------------------------------
# MIDI transcription metrics (mir_eval.transcription semantics, native)
# ------------------------------------------------------------------------------
@dataclasses.dataclass
class EvalCounts:
  """Aggregated true-positive / false-positive / false-negative counts."""

  tp: int
  fp: int
  fn: int

  def add(self, other: 'EvalCounts'):
    self.tp += other.tp
    self.fp += other.fp
    self.fn += other.fn

  @property
  def precision(self) -> float:
    return self.tp / max(self.tp + self.fp, 1)

  @property
  def recall(self) -> float:
    return self.tp / max(self.tp + self.fn, 1)

  @property
  def f1(self) -> float:
    # Note: the reference clamps the denominator to 1 (metrics.py:374-377),
    # which understates F1 whenever precision + recall < 1; this only
    # guards division by zero.
    return (2 * self.precision * self.recall) / max(
        self.precision + self.recall, 1e-8)


def match_notes(ref_intervals: np.ndarray, ref_pitches_hz: np.ndarray,
                est_intervals: np.ndarray, est_pitches_hz: np.ndarray,
                onset_tolerance: float = 0.05,
                pitch_tolerance: float = 50.0,
                offset_ratio: Optional[float] = 0.2,
                offset_min_tolerance: float = 0.05) -> list:
  """Match reference and estimated notes (mir_eval.transcription semantics).

  A pair matches when onsets are within onset_tolerance seconds, pitches
  within pitch_tolerance cents, and (if offset_ratio is not None) offsets
  within max(offset_min_tolerance, offset_ratio * ref duration). Maximum
  bipartite matching via scipy.

  Returns:
    List of (ref_idx, est_idx) matched pairs.
  """
  from scipy.sparse import csr_matrix  # pylint: disable=g-import-not-at-top
  from scipy.sparse.csgraph import maximum_bipartite_matching  # pylint: disable=g-import-not-at-top

  n_ref, n_est = len(ref_pitches_hz), len(est_pitches_hz)
  if n_ref == 0 or n_est == 0:
    return []

  onset_ok = (np.abs(ref_intervals[:, 0][:, None] -
                     est_intervals[:, 0][None, :]) <= onset_tolerance)
  cents = 1200 * np.abs(np.log2(
      np.maximum(est_pitches_hz[None, :], 1e-8) /
      np.maximum(ref_pitches_hz[:, None], 1e-8)))
  pitch_ok = cents <= pitch_tolerance
  hits = onset_ok & pitch_ok
  if offset_ratio is not None:
    durations = ref_intervals[:, 1] - ref_intervals[:, 0]
    offset_tol = np.maximum(offset_ratio * durations, offset_min_tolerance)
    offset_ok = (np.abs(ref_intervals[:, 1][:, None] -
                        est_intervals[:, 1][None, :]) <=
                 offset_tol[:, None])
    hits = hits & offset_ok

  if not hits.any():
    return []
  graph = csr_matrix(hits)
  match = maximum_bipartite_matching(graph, perm_type='column')
  return [(i, int(match[i])) for i in range(n_ref) if match[i] != -1]


def sequence_to_intervals(sequence):
  """NoteSequence -> (intervals [n, 2], pitches [n], velocities [n])."""
  notes = sequence.notes
  intervals = np.zeros((len(notes), 2))
  pitches = np.zeros(len(notes))
  velocities = np.zeros(len(notes))
  for i, note in enumerate(notes):
    intervals[i] = [note.start_time, note.end_time]
    pitches[i] = note.pitch
    velocities[i] = note.velocity
  return intervals, pitches, velocities


def compute_note_metrics(gt_sequence, pred_sequence):
  """(onset-only, onset+offset) EvalCounts between two NoteSequences."""
  gt_intervals, gt_pitches, _ = sequence_to_intervals(gt_sequence)
  pred_intervals, pred_pitches, _ = sequence_to_intervals(pred_sequence)
  gt_hz = _midi_to_hz(gt_pitches)
  pred_hz = _midi_to_hz(pred_pitches)

  onset_matching = match_notes(gt_intervals, gt_hz, pred_intervals, pred_hz,
                               offset_ratio=None)
  onset_counts = EvalCounts(tp=len(onset_matching),
                            fp=len(pred_pitches) - len(onset_matching),
                            fn=len(gt_pitches) - len(onset_matching))

  offset_matching = match_notes(gt_intervals, gt_hz, pred_intervals,
                                pred_hz)
  full_counts = EvalCounts(tp=len(offset_matching),
                           fp=len(pred_pitches) - len(offset_matching),
                           fn=len(gt_pitches) - len(offset_matching))
  return onset_counts, full_counts


def compute_frame_metrics(gt_pianoroll: np.ndarray,
                          pred_pianoroll: np.ndarray) -> EvalCounts:
  """Framewise note-activity counts (assumes monophonic audio)."""
  gt_arr = np.squeeze(gt_pianoroll).max(axis=1)
  pred_arr = np.squeeze(pred_pianoroll).max(axis=1)
  assert gt_arr.shape == pred_arr.shape
  tp = int(np.logical_and(pred_arr > 0, gt_arr > 0).sum())
  fp = int(np.logical_and(pred_arr > 0, gt_arr == 0).sum())
  fn = int(np.logical_and(pred_arr == 0, gt_arr > 0).sum())
  return EvalCounts(tp, fp, fn)


def pianoroll_to_note_sequence(pianoroll: np.ndarray, frames_per_second):
  """Monophonic-ish pianoroll [time, 128] -> heuristics.NoteSequence."""
  from ddsp_torch.eval.heuristics import Note, NoteSequence  # pylint: disable=g-import-not-at-top
  pianoroll = np.asarray(pianoroll)
  sequence = NoteSequence(total_time=pianoroll.shape[0] / frames_per_second)
  for pitch in range(pianoroll.shape[1]):
    active = pianoroll[:, pitch] > 0
    if not active.any():
      continue
    edges = np.diff(np.concatenate([[0], active.astype(int), [0]]))
    starts = np.where(edges == 1)[0]
    ends = np.where(edges == -1)[0]
    for s, e in zip(starts, ends):
      sequence.notes.append(Note(pitch=pitch,
                                 start_time=s / frames_per_second,
                                 end_time=e / frames_per_second))
  sequence.notes.sort(key=lambda n: n.start_time)
  return sequence


def note_sequence_to_pianoroll(sequence, frames_per_second,
                               n_frames: Optional[int] = None,
                               n_pitches: int = 128) -> np.ndarray:
  """heuristics.NoteSequence -> binary pianoroll [time, n_pitches]."""
  if n_frames is None:
    n_frames = int(np.ceil(sequence.total_time * frames_per_second))
  roll = np.zeros((n_frames, n_pitches), np.float32)
  for note in sequence.notes:
    s = int(round(note.start_time * frames_per_second))
    e = int(round(note.end_time * frames_per_second))
    if 0 <= note.pitch < n_pitches:
      roll[s:e, note.pitch] = 1.0
  return roll


class MidiMetrics:
  """Note on/off and framewise P/R/F1 for MIDI predictions.

  Reference metrics.py:437 (MidiMetrics): accepts NoteSequences or
  pianorolls for predictions, aligns ground-truth note boundaries to the
  extracted f0 track, and reports onset / full-note / frame metrics.
  """

  def __init__(self, frames_per_second, tag: str,
               align_midi_with_f0: bool = True):
    self.tag = tag
    self.note_counts = EvalCounts(0, 0, 0)
    self.note_offset_counts = EvalCounts(0, 0, 0)
    self.frame_counts = EvalCounts(0, 0, 0)
    self._frames_per_second = frames_per_second
    self._align_midi_with_f0 = align_midi_with_f0

  def _to_sequence(self, representation):
    from ddsp_torch.eval.heuristics import NoteSequence  # pylint: disable=g-import-not-at-top
    if isinstance(representation, NoteSequence):
      return representation
    return pianoroll_to_note_sequence(np.asarray(representation),
                                      self._frames_per_second)

  def _to_pianoroll(self, representation, n_frames=None):
    if isinstance(representation, np.ndarray):
      return representation
    if hasattr(representation, 'notes'):
      return note_sequence_to_pianoroll(representation,
                                        self._frames_per_second, n_frames)
    return np.asarray(representation)

  def align_midi_with_f0(self, gt_sequence, f0):
    """Snap ground-truth note boundaries to matching f0 frames."""
    sr = self._frames_per_second
    f0_midi = np.round(_hz_to_midi(np.squeeze(f0)))
    notes = gt_sequence.notes
    for i, note in enumerate(notes):
      lower = int(notes[i - 1].end_time * sr) if i > 0 else 0
      upper = int(note.end_time * sr)
      for j in range(lower, min(upper, len(f0_midi))):
        if int(f0_midi[j]) == note.pitch:
          note.start_time = float(j) / sr
          break
      lower = int(note.start_time * sr)
      upper = (int(notes[i + 1].start_time * sr) if i < len(notes) - 1
               else len(f0_midi) - 1)
      for j in range(min(upper, len(f0_midi) - 1), lower, -1):
        if int(f0_midi[j]) == note.pitch:
          note.end_time = float(j) / sr
          break
    return gt_sequence

  def update_state(self, controls_batch: Dict[str, Any], pred_seq_batch,
                   gt_key: str = 'note_active_velocities', ch=None):
    gt_pianoroll_batch = np.asarray(controls_batch[gt_key])
    for i in range(len(pred_seq_batch)):
      if ch is None:
        pred = pred_seq_batch[i]
        gt_pianoroll = gt_pianoroll_batch[i]
      else:
        pred = pred_seq_batch[i][..., ch]
        gt_pianoroll = gt_pianoroll_batch[i][..., ch]

      gt_sequence = self._to_sequence(gt_pianoroll)
      pred_sequence = self._to_sequence(pred)
      if self._align_midi_with_f0 and 'f0_hz' in controls_batch:
        gt_sequence = self.align_midi_with_f0(
            gt_sequence, np.asarray(controls_batch['f0_hz'])[i])

      onset_counts, full_counts = compute_note_metrics(gt_sequence,
                                                       pred_sequence)
      self.note_counts.add(onset_counts)
      self.note_offset_counts.add(full_counts)

      gt_len = np.asarray(gt_pianoroll).shape[0]
      pred_pianoroll = self._to_pianoroll(pred_sequence, n_frames=gt_len)
      self.frame_counts.add(compute_frame_metrics(
          np.asarray(gt_pianoroll), pred_pianoroll[:gt_len]))

  def flush(self, step: int) -> Dict[str, float]:
    results = {}
    for counts, prefix in [
        (self.note_counts, f'metrics/midi/{self.tag}/onset'),
        (self.note_offset_counts, f'metrics/midi/{self.tag}/full_note'),
        (self.frame_counts, f'metrics/midi/{self.tag}/frame')]:
      results[f'{prefix}/f1'] = counts.f1
      results[f'{prefix}/precision'] = counts.precision
      results[f'{prefix}/recall'] = counts.recall
      logger.info('step %d %s f1=%.3f p=%.3f r=%.3f', step, prefix,
                  counts.f1, counts.precision, counts.recall)
    self.note_counts = EvalCounts(0, 0, 0)
    self.note_offset_counts = EvalCounts(0, 0, 0)
    self.frame_counts = EvalCounts(0, 0, 0)
    return results
