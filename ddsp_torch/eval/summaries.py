"""Audio and image summaries for evaluation samples.

Port of ddsp_tpu/eval/summaries.py: write_wav, sample_batch,
spectrogram_summary, waveform_summary, f0_summary, and the MIDI plots
(pianoroll_summary, midi_summary, midiae_f0/ld/sp_summary). Artifacts are wav and png files under
<save_dir>/samples/step_<N>/. matplotlib is optional: without it the
figures are skipped and the wavs are still written.
"""

from __future__ import annotations

import logging
import os
import wave
from typing import Optional

import numpy as np

from ddsp_torch.ops import spectral
from ddsp_torch.ops.core import hz_to_midi

logger = logging.getLogger('ddsp_torch')


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000):
  """Write mono float audio in [-1, 1] to a 16-bit wav file."""
  audio = np.asarray(audio).squeeze()
  peak = np.max(np.abs(audio)) or 1.0
  if peak > 1.0:
    audio = audio / peak
  pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with wave.open(path, 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sample_rate)
    w.writeframes(pcm.tobytes())


def _spectrogram_db(audio: np.ndarray, size: int = 1024) -> np.ndarray:
  """A figure's log spectrogram, [bins, frames] in dB (on the host: the
  figure is drawn there)."""
  mag = spectral.compute_mag(
      np.asarray(audio, np.float32)[np.newaxis, :], size=size)[0].numpy()
  return 20.0 * np.log10(np.maximum(mag, 1e-6)).T


def spectrogram_summary(path: str, audio: np.ndarray,
                        audio_gen: Optional[np.ndarray] = None,
                        sample_rate: int = 16000):
  """Save side-by-side log spectrograms of original and generated audio."""
  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
  except ImportError:
    return
  n = 2 if audio_gen is not None else 1
  fig, axes = plt.subplots(1, n, figsize=(6 * n, 4), squeeze=False)
  axes[0][0].imshow(_spectrogram_db(np.asarray(audio).squeeze()),
                    aspect='auto', origin='lower', cmap='magma')
  axes[0][0].set_title('original')
  if audio_gen is not None:
    axes[0][1].imshow(_spectrogram_db(np.asarray(audio_gen).squeeze()),
                      aspect='auto', origin='lower', cmap='magma')
    axes[0][1].set_title('synthesized')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  fig.savefig(path, dpi=80, bbox_inches='tight')
  plt.close(fig)


def waveform_summary(path: str, audio: np.ndarray,
                     audio_gen: Optional[np.ndarray] = None):
  """Save overlaid waveforms of original and generated audio."""
  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
  except ImportError:
    return
  fig, ax = plt.subplots(figsize=(10, 3))
  ax.plot(np.asarray(audio).squeeze(), lw=0.5, label='original')
  if audio_gen is not None:
    ax.plot(np.asarray(audio_gen).squeeze(), lw=0.5, alpha=0.7,
            label='synthesized')
  ax.legend()
  os.makedirs(os.path.dirname(path), exist_ok=True)
  fig.savefig(path, dpi=80, bbox_inches='tight')
  plt.close(fig)


def sample_batch(save_dir: str, step: int, batch, audio_gen,
                 sample_rate: int = 16000, max_outputs: int = 4,
                 name: str = 'synth', offset: int = 0):
  """Write wav + figure artifacts for up to max_outputs examples under
  <save_dir>/samples/step_<step>/. The wavs are always written; the figures
  only where matplotlib imports.

  `offset` numbers examples globally across batches so successive batches
  of the same step don't overwrite each other's files.
  """
  out_dir = os.path.join(save_dir, 'samples', f'step_{step}')
  audio = np.asarray(batch['audio'])
  audio_gen = np.asarray(audio_gen)
  for i in range(min(len(audio), max_outputs)):
    j = offset + i
    write_wav(os.path.join(out_dir, f'{j}_original.wav'), audio[i],
              sample_rate)
    write_wav(os.path.join(out_dir, f'{j}_{name}.wav'), audio_gen[i],
              sample_rate)
    spectrogram_summary(os.path.join(out_dir, f'{j}_{name}_spectrogram.png'),
                        audio[i], audio_gen[i], sample_rate)
    waveform_summary(os.path.join(out_dir, f'{j}_{name}_waveform.png'),
                     audio[i], audio_gen[i])
  logger.info('Wrote samples to %s', out_dir)
  return out_dir


def f0_summary(path: str, f0_hz: np.ndarray, f0_hz_predict: np.ndarray):
  """Plot ground-truth vs predicted f0 in MIDI space."""
  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
  except ImportError:
    return
  f0 = hz_to_midi(np.squeeze(np.asarray(f0_hz))).numpy()
  f0_pred = hz_to_midi(np.squeeze(np.asarray(f0_hz_predict))).numpy()
  fig, ax = plt.subplots(figsize=(6.0, 2.5))
  ax.plot(f0, label='original')
  ax.plot(f0_pred, label='predicted')
  ax.set_ylabel('f0 (MIDI)')
  ax.legend()
  os.makedirs(os.path.dirname(path), exist_ok=True)
  fig.savefig(path, dpi=80, bbox_inches='tight')
  plt.close(fig)


def pianoroll_summary(path: str, pianoroll: np.ndarray,
                      frame_rate: int = 250):
  """Plot a [time, 128] pianoroll."""
  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
  except ImportError:
    return
  roll = np.asarray(pianoroll)
  fig, ax = plt.subplots(figsize=(6.0, 3.0))
  ax.imshow(roll.T, aspect='auto', origin='lower',
            extent=(0, roll.shape[0] / frame_rate, 0, roll.shape[1]))
  ax.set_xlabel('time (s)')
  ax.set_ylabel('MIDI pitch')
  os.makedirs(os.path.dirname(path), exist_ok=True)
  fig.savefig(path, dpi=80, bbox_inches='tight')
  plt.close(fig)


def midi_summary(path: str, note_sequence, frame_rate: int = 250):
  """Plot segmented notes as a pianoroll."""
  from ddsp_torch.eval.metrics import note_sequence_to_pianoroll  # pylint: disable=g-import-not-at-top
  roll = note_sequence_to_pianoroll(note_sequence, frame_rate)
  pianoroll_summary(path, roll, frame_rate)


def _get_plt():
  try:
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt
  except ImportError:
    return None


def _save(fig, path):
  os.makedirs(os.path.dirname(path), exist_ok=True)
  fig.savefig(path, dpi=80, bbox_inches='tight')


def midiae_f0_summary(out_dir: str, f0_hz: np.ndarray, outputs,
                      max_outputs: int = 4, offset: int = 0):
  """Plot MidiAE pitch traces: input f0, quantized MIDI, reconstruction.

  One figure per example overlaying the input f0 (MIDI), the q_pitch
  steps, the decoded f0_midi_pred and (if the encoder ran) z_pitch.
  """
  plt = _get_plt()
  if plt is None:
    return
  f0_midi = hz_to_midi(np.asarray(f0_hz)).numpy()
  for i in range(min(int(f0_midi.shape[0]), max_outputs)):
    fig, ax = plt.subplots(figsize=(6.0, 4.0))
    ax.plot(np.squeeze(f0_midi[i]), linewidth=1.5, label='input f0')
    ax.step(np.squeeze(np.asarray(outputs['q_pitch'][i])), 'r',
            linewidth=0.75, label='q_pitch')
    ax.plot(np.squeeze(np.asarray(outputs['f0_midi_pred'][i])), 'g',
            linewidth=1.25, label='rec f0')
    z_pitch = outputs.get('z_pitch')
    if z_pitch is not None:
      ax.plot(np.squeeze(np.asarray(z_pitch[i])), 'c',
              linewidth=0.75, alpha=0.7, label='z_pitch')
    ax.set_ylabel('pitch (MIDI)')
    ax.legend()
    _save(fig, os.path.join(out_dir, f'{offset + i}_midiae_f0.png'))
    plt.close(fig)


def midiae_ld_summary(out_dir: str, ld_feat: np.ndarray, outputs,
                      db_key: str = 'loudness_db', max_outputs: int = 4,
                      offset: int = 0):
  """Plot MidiAE loudness traces: input db, reconstruction, velocity steps.
  """
  plt = _get_plt()
  if plt is None:
    return
  ld_feat = np.asarray(ld_feat)
  for i in range(min(int(ld_feat.shape[0]), max_outputs)):
    fig, ax = plt.subplots(figsize=(6.0, 4.0))
    ax.plot(np.squeeze(ld_feat[i]), linewidth=1.5, label=f'input {db_key}')
    rec = outputs.get(f'{db_key}_pred')
    if rec is not None:
      ax.plot(np.squeeze(np.asarray(rec[i])), 'g', linewidth=1.25,
              label='rec')
    q_vel = outputs.get('q_vel')
    if q_vel is not None:
      ax.step(np.squeeze(np.asarray(q_vel[i])), 'r', linewidth=0.75,
              label='q_vel')
    ax.set_ylabel(db_key)
    ax.legend()
    _save(fig, os.path.join(out_dir, f'{offset + i}_midiae_ld.png'))
    plt.close(fig)


def midiae_sp_summary(out_dir: str, outputs, max_outputs: int = 4,
                      offset: int = 0):
  """Plot MidiAE synth-control reconstructions (amps / hd / noise).

  For each of amplitudes, harmonic distribution, and noise magnitudes, show the
  synthcoder controls, the MIDI-decoded prediction, and their difference.
  """
  plt = _get_plt()
  if plt is None:
    return
  batch_size = int(np.asarray(outputs['amps']).shape[0])
  for i in range(min(batch_size, max_outputs)):
    for key, log_scale in (('amps', False), ('hd', True), ('noise', True)):
      value = np.squeeze(np.asarray(outputs[key][i]))
      if log_scale:
        value = np.log(value + 1e-8)
      pred = outputs.get(f'{key}_pred')
      rows = 3 if pred is not None else 1
      fig, axes = plt.subplots(nrows=rows, ncols=1, squeeze=False,
                               figsize=(8, 4 * rows))
      panels = [(value, f'{key} - synth_params')]
      if pred is not None:
        pred = np.squeeze(np.asarray(pred[i]))
        if log_scale:
          pred = np.log(pred + 1e-8)
        panels += [(pred, f'{key} - pred'), (value - pred, f'{key} - diff')]
      for ax, (data, title) in zip(axes[:, 0], panels):
        if data.ndim == 1:
          ax.plot(data)
        else:
          im = ax.imshow(data.T, aspect='auto', origin='lower')
          fig.colorbar(im, ax=ax)
        ax.set_title(title)
      _save(fig, os.path.join(out_dir, f'{offset + i}_midiae_{key}.png'))
      plt.close(fig)
