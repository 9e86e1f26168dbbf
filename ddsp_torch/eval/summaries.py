"""Audio and image summaries for evaluation samples.

Port of ddsp_tpu/eval/summaries.py but for its MIDI plots (which wait for
the MIDI models): write_wav, sample_batch, spectrogram_summary,
waveform_summary and f0_summary. Artifacts are wav and png files under
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
