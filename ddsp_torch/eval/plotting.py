"""Plotting helpers for analysis and notebooks.

Port of ddsp_tpu/eval/plotting.py: specplot, transfer_function,
plot_impulse_responses and pianoroll_plot_setup. matplotlib is imported
when a function draws, so nothing else of the package needs it; where it
is not installed a drawing call raises its ImportError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ddsp_torch.ops import spectral
from ddsp_torch.utils.device import DeviceLike, resolve_device


def _plt():
  import matplotlib  # pylint: disable=g-import-not-at-top
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt  # pylint: disable=g-import-not-at-top
  return plt


def specplot(audio: np.ndarray,
             vmin: float = -5,
             vmax: float = 1,
             rotate: bool = True,
             size: int = 512 + 256,
             ax=None,
             sample_rate: int = 16000,
             device: DeviceLike = None):
  """Plot the log magnitude spectrogram of audio; returns the axes.

  The magnitudes come from ops.spectral.compute_mag on `device` (CUDA
  unless the caller says otherwise).
  """
  del sample_rate
  plt = _plt()
  audio = np.asarray(audio, np.float32)
  if audio.ndim == 1:
    audio = audio[np.newaxis, :]
  mag = spectral.compute_mag(
      torch.from_numpy(audio).to(resolve_device(device)), size=size)
  mag = mag[0].cpu().numpy()
  logmag = np.log10(np.maximum(mag, 1e-6))
  if rotate:
    logmag = np.rot90(logmag)
  if ax is None:
    _, ax = plt.subplots(figsize=(6, 4))
  ax.matshow(logmag, vmin=vmin, vmax=vmax, cmap=plt.cm.magma,
             aspect='auto')
  ax.set_xticks([])
  ax.set_yticks([])
  ax.set_xlabel('Time')
  ax.set_ylabel('Frequency')
  return ax


def transfer_function(ir: np.ndarray,
                      sample_rate: int = 16000
                      ) -> Tuple[np.ndarray, np.ndarray]:
  """The frequency response (frequencies, magnitudes) of an IR."""
  ir = np.asarray(ir)
  n_fft = int(2**np.ceil(np.log2(ir.shape[-1])))
  transfer = np.fft.rfft(ir, n_fft, axis=-1)
  frequencies = np.abs(np.fft.fftfreq(n_fft, 1 / sample_rate)
                       [:n_fft // 2 + 1])
  magnitudes = np.abs(transfer)
  return frequencies, magnitudes


def plot_impulse_responses(impulse_response: np.ndarray,
                           desired_magnitudes: Optional[np.ndarray] = None,
                           sample_rate: int = 16000):
  """Plot an impulse response and its transfer function; returns the
  figure."""
  plt = _plt()
  frequencies, magnitudes = transfer_function(impulse_response, sample_rate)

  fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 3))
  if desired_magnitudes is not None:
    plot_freqs = np.linspace(0, sample_rate / 2.0,
                             np.asarray(desired_magnitudes).shape[-1])
    ax0.semilogy(plot_freqs, np.squeeze(desired_magnitudes),
                 label='Desired')
  ax0.semilogy(frequencies, np.squeeze(magnitudes), label='Synthesized')
  ax0.set_title('Transfer Function')
  ax0.set_xlabel('Frequency (Hz)')
  ax0.set_ylabel('Magnitude')
  ax0.legend()

  ax1.plot(np.squeeze(impulse_response))
  ax1.set_title('Impulse Response')
  ax1.set_xlabel('Sample')
  return fig


def pianoroll_plot_setup(figsize=None, side_piano_ratio: float = 1 / 20,
                         faint_pr: bool = True, xlim=None):
  """A pianoroll plot with a mini piano on the left axis.

  Returns:
    (fig, ax, sp_ax): figure, main pianoroll axis, side-piano axis.
  """
  plt = _plt()
  octaves = 10

  fig = plt.figure(figsize=figsize)
  gs = fig.add_gridspec(1, 2, width_ratios=(side_piano_ratio, 1),
                        wspace=0.0)
  sp_ax = fig.add_subplot(gs[0])
  ax = fig.add_subplot(gs[1], sharey=sp_ax)

  # The mini piano: white and black keys of each octave.
  white = np.zeros(12, dtype=bool)
  white[[0, 2, 4, 5, 7, 9, 11]] = True
  for pitch in range(octaves * 12):
    color = 'white' if white[pitch % 12] else 'black'
    sp_ax.axhspan(pitch - 0.5, pitch + 0.5, facecolor=color,
                  edgecolor='gray', linewidth=0.2)
  sp_ax.set_xlim(0, 1)
  sp_ax.set_xticks([])
  sp_ax.set_ylabel('MIDI pitch')

  if faint_pr:
    for pitch in range(octaves * 12):
      if not white[pitch % 12]:
        ax.axhspan(pitch - 0.5, pitch + 0.5, facecolor='gray', alpha=0.07)
  if xlim is not None:
    ax.set_xlim(*xlim)
  ax.set_xlabel('Time')
  plt.setp(ax.get_yticklabels(), visible=False)
  return fig, ax, sp_ax
