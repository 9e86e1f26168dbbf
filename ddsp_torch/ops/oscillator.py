"""Harmonic oscillator banks with phase accumulation.

Port of ddsp_tpu/ops/oscillator.py: angular_cumsum, remove_above_nyquist,
normalize_harmonics, get_harmonic_frequencies, oscillator_bank and
harmonic_synthesis. The factored-phase path of harmonic_synthesis calls
kernel family K1 (ddsp_torch/kernels/harmonic.py, forward and backward)
when its shapes allow it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddsp_torch.kernels import harmonic as harmonic_kernel
from ddsp_torch.ops.core import pad_axis, safe_divide, torch_float32
from ddsp_torch.ops.resample import resample

_TWO_PI = 2.0 * np.pi


def angular_cumsum(angular_frequency: torch.Tensor,
                   chunk_size: int = 1000) -> torch.Tensor:
  """Accumulate phase [batch, time, ...] with a chunked, wrapped carry.

  Sums within fixed chunks and threads a mod-2pi carry between chunks, so
  no float32 partial sum grows large. Returns phase wrapped to [0, 2pi).
  """
  n_batch, n_time = angular_frequency.shape[:2]
  trailing = tuple(angular_frequency.shape[2:])
  remainder = n_time % chunk_size
  if remainder:
    angular_frequency = pad_axis(angular_frequency,
                                 (0, chunk_size - remainder), axis=1)
  length = angular_frequency.shape[1]
  n_chunks = length // chunk_size
  chunks = angular_frequency.reshape((n_batch, n_chunks, chunk_size) +
                                     trailing)
  phase = torch.cumsum(chunks, dim=2)

  # Chunk k starts from the wrapped total of chunks 0..k-1.
  offsets = torch.remainder(phase[:, :, -1:], _TWO_PI)
  offsets = pad_axis(offsets, (1, 0), axis=1)[:, :-1]
  offsets = torch.remainder(torch.cumsum(offsets, dim=1), _TWO_PI)
  phase = torch.remainder(phase + offsets, _TWO_PI)
  phase = phase.reshape((n_batch, length) + trailing)
  return phase[:, :n_time] if remainder else phase


def remove_above_nyquist(frequency_envelopes, amplitude_envelopes,
                         sample_rate: int = 16000) -> torch.Tensor:
  """Zero the amplitude of every oscillator at or above Nyquist."""
  frequency_envelopes = torch_float32(frequency_envelopes)
  amplitude_envelopes = torch_float32(amplitude_envelopes)
  return torch.where(frequency_envelopes >= sample_rate / 2.0,
                     torch.zeros_like(amplitude_envelopes),
                     amplitude_envelopes)


def get_harmonic_frequencies(frequencies, n_harmonics: int) -> torch.Tensor:
  """[batch, time, 1] f0 -> [batch, time, n_harmonics] (f, 2f, .., nf)."""
  frequencies = torch_float32(frequencies)
  f_ratios = torch.linspace(1.0, float(n_harmonics), n_harmonics,
                            device=frequencies.device)
  return frequencies * f_ratios


def normalize_harmonics(harmonic_distribution: torch.Tensor,
                        f0_hz: Optional[torch.Tensor] = None,
                        sample_rate: Optional[int] = None) -> torch.Tensor:
  """Normalize to sum 1, optionally muting harmonics above Nyquist first."""
  if sample_rate is not None and f0_hz is not None:
    n_harmonics = int(harmonic_distribution.shape[-1])
    harmonic_frequencies = get_harmonic_frequencies(f0_hz, n_harmonics)
    harmonic_distribution = remove_above_nyquist(
        harmonic_frequencies, harmonic_distribution, sample_rate)
  return safe_divide(harmonic_distribution,
                     torch.sum(harmonic_distribution, dim=-1, keepdim=True))


def oscillator_bank(frequency_envelopes, amplitude_envelopes,
                    sample_rate: int = 16000,
                    use_angular_cumsum: bool = False) -> torch.Tensor:
  """Sum over sinusoids of amp * sin(cumsum(2 pi f / sr)), [batch, n]."""
  frequency_envelopes = torch_float32(frequency_envelopes)
  amplitude_envelopes = remove_above_nyquist(
      frequency_envelopes, amplitude_envelopes, sample_rate)
  omegas = frequency_envelopes * _TWO_PI / float(sample_rate)
  if use_angular_cumsum:
    phases = angular_cumsum(omegas)
  else:
    phases = torch.cumsum(omegas, dim=1)
  audio = amplitude_envelopes * torch.sin(phases)
  return torch.sum(audio, dim=-1)


def harmonic_synthesis(frequencies, amplitudes,
                       harmonic_shifts: Optional[torch.Tensor] = None,
                       harmonic_distribution: Optional[torch.Tensor] = None,
                       n_samples: int = 64000, sample_rate: int = 16000,
                       amp_resample_method: str = 'window',
                       use_angular_cumsum: bool = False,
                       factored_phase: bool = True) -> torch.Tensor:
  """Render [batch, n_samples] audio from frame-rate harmonic controls.

  Args:
    frequencies: Frame-rate fundamental in Hz, [batch, n_frames, 1].
    amplitudes: Frame-rate overall amplitude, [batch, n_frames, 1].
    harmonic_shifts: Optional per-harmonic detuning (harmonic h sounds at
      f0 * h * (1 + shift_h)), [batch, n_frames, n_harmonics].
    harmonic_distribution: Optional per-harmonic weights,
      [batch, n_frames, n_harmonics].
    n_samples: Output length.
    sample_rate: Hz.
    amp_resample_method: 'window', 'linear', 'cubic' or 'nearest'.
    use_angular_cumsum: Chunked phase accumulation (long renders).
    factored_phase: Without harmonic_shifts, accumulate only the
      fundamental phase and multiply by the harmonic numbers. With
      'window'/'linear' resampling and n_samples % n_frames == 0 this runs
      kernel K1 on a CUDA tensor.
  """
  frequencies = torch_float32(frequencies)
  amplitudes = torch_float32(amplitudes)
  if harmonic_distribution is not None:
    harmonic_distribution = torch_float32(harmonic_distribution)
    n_harmonics = int(harmonic_distribution.shape[-1])
  elif harmonic_shifts is not None:
    harmonic_shifts = torch_float32(harmonic_shifts)
    n_harmonics = int(harmonic_shifts.shape[-1])
  else:
    n_harmonics = 1

  if harmonic_distribution is not None:
    harmonic_amplitudes = amplitudes * harmonic_distribution
  else:
    harmonic_amplitudes = amplitudes

  if harmonic_shifts is None and factored_phase:
    f0_envelope = resample(frequencies, n_samples)  # [batch, n_samples, 1]
    omega = f0_envelope * _TWO_PI / float(sample_rate)
    if use_angular_cumsum:
      phase0 = angular_cumsum(omega)
    else:
      phase0 = torch.cumsum(omega, dim=1)
    n_frames = int(harmonic_amplitudes.shape[1])
    args = (phase0[..., 0], f0_envelope[..., 0], harmonic_amplitudes,
            sample_rate, amp_resample_method)
    if (amp_resample_method in harmonic_kernel.KERNEL_METHODS and
        n_samples % n_frames == 0):
      return harmonic_kernel.fused_harmonic_synthesis(*args)
    return harmonic_kernel.harmonic_synthesis_plain(*args)

  # General (reference-shaped) path: per-sinusoid phase accumulation.
  amplitude_envelopes = resample(harmonic_amplitudes, n_samples,
                                 method=amp_resample_method)
  harmonic_frequencies = get_harmonic_frequencies(frequencies, n_harmonics)
  if harmonic_shifts is not None:
    harmonic_frequencies = harmonic_frequencies * (1.0 + harmonic_shifts)
  frequency_envelopes = resample(harmonic_frequencies, n_samples)
  return oscillator_bank(frequency_envelopes, amplitude_envelopes,
                         sample_rate=sample_rate,
                         use_angular_cumsum=use_angular_cumsum)
