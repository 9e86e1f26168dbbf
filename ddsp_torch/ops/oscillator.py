"""Harmonic oscillator banks with phase accumulation.

Port of ddsp_tpu/ops/oscillator.py: angular_cumsum (and phase_cumsum,
the plain cumsum accumulated in float64), remove_above_nyquist,
normalize_harmonics, get_harmonic_frequencies, oscillator_bank,
harmonic_oscillator_bank, harmonic_synthesis and
streaming_harmonic_synthesis. The factored-phase path of harmonic_synthesis
calls kernel family K1 (ddsp_torch/kernels/harmonic.py, forward and
backward) when its shapes allow it. The streaming synthesis (the VST path)
is plain torch, as the JAX package's is jnp only
(ddsp_tpu/ops/oscillator.py:179-225,360-402).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ddsp_torch.kernels import harmonic as harmonic_kernel
from ddsp_torch.ops.core import pad_axis, safe_divide, torch_float32
from ddsp_torch.ops.resample import resample

_TWO_PI = 2.0 * np.pi


def phase_cumsum(angular_frequency: torch.Tensor) -> torch.Tensor:
  """Unwrapped phase: the cumulative sum over time (dim 1) accumulated in
  float64, each sample rounded once to the input's dtype.

  torch's CPU cumsum of float32 already accumulates in float64 (this is
  the same bits there, values and gradients). A CUDA cumsum over dim 1 of
  [batch, time, 1] runs one thread per row and accumulates in float32: on
  an H100 it took 2.5 ms for a 16 x 64000 training batch and left the
  phase 0.165 rad off after 4 s (~1e4 rad), which moved the harmonic audio
  by half its norm. Summed along the last dimension, the scan is parallel.
  """
  phase = torch.cumsum(angular_frequency.movedim(1, -1), dim=-1,
                       dtype=torch.float64)
  return phase.movedim(-1, 1).to(angular_frequency.dtype)


def angular_cumsum(angular_frequency: torch.Tensor,
                   chunk_size: int = 1000) -> torch.Tensor:
  """Accumulate phase [batch, time, ...] with a chunked, wrapped carry.

  Sums within fixed chunks and threads a mod-2pi carry between chunks, so
  no float32 partial sum grows large. Returns phase wrapped to [0, 2pi).
  Both sums (within chunks, and of the chunks' carries) go through
  phase_cumsum, so they accumulate in float64 on every device: the same
  bits as torch's CPU cumsum, while a CUDA float32 cumsum along a middle
  dimension accumulates in float32: on an H100 that left 4 s of a 440 Hz
  tone 0.103 rad off (80000 samples 0.128), against 7.9e-5 (9.1e-5) with
  these sums, as on the CPU.
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
  phase = phase_cumsum(chunks.flatten(0, 1)).view(chunks.shape)

  # Chunk k starts from the wrapped total of chunks 0..k-1.
  offsets = torch.remainder(phase[:, :, -1:], _TWO_PI)
  offsets = pad_axis(offsets, (1, 0), axis=1)[:, :-1]
  offsets = torch.remainder(phase_cumsum(offsets), _TWO_PI)
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
                    sample_rate: int = 16000, sum_sinusoids: bool = True,
                    use_angular_cumsum: bool = False) -> torch.Tensor:
  """amp * sin(cumsum(2 pi f / sr)) of each sinusoid: summed over them,
  [batch, n], or with sum_sinusoids=False [batch, n, n_sinusoids]."""
  frequency_envelopes = torch_float32(frequency_envelopes)
  amplitude_envelopes = remove_above_nyquist(
      frequency_envelopes, amplitude_envelopes, sample_rate)
  omegas = frequency_envelopes * _TWO_PI / float(sample_rate)
  if use_angular_cumsum:
    phases = angular_cumsum(omegas)
  else:
    phases = phase_cumsum(omegas)
  audio = amplitude_envelopes * torch.sin(phases)
  return torch.sum(audio, dim=-1) if sum_sinusoids else audio


def harmonic_oscillator_bank(
    frequency, amplitude_envelopes,
    initial_phase: Optional[torch.Tensor] = None, sample_rate: int = 16000,
    use_angular_cumsum: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
  """Streaming oscillator bank of the harmonics of one fundamental.

  Accumulates the fundamental's phase once (angular_cumsum, or
  phase_cumsum's float64 sum), adds `initial_phase`, and multiplies by the
  harmonic numbers. No Nyquist mask here: streaming_harmonic_synthesis
  removes those harmonics at frame rate.

  Args:
    frequency: Sample-wise fundamental in Hz, [batch, n_samples, 1].
    amplitude_envelopes: Sample-wise amplitudes, [batch, n_samples,
      n_harmonics].
    initial_phase: Starting phase, [batch, 1, 1] (zeros if None).
    sample_rate: Hz.
    use_angular_cumsum: Chunked, wrapped phase accumulation.

  Returns:
    (audio [batch, n_samples], final_phase [batch, 1, 1]); final_phase is
    the last sample's phase, the next call's initial_phase.
  """
  frequency = torch_float32(frequency)
  amplitude_envelopes = torch_float32(amplitude_envelopes)
  omega = frequency * _TWO_PI / float(sample_rate)
  if use_angular_cumsum:
    phases = angular_cumsum(omega)
  else:
    phases = phase_cumsum(omega)
  if initial_phase is None:
    initial_phase = phases.new_zeros((phases.shape[0], 1, 1))
  phases = phases + initial_phase
  final_phase = phases[:, -1:, 0:1]
  n_harmonics = int(amplitude_envelopes.shape[-1])
  f_ratios = torch.linspace(1.0, float(n_harmonics), n_harmonics,
                            device=phases.device)
  audio = amplitude_envelopes * torch.sin(phases * f_ratios)
  return torch.sum(audio, dim=-1), final_phase


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
      phase0 = phase_cumsum(omega)
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


def streaming_harmonic_synthesis(
    frequencies, amplitudes,
    harmonic_distribution: Optional[torch.Tensor] = None,
    initial_phase: Optional[torch.Tensor] = None, n_samples: int = 64000,
    sample_rate: int = 16000,
    amp_resample_method: str = 'linear') -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
  """Audio from frame-rate controls with an explicit phase carry.

  The harmonic distribution is normalized with the harmonics at or above
  Nyquist removed, the controls are upsampled to n_samples (f0 linearly,
  the amplitudes by amp_resample_method), and harmonic_oscillator_bank
  renders them from `initial_phase` with the angular cumsum.

  Args:
    frequencies: Fundamental in Hz, [batch, n_frames, 1].
    amplitudes: Overall amplitude, [batch, n_frames, 1].
    harmonic_distribution: [batch, n_frames, n_harmonics].
    initial_phase: [batch, 1, 1].
    n_samples: Output length.
    sample_rate: Hz.
    amp_resample_method: How the amplitude envelopes are upsampled.

  Returns:
    (audio [batch, n_samples], final_phase [batch, 1, 1]).
  """
  frequencies = torch_float32(frequencies)
  amplitudes = torch_float32(amplitudes)
  if harmonic_distribution is not None:
    harmonic_distribution = normalize_harmonics(
        torch_float32(harmonic_distribution), frequencies, sample_rate)
    harmonic_amplitudes = amplitudes * harmonic_distribution
  else:
    harmonic_amplitudes = amplitudes
  frequencies = resample(frequencies, n_samples)
  amplitude_envelopes = resample(harmonic_amplitudes, n_samples,
                                 method=amp_resample_method)
  return harmonic_oscillator_bank(frequencies, amplitude_envelopes,
                                  initial_phase, sample_rate=sample_rate)
