"""Wavetable synthesis and variable-length delay lines.

Port of ddsp_tpu/ops/wavetable.py. linear_lookup keeps the JAX package's
dense formulation: relu(1 - distance) weights of every table entry for
every sample, [batch, time, n_wavetable], which is exactly linear
interpolation between the two nearest entries and differentiable with
respect to the phase. Plain torch: none of this reaches a TPU kernel.
"""

from __future__ import annotations

import torch

from ddsp_torch.ops.core import torch_float32
from ddsp_torch.ops.fftconv import frame as frame_signal
from ddsp_torch.ops.oscillator import phase_cumsum
from ddsp_torch.ops.resample import resample


def linear_lookup(phase: torch.Tensor, wavetables: torch.Tensor,
                  wrap: bool = True) -> torch.Tensor:
  """Read wavetables at phase in [0, 1] with linear interpolation.

  Args:
    phase: [batch, n_samples, 1] (or [batch, n_samples]).
    wavetables: [batch, n_samples, n_wavetable] or [batch, n_wavetable].
    wrap: Periodic tables: phase near 1 interpolates back towards entry 0.
      False clamps at the last entry (delay lines).

  Returns:
    [batch, n_samples].
  """
  phase, wavetables = torch_float32(phase), torch_float32(wavetables)
  if wavetables.ndim == 2:
    wavetables = wavetables[:, None, :]
  if phase.ndim == 2:
    phase = phase[:, :, None]
  # One more entry: the first again (wrap) or the last again (clamp).
  edge = wavetables[..., 0:1] if wrap else wavetables[..., -1:]
  wavetables = torch.cat([wavetables, edge], dim=-1)
  n_wavetable = int(wavetables.shape[-1])
  phase_wavetables = torch.linspace(0.0, 1.0, n_wavetable,
                                    device=phase.device)
  phase_distance = torch.abs(phase - phase_wavetables) * (n_wavetable - 1)
  weights = torch.relu(1.0 - phase_distance)
  return torch.sum(weights * wavetables, dim=-1)


def harmonic_distribution_to_wavetable(harmonic_distribution: torch.Tensor,
                                       n_wavetable: int = 2048
                                       ) -> torch.Tensor:
  """A wavetable [batch, time, n_wavetable] from a (normalized) harmonic
  distribution [batch, time, n_harmonics] by an inverse real FFT."""
  harmonic_distribution = torch_float32(harmonic_distribution)
  n_harmonics = harmonic_distribution.shape[-1]
  n_pad = int(n_wavetable / 2 - n_harmonics)
  # Left: the DC component; right: up to the table's Nyquist.
  fft_in = torch.nn.functional.pad(harmonic_distribution, (1, n_pad))
  wavetable = torch.fft.irfft(fft_in.to(torch.complex64)) * (n_wavetable / 2)
  return wavetable.float()


def wavetable_synthesis(frequencies: torch.Tensor, amplitudes: torch.Tensor,
                        wavetables: torch.Tensor, n_samples: int = 64000,
                        sample_rate: int = 16000) -> torch.Tensor:
  """Monophonic wavetable synthesizer.

  Args:
    frequencies: Frame-rate fundamental in Hz, [batch, n_frames, 1].
    amplitudes: Frame-rate amplitude, [batch, n_frames, 1].
    wavetables: [batch, n_wavetable] or [batch, n_frames, n_wavetable].
    n_samples: Output length.
    sample_rate: Hz.

  Returns:
    [batch, n_samples]. The phase (in cycles) is the exclusive cumulative
    sum of f / sample_rate, accumulated in float64 (phase_cumsum), modulo 1.
  """
  wavetables = torch_float32(wavetables)
  amplitude_envelope = resample(amplitudes, n_samples,
                                method='window')[:, :, 0]
  frequency_envelope = resample(frequencies, n_samples)
  if wavetables.ndim == 3 and wavetables.shape[1] > 1:
    wavetables = resample(wavetables, n_samples)
  phase_velocity = frequency_envelope / float(sample_rate)
  phase_velocity = torch.cat([torch.zeros_like(phase_velocity[:, :1]),
                              phase_velocity[:, :-1]], dim=1)
  phase = torch.remainder(phase_cumsum(phase_velocity), 1.0)
  return linear_lookup(phase, wavetables) * amplitude_envelope


def variable_length_delay(phase: torch.Tensor, audio: torch.Tensor,
                          max_length: int = 512) -> torch.Tensor:
  """Delay audio [batch, n_samples] by phase [batch, n_samples, 1] in
  [0, 1] times max_length samples, interpolating linearly; a saturated
  phase clamps at the longest delay (wrap=False)."""
  phase, audio = torch_float32(phase), torch_float32(audio)
  audio = torch.nn.functional.pad(audio, (max_length - 1, 0))
  # One frame of the past max_length samples per output sample, reversed
  # so that phase 0 is no delay.
  frames = frame_signal(audio, max_length, 1, pad_end=False)
  return linear_lookup(phase, torch.flip(frames, dims=[-1]), wrap=False)
