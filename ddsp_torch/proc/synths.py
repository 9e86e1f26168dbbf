"""Synthesizer processors: Harmonic and FilteredNoise.

Port of the serving path's synths in ddsp_tpu/proc/synths.py.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import oscillator as osc
from ddsp_torch.ops.fftconv import frequency_filter
from ddsp_torch.proc.processors import Processor, TensorDict


class Harmonic(Processor):
  """Bank of harmonic sinusoidal oscillators.

  Attributes mirror the JAX processor: n_samples, sample_rate, scale_fn
  (applied to amplitudes and harmonic distribution), normalize_below_nyquist,
  amp_resample_method, use_angular_cumsum.
  """

  def __init__(self, n_samples: int = 64000, sample_rate: int = 16000,
               scale_fn: Optional[Callable] = ops_core.exp_sigmoid,
               normalize_below_nyquist: bool = True,
               amp_resample_method: str = 'window',
               use_angular_cumsum: bool = False,
               name: Optional[str] = None):
    super().__init__(name)
    self.n_samples = n_samples
    self.sample_rate = sample_rate
    self.scale_fn = scale_fn
    self.normalize_below_nyquist = normalize_below_nyquist
    self.amp_resample_method = amp_resample_method
    self.use_angular_cumsum = use_angular_cumsum

  def get_controls(self, amplitudes, harmonic_distribution,
                   f0_hz) -> TensorDict:
    """amplitudes [b, t, 1], harmonic_distribution [b, t, n], f0_hz [b, t, 1]."""
    if self.scale_fn is not None:
      amplitudes = self.scale_fn(amplitudes)
      harmonic_distribution = self.scale_fn(harmonic_distribution)
    harmonic_distribution = osc.normalize_harmonics(
        harmonic_distribution, f0_hz,
        self.sample_rate if self.normalize_below_nyquist else None)
    return {'amplitudes': amplitudes,
            'harmonic_distribution': harmonic_distribution,
            'f0_hz': f0_hz}

  def get_signal(self, amplitudes, harmonic_distribution,
                 f0_hz) -> torch.Tensor:
    """Audio [batch, n_samples]."""
    return osc.harmonic_synthesis(
        frequencies=f0_hz, amplitudes=amplitudes,
        harmonic_distribution=harmonic_distribution,
        n_samples=self.n_samples, sample_rate=self.sample_rate,
        amp_resample_method=self.amp_resample_method,
        use_angular_cumsum=self.use_angular_cumsum)


class FilteredNoise(Processor):
  """White noise through a time-varying FIR designed from magnitudes.

  The noise is uniform in [-1, 1), [batch, n_samples]: an explicit `noise`
  tensor if the caller passes one (tests hand over the JAX package's draw),
  else drawn from the caller's `generator`, else from a generator seeded
  with 0 (deterministic, as the JAX processor's fixed-key fallback).
  """

  def __init__(self, n_samples: int = 64000, window_size: int = 257,
               scale_fn: Optional[Callable] = ops_core.exp_sigmoid,
               initial_bias: float = -5.0, name: Optional[str] = None):
    super().__init__(name)
    self.n_samples = n_samples
    self.window_size = window_size
    self.scale_fn = scale_fn
    self.initial_bias = initial_bias

  def get_controls(self, magnitudes) -> TensorDict:
    """magnitudes: [batch, time, n_filter_banks] network outputs."""
    if self.scale_fn is not None:
      magnitudes = self.scale_fn(magnitudes + self.initial_bias)
    return {'magnitudes': magnitudes}

  def render(self, controls: TensorDict, noise=None, generator=None):
    return self.get_signal(**controls, noise=noise, generator=generator)

  def draw_noise(self, batch_size: int, device,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """The white noise [batch, n_samples] on `device` (the rule above)."""
    shape = (batch_size, self.n_samples)
    if noise is None:
      if generator is None:
        generator = torch.Generator(device).manual_seed(0)
      return torch.rand(shape, generator=generator, device=device) * 2.0 - 1.0
    if tuple(noise.shape) != shape:
      raise ValueError(f'noise has shape {tuple(noise.shape)}, expected '
                       f'{shape}.')
    return noise.to(device)

  def get_signal(self, magnitudes, noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """Filtered noise [batch, n_samples]."""
    noise = self.draw_noise(int(magnitudes.shape[0]), magnitudes.device,
                            noise, generator)
    return frequency_filter(noise, magnitudes, window_size=self.window_size)
