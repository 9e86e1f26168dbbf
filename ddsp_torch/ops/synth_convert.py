"""Conversions between sinusoidal and harmonic synthesizer controls.

Port of ddsp_tpu/ops/synth_convert.py. Reference behavior:
magenta/ddsp's ddsp/core.py:733-794 (`sinusoidal_to_harmonic`,
`harmonic_to_sinusoidal`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ddsp_torch.ops.core import safe_divide, torch_float32
from ddsp_torch.ops.oscillator import (get_harmonic_frequencies,
                                       remove_above_nyquist)


def sinusoidal_to_harmonic(sin_amps, sin_freqs, f0_hz,
                           harmonic_width: float = 0.1,
                           n_harmonics: int = 100,
                           sample_rate: int = 16000,
                           normalize: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Extract harmonic components from sinusoids given a fundamental.

  Each harmonic's amplitude is a gaussian-weighted sum of sinusoid
  amplitudes, weighted by relative frequency difference.

  Args:
    sin_amps: Sinusoidal amplitudes (linear), [batch, time, n_sinusoids].
    sin_freqs: Sinusoidal frequencies in Hz, [batch, time, n_sinusoids].
    f0_hz: Fundamental frequency in Hz, [batch, time, 1].
    harmonic_width: Std dev of gaussian weighting on relative frequency
      difference between a harmonic and a sinusoid.
    n_harmonics: Number of output harmonics.
    sample_rate: Hertz.
    normalize: Per timestep, cap each harmonic's total sinusoid weight at 1.

  Returns:
    harm_amp: Harmonic amplitude (linear), [batch, time, 1].
    harm_dist: Harmonic distribution, [batch, time, n_harmonics].
  """
  sin_amps = torch_float32(sin_amps)
  sin_freqs = torch_float32(sin_freqs)
  f0_hz = torch_float32(f0_hz)
  # [b, t, n_harm]
  harm_freqs = get_harmonic_frequencies(f0_hz, n_harmonics)

  # [b, t, n_harm, n_sin]
  freqs_diff = sin_freqs[:, :, None, :] - harm_freqs[..., None]
  freqs_ratio = torch.abs(safe_divide(freqs_diff, f0_hz[..., None]))
  weights = torch.exp(-(freqs_ratio / harmonic_width)**2.0)

  if normalize:
    weights_sum = torch.sum(weights, dim=-1, keepdim=True)
    weights_norm = safe_divide(weights, weights_sum)
    weights = torch.where(weights_sum > 1.0, weights_norm, weights)

  # [b, t, n_harm, n_sin] -> [b, t, n_harm]
  harm_amps = torch.sum(weights * sin_amps[:, :, None, :], dim=-1)

  # Filter harmonics above nyquist.
  harm_amps = remove_above_nyquist(harm_freqs, harm_amps, sample_rate)

  # Get harmonic distribution.
  harm_amp = torch.sum(harm_amps, dim=-1, keepdim=True)
  harm_dist = safe_divide(harm_amps, harm_amp)

  return harm_amp, harm_dist


def harmonic_to_sinusoidal(harm_amp, harm_dist, f0_hz,
                           sample_rate: int = 16000
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Converts controls for a harmonic synth to those for a sinusoidal synth."""
  harm_amp = torch_float32(harm_amp)
  harm_dist = torch_float32(harm_dist)
  n_harmonics = int(harm_dist.shape[-1])
  freqs = get_harmonic_frequencies(f0_hz, n_harmonics)
  # Remove anything above nyquist and renormalize.
  harm_dist = remove_above_nyquist(freqs, harm_dist, sample_rate)
  harm_dist_sum = torch.sum(harm_dist, dim=-1, keepdim=True)
  harm_dist = safe_divide(harm_dist, harm_dist_sum)
  amps = harm_amp * harm_dist
  return amps, freqs
