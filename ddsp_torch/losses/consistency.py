"""Consistency losses on synthesizer controls and sinusoid traces.

Port of ddsp_tpu/losses/consistency.py (normal_log_prob, mixture_log_prob,
amp_loss, freq_loss, FilteredNoiseConsistencyLoss, HarmonicConsistencyLoss,
wasserstein_distance, WassersteinConsistencyLoss, KDEConsistencyLoss).
Gaussian mixtures are written out (a logsumexp over the components), as
there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ddsp_torch.losses.spectral import Loss, mean_difference
from ddsp_torch.ops.core import hz_to_midi, log10, safe_divide

_LOG_2PI = 1.8378770664093453


def normal_log_prob(x: torch.Tensor, loc: torch.Tensor,
                    scale) -> torch.Tensor:
  """Log-density of a univariate normal, broadcasting over inputs."""
  z = (x - loc) / scale
  log_scale = (torch.log(scale) if isinstance(scale, torch.Tensor) else
               math.log(scale))
  return -0.5 * (z * z + _LOG_2PI) - log_scale


def mixture_log_prob(x: torch.Tensor, probs: torch.Tensor,
                     locs: torch.Tensor, scale) -> torch.Tensor:
  """Log-density of a mixture of normals along the last component axis.

  Args:
    x: Evaluation points, shape [..., n_points].
    probs: Mixture weights (sum to 1 along last axis), shape [..., n_comp].
    locs: Component means, shape [..., n_comp].
    scale: Component stddev, scalar or broadcastable to locs.

  Returns:
    log p(x), shape [..., n_points].
  """
  # [..., n_points, n_comp]
  component_ll = normal_log_prob(x[..., :, None], locs[..., None, :], scale)
  log_w = torch.log(torch.clamp(probs, min=1e-37))[..., None, :]
  return torch.logsumexp(component_ll + log_w, dim=-1)


def amp_loss(amp: torch.Tensor, amp_target: torch.Tensor,
             loss_type: str = 'L1', weights: Optional[torch.Tensor] = None,
             log: bool = False, amin: float = 1e-5) -> torch.Tensor:
  """Loss comparing two amplitudes (optionally on a log scale)."""
  if log:
    amp = log10(torch.clamp(amp, min=amin))
    amp_target = log10(torch.clamp(amp_target, min=amin))
  return mean_difference(amp, amp_target, loss_type, weights)


def freq_loss(f_hz: torch.Tensor, f_hz_target: torch.Tensor,
              loss_type: str = 'L1',
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Loss comparing two frequencies on a MIDI (log) scale."""
  return mean_difference(hz_to_midi(f_hz), hz_to_midi(f_hz_target),
                         loss_type, weights)


class FilteredNoiseConsistencyLoss(Loss):
  """Consistency loss between two sets of filtered-noise magnitudes."""

  def __init__(self, weight: float = 1.0, name: Optional[str] = None):
    super().__init__(name)
    self.weight = weight

  def forward(self, noise_magnitudes: torch.Tensor,
              noise_magnitudes_target: torch.Tensor) -> torch.Tensor:
    return self.weight * amp_loss(noise_magnitudes, noise_magnitudes_target)


class HarmonicConsistencyLoss(Loss):
  """Consistency losses between two sets of harmonic synth controls.

  Returns a dict of losses (harm_amp_loss, harm_dist_loss, f0_hz_loss),
  the distribution and f0 terms masked where the target amplitude is
  below amp_threshold.
  """

  def __init__(self, amp_weight: float = 1.0, dist_weight: float = 1.0,
               f0_weight: float = 1.0, amp_threshold: float = 1e-4,
               name: Optional[str] = None):
    super().__init__(name)
    self.amp_weight = amp_weight
    self.dist_weight = dist_weight
    self.f0_weight = f0_weight
    self.amp_threshold = amp_threshold

  def forward(self, harm_amp, harm_amp_target, harm_dist, harm_dist_target,
              f0_hz, f0_hz_target):
    weights = (harm_amp_target >= self.amp_threshold).to(torch.float32)
    return {
        'harm_amp_loss':
            self.amp_weight * amp_loss(harm_amp, harm_amp_target),
        'harm_dist_loss':
            self.dist_weight * amp_loss(harm_dist, harm_dist_target,
                                        weights=weights),
        'f0_hz_loss':
            self.f0_weight * freq_loss(f0_hz, f0_hz_target, weights=weights),
    }

  def get_losses_dict(self, *args, **kwargs):
    return self(*args, **kwargs)


def _weighted_cdf(sorted_weights: Optional[torch.Tensor],
                  cdf_indices: torch.Tensor, n: int) -> torch.Tensor:
  """The CDF of one distribution at the pooled values: index / n without
  weights, else the cumulative weight there over the total."""
  if sorted_weights is None:
    return cdf_indices / float(n)
  cumweights = torch.cat([torch.zeros_like(sorted_weights[..., :1]),
                          torch.cumsum(sorted_weights, dim=-1)], dim=-1)
  cdf = torch.gather(cumweights, -1, cdf_indices)
  return safe_divide(cdf, cumweights[..., -1:])


def wasserstein_distance(u_values: torch.Tensor, v_values: torch.Tensor,
                         u_weights: Optional[torch.Tensor] = None,
                         v_weights: Optional[torch.Tensor] = None,
                         p: float = 1.0) -> torch.Tensor:
  """Differentiable 1-D Wasserstein distance between weighted samples.

  The CDF construction of scipy.stats.wasserstein_distance, batched over
  leading axes: [..., n_samples] -> [...]. A pooled value's position in
  each sorted sample is searchsorted's side='right' (the number of
  samples <= it), and the sorts are stable (so tied values pass their
  gradients and weights as the JAX package's do).
  """
  u_sorted = torch.sort(u_values, dim=-1, stable=True).values
  v_sorted = torch.sort(v_values, dim=-1, stable=True).values
  all_values = torch.sort(torch.cat([u_values, v_values], dim=-1), dim=-1,
                          stable=True).values
  deltas = torch.diff(all_values, dim=-1)

  points = all_values[..., :-1].detach().contiguous()
  u_cdf_indices = torch.searchsorted(u_sorted.detach().contiguous(), points,
                                     right=True)
  v_cdf_indices = torch.searchsorted(v_sorted.detach().contiguous(), points,
                                     right=True)

  def sorted_weights(values, weights):
    if weights is None:
      return None
    sorter = torch.argsort(values, dim=-1, stable=True)
    return torch.gather(weights, -1, sorter)

  u_cdf = _weighted_cdf(sorted_weights(u_values, u_weights), u_cdf_indices,
                        u_values.shape[-1])
  v_cdf = _weighted_cdf(sorted_weights(v_values, v_weights), v_cdf_indices,
                        v_values.shape[-1])
  integral = torch.sum(deltas * torch.abs(u_cdf - v_cdf)**p, dim=-1)
  return integral**(1.0 / p)


class WassersteinConsistencyLoss(Loss):
  """Wasserstein distance between two amplitude-weighted sinusoid traces
  (on the MIDI scale)."""

  def __init__(self, weight: float = 1.0, midi: bool = True,
               name: Optional[str] = None):
    super().__init__(name)
    self.weight = weight
    self.midi = midi

  def forward(self, amps_a, freqs_a, amps_b, freqs_b) -> torch.Tensor:
    loss = torch.zeros((), device=amps_a.device)
    if self.weight > 0.0 and self.midi:
      loss = wasserstein_distance(hz_to_midi(freqs_a), hz_to_midi(freqs_b),
                                  amps_a, amps_b, p=1.0)
      loss = torch.mean(self.weight * loss)
    return loss


class KDEConsistencyLoss(Loss):
  """Two-way gaussian-KDE NLL between two sinusoid traces.

  Each trace's sinusoids define a gaussian mixture on the MIDI scale
  (weights: the normalized amplitudes); the loss is the amplitude-weighted
  NLL of each trace under the other's mixture, plus a mean-amplitude term.
  """

  def __init__(self, weight_a: float = 1.0, weight_b: float = 1.0,
               weight_mean_amp: float = 1.0, scale_a: float = 0.1,
               scale_b: float = 0.1, name: Optional[str] = None):
    super().__init__(name)
    self.weight_a = weight_a
    self.weight_b = weight_b
    self.weight_mean_amp = weight_mean_amp
    self.scale_a = scale_a
    self.scale_b = scale_b

  def forward(self, amps_a, freqs_a, amps_b, freqs_b) -> torch.Tensor:
    loss = torch.zeros((), device=amps_a.device)
    if self.weight_a > 0.0:
      loss = loss + torch.mean(self.weight_a * self.nll(
          amps_a, freqs_a, amps_b, freqs_b, self.scale_b))
    if self.weight_b > 0.0:
      loss = loss + torch.mean(self.weight_b * self.nll(
          amps_b, freqs_b, amps_a, freqs_a, self.scale_a))
    if self.weight_mean_amp > 0.0:
      mean_amp_a = torch.mean(amps_a, dim=-1)
      mean_amp_b = torch.mean(amps_b, dim=-1)
      loss = loss + self.weight_mean_amp * torch.mean(
          torch.abs(mean_amp_a - mean_amp_b))
    return loss

  def nll(self, amps, freqs, amps_target, freqs_target,
          scale_target: float) -> torch.Tensor:
    """Amplitude-weighted -log p(source sinusoids | target KDE):
    [batch, time, freq] -> [batch, time]."""
    freqs_target_midi = hz_to_midi(freqs_target)
    amps_target = torch.where(amps_target == 0.0,
                              torch.full_like(amps_target, 1e-7), amps_target)
    probs = safe_divide(amps_target,
                        torch.sum(amps_target, dim=-1, keepdim=True))
    nll = -mixture_log_prob(hz_to_midi(freqs), probs, freqs_target_midi,
                            scale_target)
    amps_norm = safe_divide(amps, torch.sum(amps, dim=-1, keepdim=True))
    return torch.mean(nll * amps_norm, dim=-1)
