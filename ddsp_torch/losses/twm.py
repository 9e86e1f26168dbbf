"""Differentiable Two-way Mismatch (TWM) loss.

Port of ddsp_tpu/losses/twm.py. A probabilistic, differentiable
adaptation of the Maher & Beauchamp (1993) two-way mismatch f0 estimator:
for each f0 candidate, score -log p(sinusoids | candidate harmonics) -
log p(harmonics | sinusoids) with gaussian mixtures, then softmin over the
candidates.

The mixtures are evaluated as one tensor of [batch, time, candidate,
partial, component] on the inputs' device: with every sinusoid a
candidate (TWMEvaluator) that is 100 x 100 x 30 terms a frame, 1.2 GB for
4 x 250 frames in float32. predict_f0 brings only the [batch, time,
candidate] loss to the host for numpy's nanargmin.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddsp_torch.losses.consistency import mixture_log_prob
from ddsp_torch.losses.spectral import Loss
from ddsp_torch.ops.core import hz_to_midi, safe_divide, torch_float32


class TWMLoss(Loss):
  """Encourages sinusoids to be harmonics of the best f0 candidate.

  Attributes:
    sinusoids_weight: Weight of the -log p(sinusoids|harmonics) term.
    harmonics_weight: Weight of the -log p(harmonics|sinusoids) term.
    sinusoids_scale: Stddev of gaussians around each sinusoid (MIDI).
    harmonics_scale: Stddev of gaussians around each harmonic (ratio).
    n_harmonic_points: Harmonic points per candidate for
      p(harmonics|sinusoids).
    n_harmonic_gaussians: Gaussians per candidate for
      p(sinusoids|harmonics).
    softmin_temperature: Lower values focus more on the single best
      candidate.
    sample_rate: Hz, to ignore harmonics above Nyquist.
  """

  def __init__(self, sinusoids_weight: float = 1.0,
               harmonics_weight: float = 1.0, sinusoids_scale: float = 0.5,
               harmonics_scale: float = 0.2, n_harmonic_points: int = 10,
               n_harmonic_gaussians: int = 30,
               softmin_temperature: float = 1.0, sample_rate: int = 16000,
               name: Optional[str] = None):
    super().__init__(name)
    self.sinusoids_weight = sinusoids_weight
    self.harmonics_weight = harmonics_weight
    self.sinusoids_scale = sinusoids_scale
    self.harmonics_scale = harmonics_scale
    self.n_harmonic_points = n_harmonic_points
    self.n_harmonic_gaussians = n_harmonic_gaussians
    self.softmin_temperature = softmin_temperature
    self.sample_rate = sample_rate

  def forward(self, f0_candidates: torch.Tensor, freqs: torch.Tensor,
              amps: torch.Tensor) -> torch.Tensor:
    """The TWM loss scalar.

    Args:
      f0_candidates: Candidate frequencies in hertz, [batch, time, c].
      freqs: Sinusoid frequencies in hertz, [batch, time, freq].
      amps: Sinusoid amplitudes (> 0), [batch, time, freq].
    """
    combined_loss = self.combined_loss(f0_candidates, freqs, amps)
    # A softmin over the candidates keeps the loss differentiable while
    # focusing on the best (lowest-cost) candidate.
    softmin_loss = combined_loss * torch.softmax(
        -combined_loss / self.softmin_temperature, dim=-1)
    return torch.mean(softmin_loss)

  def combined_loss(self, f0_candidates, freqs, amps) -> torch.Tensor:
    """The weighted sum of both terms, [batch, time, candidate]."""
    sinusoids_loss, harmonics_loss = self.get_loss_tensors(
        f0_candidates, freqs, amps)
    return (self.sinusoids_weight * sinusoids_loss +
            self.harmonics_weight * harmonics_loss)

  @torch.no_grad()
  def predict_f0(self, f0_candidates, freqs, amps) -> np.ndarray:
    """Most likely f0 among the candidates (non-differentiable): the
    losses on the device of `freqs` (arrays go to the CPU), numpy's
    nanargmin on the host."""
    freqs = torch_float32(freqs)
    f0_candidates = torch_float32(f0_candidates, freqs.device)
    amps = torch_float32(amps, freqs.device)
    loss = self.combined_loss(f0_candidates, freqs, amps).cpu().numpy()
    f0_idx = np.nanargmin(loss, axis=-1)[..., np.newaxis]
    return np.take_along_axis(f0_candidates.cpu().numpy(), f0_idx, axis=-1)

  def get_loss_tensors(self, f0_candidates: torch.Tensor,
                       freqs: torch.Tensor, amps: torch.Tensor):
    """Per-candidate loss traces, both [batch, time, candidate]."""
    device = freqs.device
    # ----- P(sinusoids | candidate_harmonics) -----
    # A uniform mixture of gaussians at integer harmonic numbers, evaluated
    # at each sinusoid's frequency ratio to the candidate.
    freq_ratios = safe_divide(freqs[:, :, None, :],
                              f0_candidates[:, :, :, None])
    harm_locs = torch.arange(1, self.n_harmonic_gaussians + 1,
                             dtype=torch.float32, device=device)
    harm_probs = torch.full((self.n_harmonic_gaussians,),
                            1.0 / self.n_harmonic_gaussians, device=device)
    # [batch, time, candidate, partial]
    nll_sinusoids = -mixture_log_prob(freq_ratios, harm_probs, harm_locs,
                                      self.harmonics_scale)
    a = amps[:, :, None, :]
    # Mean weighted by the sinusoids' amplitudes: [batch, time, candidate].
    sinusoids_loss = safe_divide(torch.sum(nll_sinusoids * a, dim=-1),
                                 torch.sum(a, dim=-1))

    # ----- P(candidate_harmonics | sinusoids) -----
    # A gaussian KDE at each sinusoid (MIDI, amplitude-weighted), evaluated
    # at each candidate's harmonic series.
    harmonics = self.get_candidate_harmonics(f0_candidates, as_midi=True)
    sinusoids_midi = hz_to_midi(freqs)
    amps_pos = torch.where(amps == 0.0, torch.full_like(amps, 1e-7), amps)
    probs = safe_divide(amps_pos, torch.sum(amps_pos, dim=-1, keepdim=True))

    b, t, c, h = harmonics.shape
    nll_harmonics = -mixture_log_prob(harmonics.reshape(b, t, c * h), probs,
                                      sinusoids_midi, self.sinusoids_scale)
    nll_harmonics = nll_harmonics.reshape(b, t, c, h)

    # A prior of decreasing importance of the upper harmonics.
    amps_prior = torch.linspace(1.0, 1.0 / self.n_harmonic_points,
                                self.n_harmonic_points, device=device)
    harmonics_loss = nll_harmonics * amps_prior

    # Mask harmonics above Nyquist, reweighted by the fraction kept so that
    # the loss does not just favour the highest candidate.
    nyquist_midi = hz_to_midi(torch.tensor(self.sample_rate / 2.0))
    nyquist_mask = (harmonics < nyquist_midi.to(device)).to(torch.float32)
    harmonics_loss = harmonics_loss * safe_divide(
        nyquist_mask, torch.mean(nyquist_mask, dim=-1, keepdim=True))
    harmonics_loss = torch.mean(harmonics_loss, dim=-1)
    return sinusoids_loss, harmonics_loss

  def get_candidate_harmonics(self, f0_candidates: torch.Tensor,
                              as_midi: bool = True) -> torch.Tensor:
    """Harmonic series of each candidate, [batch, time, cand, harmonic]."""
    n = torch.arange(1, self.n_harmonic_points + 1, dtype=torch.float32,
                     device=f0_candidates.device)
    harmonics = f0_candidates[:, :, :, None] * n
    if as_midi:
      harmonics = hz_to_midi(harmonics)
    return harmonics
