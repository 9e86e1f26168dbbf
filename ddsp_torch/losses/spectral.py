"""Spectral and generic parameter losses.

Port of ddsp_tpu/losses/spectral.py (mean_difference, Loss, LossGroup,
SpectralLoss, ParamLoss). The multi-scale spectral loss takes 6 FFT sizes of
two signals per step; magnitudes are shared between the terms of a size.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ddsp_torch.ops import spectral
from ddsp_torch.ops.core import diff as diff_op
from ddsp_torch.ops.core import safe_log
from ddsp_torch.proc.dags import DAGModule, default_module_name


def mean_difference(target: torch.Tensor, value: torch.Tensor,
                    loss_type: str = 'L1',
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Common loss reductions: 'L1', 'L2', or 'COSINE'."""
  difference = target - value
  weights = 1.0 if weights is None else weights
  loss_type = loss_type.upper()
  if loss_type == 'L1':
    return torch.mean(torch.abs(difference * weights))
  if loss_type == 'L2':
    return torch.mean(difference**2 * weights)
  if loss_type == 'COSINE':
    # Cosine distance along the last axis, averaged.
    t = target / (torch.linalg.norm(target, dim=-1, keepdim=True) + 1e-8)
    v = value / (torch.linalg.norm(value, dim=-1, keepdim=True) + 1e-8)
    return torch.mean((1.0 - torch.sum(t * v, dim=-1)) * weights)
  raise ValueError(f'Loss type ({loss_type}), must be "L1", "L2", or '
                   '"COSINE"')


class Loss(nn.Module):
  """Base class. Duck typing: losses just implement get_losses_dict()."""

  def __init__(self, name: Optional[str] = None):
    super().__init__()
    self.name = name

  def get_losses_dict(self, *args, **kwargs):
    """Returns a dictionary {name: loss} for the model."""
    return {default_module_name(self): self(*args, **kwargs)}


class LossGroup(DAGModule):
  """Compute a group of loss modules as a DAG over an outputs dictionary."""

  @property
  def loss_names(self):
    return self.node_names

  def forward(self, outputs, **kwargs):
    """Returns a flat dictionary of losses {name: scalar}."""
    dag_outputs = self.run_dag(outputs, **kwargs)
    loss_outputs = {}
    for k in self.node_names:
      loss_outputs.update(dag_outputs[k])
    return loss_outputs

  def get_losses_dict(self, outputs, **kwargs):
    return self(outputs, **kwargs)


class SpectralLoss(Loss):
  """Multi-scale spectrogram loss.

  Attributes:
    fft_sizes: Compare spectrograms at each of these fft sizes.
    loss_type: One of 'L1', 'L2', or 'COSINE'.
    compute_dtype: Kept so that specs of the JAX package load; it selects
      that package's GEMM-DFT operand type on the TPU and has no effect on
      the FFT path, which is always float32.
    mag_weight: Weight on linear magnitude difference.
    delta_time_weight: Weight on the time finite-difference of magnitudes.
    delta_freq_weight: Weight on the frequency finite-difference.
    cumsum_freq_weight: Weight on the cumulative sum over frequency
      (1-D Wasserstein-like term).
    logmag_weight: Weight on log magnitude difference.
    loudness_weight: Weight on perceptual loudness difference.
  """

  def __init__(self,
               fft_sizes: Sequence[int] = (2048, 1024, 512, 256, 128, 64),
               loss_type: str = 'L1', compute_dtype: str = 'bfloat16',
               mag_weight: float = 1.0, delta_time_weight: float = 0.0,
               delta_freq_weight: float = 0.0,
               cumsum_freq_weight: float = 0.0, logmag_weight: float = 0.0,
               loudness_weight: float = 0.0, name: Optional[str] = None):
    super().__init__(name)
    self.fft_sizes = tuple(fft_sizes)
    self.loss_type = loss_type
    self.compute_dtype = compute_dtype
    self.mag_weight = mag_weight
    self.delta_time_weight = delta_time_weight
    self.delta_freq_weight = delta_freq_weight
    self.cumsum_freq_weight = cumsum_freq_weight
    self.logmag_weight = logmag_weight
    self.loudness_weight = loudness_weight

  def forward(self, target_audio: torch.Tensor, audio: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    loss = 0.0
    difference = lambda t, v: mean_difference(t, v, self.loss_type,
                                              weights=weights)
    for size in self.fft_sizes:
      target_mag = spectral.compute_mag(target_audio, size=size)
      value_mag = spectral.compute_mag(audio, size=size)

      if self.mag_weight > 0:
        loss = loss + self.mag_weight * difference(target_mag, value_mag)
      if self.delta_time_weight > 0:
        loss = loss + self.delta_time_weight * difference(
            diff_op(target_mag, axis=1), diff_op(value_mag, axis=1))
      if self.delta_freq_weight > 0:
        loss = loss + self.delta_freq_weight * difference(
            diff_op(target_mag, axis=2), diff_op(value_mag, axis=2))
      if self.cumsum_freq_weight > 0:
        loss = loss + self.cumsum_freq_weight * difference(
            torch.cumsum(target_mag, dim=2), torch.cumsum(value_mag, dim=2))
      if self.logmag_weight > 0:
        loss = loss + self.logmag_weight * difference(
            safe_log(target_mag), safe_log(value_mag))

    if self.loudness_weight > 0:
      loss = loss + self.loudness_weight * difference(
          spectral.compute_loudness(target_audio, n_fft=2048),
          spectral.compute_loudness(audio, n_fft=2048))
    return loss


class ParamLoss(Loss):
  """Loss on the mean difference between any two tensors."""

  def __init__(self, weight: float = 1.0, loss_type: str = 'L1',
               name: Optional[str] = None):
    super().__init__(name)
    self.weight = weight
    self.loss_type = loss_type

  def forward(self, pred: torch.Tensor, target: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    return self.weight * mean_difference(pred, target, self.loss_type,
                                         weights)
