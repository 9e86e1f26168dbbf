"""Vector quantization with EMA codebook updates (VQ-VAE).

Port of ddsp_tpu/nn/vq.py. The EMA statistics, flax's 'vq_stats' collection
(`counts` [k], `sums` [k, head_depth]), are buffers here, updated in place
only in training. Dead-code restarts draw from an explicit torch.Generator
where the JAX module draws from its 'vq' stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ddsp_torch.losses.spectral import mean_difference


class VectorQuantization(nn.Module):
  """EMA vector quantizer with dead-codebook restarts.

  Attributes:
    k: Codebook size.
    depth: Channels of the input (flax infers them).
    gamma: EMA decay of the cluster counts and sums.
    restart_threshold: Restart centroids whose EMA count falls below
      threshold * n / k (0 restarts only never-used codes).
    num_heads: Split the input depth into this many independent
      quantizations.
    commitment_loss_weight: Weight of the encoder commitment loss.
    name: The loss's name prefix (get_losses_dict).
  """

  jax_collection = 'vq_stats'

  def __init__(self, k: int, depth: int, gamma: float = 0.99,
               restart_threshold: float = 0.0, num_heads: int = 1,
               commitment_loss_weight: float = 0.2,
               name: Optional[str] = None):
    super().__init__()
    if depth % num_heads != 0:
      raise ValueError('Input depth must be a multiple of the number of '
                       'heads.')
    self.k = k
    self.depth = depth
    self.gamma = gamma
    self.restart_threshold = restart_threshold
    self.num_heads = num_heads
    self.commitment_loss_weight = commitment_loss_weight
    self.name = name
    self.register_buffer('counts', torch.zeros(k))
    self.register_buffer('sums', torch.zeros(k, depth // num_heads))

  def jax_collection_items(self) -> Dict[str, torch.Tensor]:
    return {'counts': self.counts, 'sums': self.sums}

  def _centroids(self) -> torch.Tensor:
    """EMA means [k, head_depth]; 0 for codes never assigned."""
    counts = self.counts[:, None]
    mean = self.sums / torch.clamp(counts, min=1e-12)
    return torch.where(counts > 0, mean, torch.zeros_like(mean))

  def forward(self, x: torch.Tensor, training: bool = False,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize x [..., depth]; returns (z, codes).

    z is x quantized, with straight-through gradients; codes are the
    integer code indices [..., num_heads]. In training, codes whose EMA
    count is below the threshold restart from rows of the batch (uniform
    noise past the batch's size), drawn from `generator` (one seeded with
    0 on x's device if None, as the JAX module falls back to PRNGKey(0)),
    and the EMA statistics are updated.
    """
    if x.shape[-1] != self.depth:
      raise ValueError(f'Input depth {x.shape[-1]} != {self.depth}.')
    x_flat = x.reshape(-1, self.depth)
    # Stack the heads' segments along the batch axis.
    x_flat = torch.cat(torch.chunk(x_flat, self.num_heads, dim=1), dim=0)
    n = x_flat.shape[0]
    ema_mean = self._centroids()

    if training:
      if generator is None:
        generator = torch.Generator(x.device).manual_seed(0)
      keep = self.counts * self.k > self.restart_threshold * n
      e_restart = torch.rand(ema_mean.shape, generator=generator,
                             device=x.device)
      shuffled = x_flat[torch.randperm(n, generator=generator,
                                       device=x.device)]
      # The first min(k, n) shuffled rows fill the restart slots in order.
      restart_rank = torch.cumsum((~keep).to(torch.int64), dim=0) - 1
      use_batch = torch.logical_and(~keep, restart_rank < n)
      batch_rows = shuffled[torch.clamp(restart_rank, 0, n - 1)]
      e_restart = torch.where(use_batch[:, None], batch_rows, e_restart)
      e = torch.where(keep[:, None], ema_mean, e_restart)
    else:
      e = ema_mean

    # The nearest centroid of each input vector.
    distances = (torch.sum(x_flat**2, dim=1, keepdim=True) -
                 2 * x_flat @ e.T + torch.sum(e**2, dim=1)[None, :])
    c = torch.argmin(distances, dim=1)

    z = torch.cat(torch.chunk(e[c], self.num_heads, dim=0), dim=1)
    z = z.reshape(x.shape)
    z = x + (z - x).detach()

    if training:
      with torch.no_grad():
        oh = torch.nn.functional.one_hot(c, self.k).to(torch.float32)
        self.counts.sub_((1 - self.gamma) * (self.counts - oh.sum(dim=0)))
        self.sums.sub_((1 - self.gamma) * (self.sums - oh.T @ x_flat))

    c = torch.stack(torch.chunk(c, self.num_heads, dim=0), dim=1)
    return z, c.reshape(x.shape[:-1] + (self.num_heads,))

  def unquantize(self, c: torch.Tensor) -> torch.Tensor:
    """Codes [..., num_heads] -> centroid vectors [..., depth]."""
    z = self._centroids()[c]  # [..., num_heads, head_depth]
    return z.reshape(c.shape[:-1] + (-1,))

  def commitment_loss(self, z: torch.Tensor,
                      z_q: torch.Tensor) -> torch.Tensor:
    """Keeps the encoder's outputs close to their centroids."""
    return self.commitment_loss_weight * mean_difference(
        z, z_q.detach(), loss_type='L2')

  def get_losses_dict(self, z: torch.Tensor,
                      z_q: torch.Tensor) -> Dict[str, torch.Tensor]:
    name = self.name if self.name else 'vector_quantization'
    return {name + '_commitment_loss': self.commitment_loss(z, z_q)}
