"""Neighbour shifts of a time-sharded list of shards.

Port of ddsp_tpu/parallel/pallas_halo.py's `shift_right`, `shift_left` and
`neighbor_shift`. The time-sharded kernels (parallel/time_shard.py)
exchange overlap-add tails, group-delay heads and STFT halos with these.
Every shift runs K3 (kernels/halo.py) on a CUDA mesh and its plain version
on a CPU mesh, with the same zero-fill semantics and each direction the
other's adjoint.

`impl` keeps the JAX package's two names: there, 'xla' is a ppermute
collective and 'pallas' the in-kernel RDMA. In the port the shards of a
mesh share one device and one controlling process, so there is one
implementation, and both names run it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ddsp_torch.kernels.halo import HaloShift

HALO_IMPLS = ('xla', 'pallas')


def check_halo_impl(impl: str) -> None:
  if impl not in HALO_IMPLS:
    raise ValueError(f"halo_impl must be 'xla' or 'pallas', got {impl!r}")


def shift_right(shards: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
  """Shard (d, t)'s block goes to (d, t + 1); time shard 0 receives zeros.
  Differentiable (the adjoint is shift_left)."""
  return list(HaloShift.apply(mesh, +1, *shards))


def shift_left(shards: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
  """Shard (d, t)'s block goes to (d, t - 1); the last time shard receives
  zeros. Differentiable (the adjoint is shift_right)."""
  return list(HaloShift.apply(mesh, -1, *shards))


def neighbor_shift(shards: Sequence[torch.Tensor], mesh, direction: int,
                   impl: str = 'xla') -> List[torch.Tensor]:
  """+1 = toward higher time indices, -1 = lower; non-wrapping, zero-fill."""
  check_halo_impl(impl)
  return (shift_right if direction > 0 else shift_left)(shards, mesh)
