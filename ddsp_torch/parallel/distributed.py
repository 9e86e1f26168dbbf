"""Processes of a mesh over ranks: the process group and the axis groups.

The port's counterpart of jax.distributed.initialize, jax.process_index and
jax.process_count. PyTorch runs one process per card (JAX runs one per
host), so a mesh over ranks gives each rank the shards of one device: a
contiguous run of the mesh's row-major ('data', 'time') order
(parallel/mesh.py), either a run of one data row's time shards or whole
data rows. `init` starts the process group from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or from explicit
arguments, and `shutdown` releases K3's mapped receive slots
(kernels/halo.py) before it ends the group. `check` is K3's: it raises on a
fault of the remote copy, or when its stream has not finished within its
deadline, at a point where the host waits for the device anyway (staging
for gloo calls it first).

The collectives of the sharded step are differentiable:

  * `sum_over_ranks` is the psum of the loss's masked sums. Its backward
    passes the cotangent through: every rank seeds the same cotangent on
    its replica of the sum, which is the cotangent of each rank's part.
  * `gather_over_ranks` is the all-gather of the phase totals over a data
    row's 'time' ranks, and `gather_samples` the same gather of a row's
    time-local signals along the sample axis, for a node whose output
    each rank slices again. Each rank reads the gathered copy in its own
    way, so their backward sums the ranks' cotangents (an all-reduce) and
    keeps this rank's part.
  * `gather_global` assembles the global [batch, samples] signal from
    every rank's block, for a value that every rank computes whole from
    it (a loss). Every rank holds that whole value and the step sums the
    parameter gradients over the ranks, so its backward keeps this rank's
    block of its own cotangent and sums nothing: summing there would count
    the loss once for each rank of a row.

`all_reduce_` sums the gradients over every rank in place, through one
flat buffer; `mean_over_ranks` averages the dense step's loss scalars;
`gather_blocks` and `broadcast_object` serve the eval loop.

A gloo group moves CPU tensors; a CUDA tensor on a gloo group is staged
through the host.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ddsp_torch.kernels.halo import check
from ddsp_torch.utils.device import DeviceLike

BACKENDS = ('nccl', 'gloo')


def default_backend(device: DeviceLike) -> str:
  """'nccl' for a CUDA device, 'gloo' for the CPU."""
  return 'nccl' if torch.device(device).type == 'cuda' else 'gloo'


def is_initialized() -> bool:
  return dist.is_available() and dist.is_initialized()


def rank() -> int:
  """This process's rank (jax.process_index); 0 without a process group."""
  return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
  """The number of ranks (jax.process_count); 1 without a process group."""
  return dist.get_world_size() if is_initialized() else 1


def local_rank() -> int:
  """The rank among this host's processes: torchrun's LOCAL_RANK, else the
  rank."""
  return int(os.environ.get('LOCAL_RANK', rank()))


def init(device: DeviceLike = None, backend: Optional[str] = None,
         init_method: str = 'env://', rank: Optional[int] = None,  # pylint: disable=redefined-outer-name
         world_size: Optional[int] = None,  # pylint: disable=redefined-outer-name
         timeout_s: float = 600.0) -> torch.device:
  """Start the process group; returns this rank's device.

  Args:
    device: This rank's device. Default: cuda:LOCAL_RANK (torchrun's one
      process per card).
    backend: 'nccl' or 'gloo'; default `default_backend(device)`.
    init_method: 'env://' reads torchrun's MASTER_ADDR / MASTER_PORT, RANK
      and WORLD_SIZE; 'tcp://host:port' or 'file://path' take `rank` and
      `world_size`.
    rank, world_size: For an init_method other than 'env://'.
    timeout_s: How long a collective waits for the other ranks.
  """
  if is_initialized():
    raise RuntimeError('The process group is already initialized.')
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'A rank takes cuda:LOCAL_RANK by default, and no CUDA device is '
          "available; pass device='cpu' (and backend='gloo').")
    device = torch.device('cuda', int(os.environ.get('LOCAL_RANK', 0)))
  device = torch.device(device)
  backend = backend or default_backend(device)
  if backend not in BACKENDS:
    raise ValueError(f'backend must be one of {BACKENDS}, not {backend!r}.')
  if backend == 'nccl' and device.type != 'cuda':
    raise ValueError('The nccl backend moves CUDA tensors; a CPU rank takes '
                     "backend='gloo'.")
  if device.type == 'cuda':
    torch.cuda.set_device(device)
  kwargs = {}
  if rank is not None:
    kwargs['rank'] = rank
  if world_size is not None:
    kwargs['world_size'] = world_size
  dist.init_process_group(
      backend=backend, init_method=init_method,
      timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
  return device


def barrier() -> None:
  if world_size() > 1:
    dist.barrier()


def shutdown() -> None:
  """Release K3's receive slots on every rank, then end the process group.

  Collective: every rank calls it.
  """
  if not is_initialized():
    return
  from ddsp_torch.kernels import halo  # pylint: disable=g-import-not-at-top
  halo.release_remote_slots()
  dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class Ranks:
  """Where this process sits in a mesh over ranks.

  Rank r holds shards [r * per_rank, (r + 1) * per_rank) of the mesh's
  row-major order: a run of time shards within one data row, or whole data
  rows (per_rank a multiple of the row's n_time). `time_group` holds the
  ranks of its data row in time order (`time_ranks`); it is None when one
  rank holds its whole row (`time_ranks` is then this rank alone). The
  'data' axis has no group of its own: the sums over ('data', 'time') of
  the loss and the gradients run over every rank.
  """

  rank: int
  n_ranks: int
  per_rank: int
  time_ranks: Tuple[int, ...]
  time_group: Optional[object]

  @property
  def row_ranks(self) -> int:
    """The ranks that share a data row (1 when a rank holds whole rows)."""
    return len(self.time_ranks)


def mesh_ranks(n_data: int, n_time: int) -> Ranks:
  """This process's place in an (n_data x n_time) mesh over every rank.

  Collective: every rank calls it with the same shape, and it creates the
  groups of every data row in the same order on each.
  """
  n_ranks = world_size()
  size = n_data * n_time
  if size % n_ranks:
    raise ValueError(f'A ({n_data} x {n_time}) mesh does not divide over '
                     f'{n_ranks} ranks.')
  per_rank = size // n_ranks
  if n_time % per_rank and per_rank % n_time:
    raise NotImplementedError(
        f'{per_rank} shards a rank on a ({n_data} x {n_time}) mesh straddle '
        'a data row boundary; a rank of a mesh over ranks holds a run of one '
        'row\'s time shards or whole rows (ROADMAP.md queue 1 item 10).')
  me = rank()
  ranks_per_row = max(1, n_time // per_rank)
  time_group, time_ranks = None, (me,)
  if ranks_per_row > 1:
    for d in range(n_data):
      row = tuple(range(d * ranks_per_row, (d + 1) * ranks_per_row))
      group = dist.new_group(list(row))
      if me in row:
        time_group, time_ranks = group, row
  return Ranks(me, n_ranks, per_rank, time_ranks, time_group)


def staged(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, bool]:
  """(the tensor the group's backend moves, whether it is a host copy).
  A host copy waits for the device: K3's `check` first bounds that wait."""
  if x.is_cuda and dist.get_backend(group) == 'gloo':
    check()
    return x.cpu(), True
  return x, False


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
  """A new tensor: the sum of x over the group's ranks."""
  y, on_host = staged(x.clone(), group)
  dist.all_reduce(y, group=group)
  return y.to(x.device) if on_host else y


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
  """Sum every tensor over every rank, in place, in one collective on a
  flat float32 buffer."""
  if not tensors:
    return
  flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]),
                     None)
  offset = 0
  for t in tensors:
    n = t.numel()
    t.copy_(flat[offset:offset + n].view_as(t))
    offset += n


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
  """Overwrite every (contiguous) tensor with rank `src`'s, over every
  rank."""
  for t in tensors:
    y, on_host = staged(t.detach(), None)
    dist.broadcast(y, src=src)
    if on_host:
      t.detach().copy_(y)


class _SumOverRanks(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x):
    return _all_reduce(x, None)

  @staticmethod
  def backward(ctx, g):
    return g


def _all_gather(x: torch.Tensor, group) -> List[torch.Tensor]:
  """Every rank's x (the same shape on each) over the group, in rank
  order."""
  y, on_host = staged(x.contiguous(), group)
  parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
  dist.all_gather(parts, y, group=group)
  return [p.to(x.device) for p in parts] if on_host else parts


class _GatherOverRanks(torch.autograd.Function):

  @staticmethod
  def forward(ctx, group, index, dim, x):
    ctx.group, ctx.index, ctx.dim, ctx.n = group, index, dim, x.shape[dim]
    return torch.cat(_all_gather(x, group), dim=dim)

  @staticmethod
  def backward(ctx, g):
    total = _all_reduce(g.contiguous(), ctx.group)
    return None, None, None, total.narrow(ctx.dim, ctx.index * ctx.n, ctx.n)


def assemble(parts: Sequence[torch.Tensor], row_ranks: int,
             time_local: bool = True) -> torch.Tensor:
  """The global [batch, ...] tensor of the ranks' blocks, in rank order:
  each data row's ranks' blocks joined along the samples (dim 1) where
  they are time-local, else the row's first rank's block (a value
  replicated over 'time'), and the rows joined along dim 0."""
  rows = [torch.cat(list(parts[i:i + row_ranks]), dim=1) if time_local
          else parts[i] for i in range(0, len(parts), row_ranks)]
  return torch.cat(rows, dim=0)


def own_block(ranks: Ranks, x: torch.Tensor, rows: int,
              samples: int) -> torch.Tensor:
  """This rank's [rows, samples] block of a global tensor that
  `assemble` made from time-local blocks of that shape."""
  row, t = divmod(ranks.rank, ranks.row_ranks)
  return x[row * rows:(row + 1) * rows, t * samples:(t + 1) * samples]


def gather_blocks(x: torch.Tensor, ranks: Ranks,
                  time_local: bool = True) -> torch.Tensor:
  """The global tensor of every rank's block x (`assemble`); not
  differentiable. Collective over every rank."""
  return assemble(_all_gather(x, None), ranks.row_ranks, time_local)


class _GatherGlobal(torch.autograd.Function):

  @staticmethod
  def forward(ctx, ranks, x):
    ctx.ranks, ctx.shape = ranks, x.shape
    return gather_blocks(x, ranks)

  @staticmethod
  def backward(ctx, g):
    return None, own_block(ctx.ranks, g, ctx.shape[0], ctx.shape[1])


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
  """x summed over every rank; the backward passes the cotangent through
  (module docstring)."""
  return _SumOverRanks.apply(x)


def gather_over_ranks(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
  """The ranks' x [n, ...] concatenated along dim 0 in time order over the
  row's 'time' group; the backward sums the ranks' cotangents."""
  return _GatherOverRanks.apply(ranks.time_group,
                                ranks.time_ranks.index(ranks.rank), 0, x)


def gather_samples(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
  """A data row's signal [rows, samples, ...] from its ranks' time-local
  blocks, joined along dim 1 in time order over the row's 'time' group:
  the input of a node whose output each rank slices again. Backward: the
  row's ranks' cotangents summed (an all-reduce), this rank's samples
  kept."""
  return _GatherOverRanks.apply(ranks.time_group,
                                ranks.time_ranks.index(ranks.rank), 1, x)


def gather_global(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
  """The global [batch, samples] signal from every rank's time-local
  [rows, samples] block: the input of a value every rank computes whole
  (a loss). Backward: this rank's block of its own cotangent, not summed
  over the ranks (module docstring)."""
  return _GatherGlobal.apply(ranks, x)


def broadcast_object(obj: Any, src: int = 0) -> Any:
  """Rank src's picklable obj on every rank."""
  box = [obj]
  dist.broadcast_object_list(box, src=src)
  return box[0]


def mean_over_ranks(values: List[torch.Tensor]) -> List[torch.Tensor]:
  """Each scalar averaged over every rank (the dense step's loss
  scalars)."""
  if world_size() == 1:
    return values
  stacked = torch.stack([v.detach().float() for v in values])
  stacked = _all_reduce(stacked, None) / world_size()
  return list(stacked.unbind())
