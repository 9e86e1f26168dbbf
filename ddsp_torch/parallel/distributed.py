"""Processes of a mesh over ranks: the process group and each rank's run.

The port's counterpart of jax.distributed.initialize, jax.process_index and
jax.process_count. PyTorch runs one process per card (JAX runs one per
host), so a mesh over ranks gives each rank the shards of one device: a
contiguous run of the mesh's row-major ('data', 'time') order (`Run`), which
may lie in one data row, hold whole rows or straddle a row boundary. `init`
starts the process group from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR / MASTER_PORT) or from explicit arguments, and
`shutdown` releases K3's mapped receive slots (kernels/halo.py) before it
ends the group. `check` is K3's: it raises on a fault of the remote copy,
or when its stream has not finished within its deadline, at a point where
the host waits for the device anyway (staging for gloo calls it first).

Every collective runs over every rank. Those of the sharded step are
differentiable:

  * `sum_over_ranks` is the psum of the loss's masked sums. Its backward
    passes the cotangent through: every rank seeds the same cotangent on
    its replica of the sum, which is the cotangent of each rank's part.
  * `gather_shards` is the all-gather of every shard's block, in the
    mesh's order: the phase totals, whose carries each rank takes for its
    own shards, and (through `gather_global` with `sums`) the signal
    inputs of a node whose output each rank slices again. Each rank reads
    the gathered copy in its own way, so their backward sums the ranks'
    cotangents (an all-reduce) and keeps this rank's shards.
  * `gather_global` assembles the global [batch, samples] signal from
    every rank's shards, for a value that every rank computes whole from
    it (a loss). Every rank holds that whole value and the step sums the
    parameter gradients over the ranks, so its backward keeps this rank's
    shards of its own cotangent and sums nothing: summing there would count
    the loss once for each rank of a row.

`all_reduce_` sums the gradients over every rank in place, through one
flat buffer; `mean_over_ranks` averages the dense step's loss scalars;
`gather_global` (without gradients) and `broadcast_object` serve the eval
loop.

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
class Run:
  """The shards of one process: `count` shards of an (n_data x n_time)
  mesh's row-major order from index `first` on.

  A run holds the tail of one data row, zero or more whole rows and the
  head of a later row, any of them empty: the whole mesh in one process, a
  run of one row's time shards, whole rows, or a run that straddles a row
  boundary. A process-local tensor of the run holds the batch rows of its
  data rows (`rows`) and the samples of the time shards in `span`: the
  run's own when it lies in one row, every time shard when it spans
  several. Where a row holds only part of the span, the shards it does not
  hold are zeros in the run's outputs and unread in its inputs.
  """

  first: int
  count: int
  n_data: int
  n_time: int

  def coords(self, j: int) -> Tuple[int, int]:
    """(data index, time index) of the run's j-th shard."""
    return divmod(self.first + j, self.n_time)

  def index(self, d: int, t: int) -> Optional[int]:
    """The position in the run of shard (d, t), or None if it is not the
    run's."""
    j = d * self.n_time + t - self.first
    return j if 0 <= j < self.count else None

  @property
  def rows(self) -> range:
    """The data rows the run touches."""
    return range(self.first // self.n_time,
                 (self.first + self.count - 1) // self.n_time + 1)

  @property
  def span(self) -> Tuple[int, int]:
    """[lo, hi): the time shards of the run's process-local tensors."""
    if len(self.rows) > 1:
      return 0, self.n_time
    t = self.first % self.n_time
    return t, t + self.count

  @property
  def whole_rows(self) -> bool:
    """Whether the run holds whole data rows and nothing else."""
    return self.first % self.n_time == 0 and self.count % self.n_time == 0


@dataclasses.dataclass(frozen=True)
class Ranks:
  """Where this process sits in an (n_data x n_time) mesh over ranks.

  Rank r holds the run of shards [r * per_rank, (r + 1) * per_rank) of the
  mesh's row-major order (`run`). A run that does not hold whole rows
  shares its first and last data rows with other ranks: its shifts cross
  to the ranks before and after it (`neighbours`), and the phase totals
  and the inputs of a node that gathers them come from those rows' other
  ranks. Those collectives, like the sums of the loss and the gradients
  over ('data', 'time'), run over every rank: one all-gather serves a rank
  whose run touches two shared rows, with no group of its own to order.
  """

  rank: int
  n_ranks: int
  n_data: int
  n_time: int

  @property
  def per_rank(self) -> int:
    return self.n_data * self.n_time // self.n_ranks

  @property
  def run(self) -> Run:
    return Run(self.rank * self.per_rank, self.per_rank, self.n_data,
               self.n_time)

  @property
  def shares_rows(self) -> bool:
    """Whether another rank holds shards of this rank's data rows."""
    return not self.run.whole_rows

  @property
  def neighbours(self) -> Tuple[Optional[int], Optional[int]]:
    """(left, right): the ranks holding the time shards just before the
    run's first and after its last, None where the run starts or ends a
    data row."""
    run = self.run
    left = self.rank - 1 if run.coords(0)[1] > 0 else None
    right = (self.rank + 1 if run.coords(run.count - 1)[1] < self.n_time - 1
             else None)
    return left, right


def mesh_ranks(n_data: int, n_time: int) -> Ranks:
  """This process's place in an (n_data x n_time) mesh over every rank.

  Every mesh whose size divides over the ranks: a rank's run may lie in
  one data row, hold whole rows or straddle a row boundary.
  """
  n_ranks = world_size()
  if (n_data * n_time) % n_ranks:
    raise ValueError(f'A ({n_data} x {n_time}) mesh does not divide over '
                     f'{n_ranks} ranks.')
  return Ranks(rank(), n_ranks, n_data, n_time)


def staged(x: torch.Tensor, group=None) -> Tuple[torch.Tensor, bool]:
  """(the tensor the group's backend moves, whether it is a host copy).
  A host copy waits for the device: K3's `check` first bounds that wait."""
  if x.is_cuda and dist.get_backend(group) == 'gloo':
    check()
    return x.cpu(), True
  return x, False


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
  """A new tensor: the sum of x over every rank."""
  y, on_host = staged(x.clone())
  dist.all_reduce(y)
  return y.to(x.device) if on_host else y


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
  """Sum every tensor over every rank, in place, in one collective on a
  flat float32 buffer."""
  if not tensors:
    return
  flat = _all_reduce(torch.cat([t.reshape(-1).float() for t in tensors]))
  offset = 0
  for t in tensors:
    n = t.numel()
    t.copy_(flat[offset:offset + n].view_as(t))
    offset += n


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
  """Overwrite every (contiguous) tensor with rank `src`'s, over every
  rank."""
  for t in tensors:
    y, on_host = staged(t.detach())
    dist.broadcast(y, src=src)
    if on_host:
      t.detach().copy_(y)


class _SumOverRanks(torch.autograd.Function):

  @staticmethod
  def forward(ctx, x):
    return _all_reduce(x)

  @staticmethod
  def backward(ctx, g):
    return g


def _all_gather(x: torch.Tensor) -> List[torch.Tensor]:
  """Every rank's x (the same shape on each), in rank order."""
  y, on_host = staged(x.contiguous())
  parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
  dist.all_gather(parts, y)
  return [p.to(x.device) for p in parts] if on_host else parts


class _GatherShards(torch.autograd.Function):

  @staticmethod
  def forward(ctx, ranks, sums, x):
    ctx.ranks, ctx.sums = ranks, sums
    return torch.cat(_all_gather(x), dim=0)

  @staticmethod
  def backward(ctx, g):
    if ctx.sums:
      g = _all_reduce(g.contiguous())
    run = ctx.ranks.run
    return None, None, g.narrow(0, run.first, run.count)


def gather_shards(x: torch.Tensor, ranks: Ranks,
                  sums: bool = True) -> torch.Tensor:
  """Every shard's block [size, ...] in row-major order, from each rank's
  blocks x [per_rank, ...] of its run: an all-gather over every rank.

  Backward, where `sums`: the ranks' cotangents summed (an all-reduce) and
  this rank's shards kept, for a gathered value that each rank reads in
  its own way (the phase totals, a node's inputs). Otherwise this rank's
  shards of its own cotangent, not summed (module docstring)."""
  return _GatherShards.apply(ranks, sums, x)


def assemble(blocks: Sequence[torch.Tensor], n_data: int, n_time: int,
             time_local: bool = True) -> torch.Tensor:
  """The global [batch, ...] tensor of every shard's block, in row-major
  order: each data row's blocks joined along the samples (dim 1) where
  they are time-local, else the row's first block (a value replicated
  over 'time'), and the rows joined along dim 0."""
  rows = [torch.cat(list(blocks[d * n_time:(d + 1) * n_time]), dim=1)
          if time_local else blocks[d * n_time] for d in range(n_data)]
  return torch.cat(rows, dim=0)


def gather_global(blocks: Sequence[torch.Tensor], ranks: Ranks,
                  time_local: bool = True,
                  sums: bool = False) -> torch.Tensor:
  """The global tensor (`assemble`) from this rank's blocks, one for each
  shard of its run (parallel/mesh.py split_time, or split_batch for a
  value replicated over 'time'). Collective over every rank.

  Backward: this rank's blocks of its own cotangent, for the input of a
  value every rank computes whole (a loss); with `sums`, of the ranks'
  cotangents summed, for the input of a node whose output each rank
  slices again (gather_shards)."""
  gathered = gather_shards(torch.stack(list(blocks)), ranks, sums)
  return assemble(gathered.unbind(0), ranks.n_data, ranks.n_time,
                  time_local)


def sum_over_ranks(x: torch.Tensor) -> torch.Tensor:
  """x summed over every rank; the backward passes the cotangent through
  (module docstring)."""
  return _SumOverRanks.apply(x)


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
  stacked = _all_reduce(stacked) / world_size()
  return list(stacked.unbind())
