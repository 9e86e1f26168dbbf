"""Device meshes for the time-sharded (sequence-parallel) path.

Port of ddsp_tpu/parallel/mesh.py. The JAX package drives every shard of
its mesh from one program (shard_map); the port drives a process's shards
with a Python loop. A `Mesh` is a row-major ('data', 'time') grid of
shards; a device may hold several of them: on one card the 'time' shards
of a mesh share that card, and the halo kernel (K3, kernels/halo.py) reads
a neighbour's shard through its device pointer.

A mesh may span ranks of torch.distributed (parallel/distributed.py), one
process per device: rank r holds a contiguous run of the row-major order
(`Mesh.run`, a distributed.Run): time shards within one data row, whole
data rows, or the tail of one row and the head of a later one (with any
whole rows between). A shift between two ranks goes through K3's remote
copy; a shift within the run stays in the process. On such a mesh every
per-shard list holds this process's shards only, and the wrappers of
parallel/time_shard.py take and return process-local tensors: the rows of
the run's data rows and, for audio-rate tensors, the samples of its span
(`local_time` cuts them from a whole-length tensor): the run's own time
shards within one row, every sample for a run over several rows, where
the shards that a row of the run does not hold are zeros in an output.
The batch splits over 'data' across ranks, as
jax.make_array_from_process_local_data assembles it.

One process holding shards on several cards raises NotImplementedError
(ROADMAP.md queue 1 item 8). The split and concatenate helpers below are
what shard_map's in_specs and out_specs do; `shard_batch` and `replicate`
are the JAX helpers' counterparts for a mesh over ranks.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ddsp_torch.parallel import distributed
from ddsp_torch.utils.device import DeviceLike, resolve_device

TIME_AXIS = 'time'
DATA_AXIS = 'data'


def normalize_device(device: DeviceLike) -> torch.device:
  """torch.device(device), with a CUDA device's index filled in."""
  device = torch.device(device)
  if device.type == 'cuda' and device.index is None:
    device = torch.device('cuda', torch.cuda.current_device())
  return device


class Mesh:
  """A ('data', 'time') grid of shards.

  Shard i sits at (d, t) = divmod(i, n_time). `devices` are the devices of
  this process's shards, in row-major order: all n_data * n_time of them
  in one process, or a rank's run of them when `ranks` (a
  distributed.Ranks of this shape) places the mesh over ranks. Lists of
  shards throughout the port follow this order (`run`); `shard_coords(j)`
  gives the coordinates of a list's j-th shard.
  """

  def __init__(self, devices: Sequence[DeviceLike], n_data: int,
               n_time: int, ranks: Optional[distributed.Ranks] = None):
    devices = tuple(normalize_device(d) for d in devices)
    if ranks and (ranks.n_data, ranks.n_time) != (n_data, n_time):
      raise ValueError(f'A ({n_data} x {n_time}) mesh over the ranks of a '
                       f'({ranks.n_data} x {ranks.n_time}) one.')
    per_process = ranks.per_rank if ranks else n_data * n_time
    if n_data < 1 or n_time < 1 or len(devices) != per_process:
      raise ValueError(f'A ({n_data} x {n_time}) mesh needs '
                       f'{per_process} devices in this process, got '
                       f'{len(devices)}.')
    kinds = {d.type for d in devices}
    if len(kinds) > 1 or not kinds <= {'cpu', 'cuda'}:
      raise ValueError('A mesh holds CPU shards or CUDA shards, not '
                       f'{sorted(kinds)}.')
    if len(set(devices)) > 1:
      raise NotImplementedError(
          f'One process holds shards on {len(set(devices))} distinct cards; '
          'a mesh over several cards takes one rank per card '
          '(torch.distributed, parallel/distributed.py). One process driving '
          'several cards is ROADMAP.md queue 1 item 8.')
    self.devices = devices
    self.n_data = n_data
    self.n_time = n_time
    self.ranks = ranks

  @property
  def shape(self):
    return {DATA_AXIS: self.n_data, TIME_AXIS: self.n_time}

  @property
  def size(self) -> int:
    return self.n_data * self.n_time

  @property
  def n_ranks(self) -> int:
    return self.ranks.n_ranks if self.ranks else 1

  @property
  def run(self) -> distributed.Run:
    """This process's shards: the whole mesh in one process."""
    if self.ranks:
      return self.ranks.run
    return distributed.Run(0, self.size, self.n_data, self.n_time)

  @property
  def first_shard(self) -> int:
    """The row-major index of this process's first shard."""
    return self.run.first

  @property
  def first_device(self) -> torch.device:
    return self.devices[0]

  def coords(self, i: int):
    """(data index, time index) of shard i."""
    return divmod(i, self.n_time)

  def shard_coords(self, j: int):
    """(data index, time index) of this process's j-th shard."""
    return self.coords(self.first_shard + j)


def create_mesh(n_data: Optional[int] = None, n_time: int = 1,
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
  """A ('data', 'time') mesh.

  With a process group of several ranks (distributed.init), the mesh spans
  every rank and `devices` are this rank's shards' devices (default: the
  rank's current CUDA card, once for each of its shards); n_data defaults
  to the world size // n_time. Collective on every rank: it builds the
  rows' process groups.

  Args:
    n_data: Size of the data axis. Defaults to len(devices) // n_time.
    n_time: Size of the time axis (audio-sample sharding).
    devices: Devices of the shards in row-major order, repeats allowed
      (['cuda:0'] * 4 puts four time shards on one card; tests pass
      ['cpu'] * n). Default: the visible CUDA cards; raises without one.
  """
  if distributed.world_size() > 1:
    if n_data is None:
      n_data = distributed.world_size() // n_time
    ranks = distributed.mesh_ranks(n_data, n_time)
    if devices is None:
      if not torch.cuda.is_available():
        raise RuntimeError(
            'A rank\'s shards take its CUDA card by default, and no CUDA '
            "device is available; pass devices=['cpu'] * per_rank.")
      devices = [torch.device('cuda', torch.cuda.current_device())]
      devices = devices * ranks.per_rank
    return Mesh(devices, n_data, n_time, ranks)
  if devices is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'create_mesh takes the visible CUDA cards by default, and no CUDA '
          "device is available; pass devices=['cpu'] * n to run on the CPU.")
    devices = [torch.device('cuda', i)
               for i in range(torch.cuda.device_count())]
  devices = list(devices)
  if n_data is None:
    n_data = len(devices) // n_time
  if n_data < 1 or n_data * n_time > len(devices):
    raise ValueError(f'A ({n_data} x {n_time}) mesh needs '
                     f'{n_data * n_time} devices, got {len(devices)}.')
  return Mesh(devices[:n_data * n_time], n_data, n_time)


def single_device_mesh(device: DeviceLike = None) -> Mesh:
  """A trivial 1x1 mesh (CUDA unless the caller says otherwise)."""
  return create_mesh(n_data=1, n_time=1, devices=[resolve_device(device)])


def batch_is_sharded(mesh: Mesh, batch_size: int) -> bool:
  """Whether the batch splits over 'data' (ddsp_tpu time_shard._batch_axis).

  A batch that does not divide over the data axis (one long clip evaluated
  on the training mesh) is replicated: every data row holds all of it.
  Across ranks each process holds its own data rows' rows: the batch is
  sharded.
  """
  return mesh.n_ranks > 1 or batch_size % mesh.n_data == 0


def _rows(mesh: Mesh, batch_size: int, d: int) -> slice:
  """Data row d's rows of a process-local batch."""
  if not batch_is_sharded(mesh, batch_size):
    return slice(0, batch_size)
  rows = mesh.run.rows
  local = batch_size // len(rows)
  return slice((d - rows[0]) * local, (d - rows[0] + 1) * local)


def split_batch(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
  """Per-shard views of x [batch, ...]: each data row's batch rows,
  replicated over 'time' (shard_map in_specs P('data')). Across ranks x is
  process-local: the rows of the run's data rows."""
  return [x[_rows(mesh, x.shape[0], mesh.shard_coords(j)[0])].to(device)
          for j, device in enumerate(mesh.devices)]


def split_time(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
  """Per-shard views of x [batch, T]: the data row's batch rows and the
  shard's samples (in_specs P('data', 'time')). Across ranks x is
  process-local: its rows and the samples of the run's span."""
  lo, hi = mesh.run.span
  n = x.shape[1]
  if n % (hi - lo):
    raise ValueError(f'{n} samples do not divide over {hi - lo} time '
                     'shards.')
  t_local = n // (hi - lo)
  out = []
  for j, device in enumerate(mesh.devices):
    d, t = mesh.shard_coords(j)
    out.append(x[_rows(mesh, x.shape[0], d),
                 (t - lo) * t_local:(t - lo + 1) * t_local].to(device))
  return out


def concat_time(mesh: Mesh, shards: Sequence[torch.Tensor],
                batch_size: int) -> torch.Tensor:
  """The [batch, T] tensor of per-shard [rows, t_local] blocks (out_specs
  P('data', 'time')); process-local across ranks, with zeros where a row
  of the run does not hold a shard of its span. A replicated batch reads
  data row 0."""
  run = mesh.run
  lo, hi = run.span
  rows = run.rows if batch_is_sharded(mesh, batch_size) else run.rows[:1]
  out = []
  for d in rows:
    held = [run.index(d, t) for t in range(lo, hi)]
    out.append(torch.cat([shards[j] if j is not None
                          else torch.zeros_like(shards[0]) for j in held],
                         dim=1))
  return torch.cat(out, dim=0) if len(out) > 1 else out[0]


def time_span(mesh: Mesh, n_samples: int) -> slice:
  """The samples of this process's span in a [batch, n_samples] tensor."""
  if n_samples % mesh.n_time:
    raise ValueError(f'{n_samples} samples do not divide over '
                     f'{mesh.n_time} time shards.')
  t_local = n_samples // mesh.n_time
  lo, hi = mesh.run.span
  return slice(lo * t_local, hi * t_local)


def local_time(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
  """x [batch, T, ...] cut to this process's span across ranks; x itself
  in one process."""
  if mesh.n_ranks == 1:
    return x
  return x[:, time_span(mesh, x.shape[1])]


def local_rows(mesh: Mesh, batch_size: int) -> slice:
  """The rows of a global batch that this process holds: its data rows'
  (all of them in one process)."""
  if mesh.n_ranks == 1:
    return slice(0, batch_size)
  if batch_size % mesh.n_data:
    raise ValueError(f'A batch of {batch_size} does not divide over the '
                     f'{mesh.n_data} data rows of a mesh over ranks.')
  local = batch_size // mesh.n_data
  rows = mesh.run.rows
  return slice(rows[0] * local, (rows[-1] + 1) * local)


def global_rows(mesh: Mesh, local_batch: int):
  """(the global batch, this process's rows of it) for a process-local
  batch of `local_batch` rows: (local_batch, all of them) in one
  process."""
  if mesh.n_ranks == 1:
    return local_batch, slice(0, local_batch)
  rows = mesh.run.rows
  per_row = local_batch // len(rows)
  return per_row * mesh.n_data, slice(rows[0] * per_row,
                                      rows[0] * per_row + local_batch)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
  """The whole signal [rows, samples] of this process's data rows from its
  process-local x, gathered over every rank: the input of a node whose
  output each rank slices again (distributed.gather_global with `sums`:
  the backward sums the ranks' cotangents and keeps this process's
  shards)."""
  whole = distributed.gather_global(split_time(mesh, x), mesh.ranks,
                                    sums=True)
  return whole[local_rows(mesh, whole.shape[0])]


def gather_local(mesh: Mesh, x: torch.Tensor,
                 time_local: bool = True) -> torch.Tensor:
  """The global tensor of every rank's process-local x: its shards' blocks
  (`split_time`, or `split_batch` for a value replicated over 'time'),
  gathered over every rank and assembled (distributed.gather_global: the
  backward keeps this process's shards of its own cotangent)."""
  split = split_time if time_local else split_batch
  return distributed.gather_global(split(mesh, x), mesh.ranks, time_local)


def shard_batch(mesh: Mesh, batch: Dict[str, Any],
                n_samples: Optional[int] = None) -> Dict[str, Any]:
  """This process's part of a global batch (ddsp_tpu shard_batch): every
  leaf's rows of the run's data rows and, where `n_samples` is given, the
  audio-rate leaves ([batch, n_samples]) cut to the run's span. In one
  process the batch itself."""
  if mesh.n_ranks == 1:
    return batch

  def part(x):
    x = x[local_rows(mesh, x.shape[0])]
    if n_samples is not None and x.ndim == 2 and x.shape[1] == n_samples:
      x = x[:, time_span(mesh, n_samples)]
    return x

  if isinstance(batch, (tuple, list)):
    return type(batch)(shard_batch(mesh, b, n_samples) for b in batch)
  return {k: part(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
          for k, v in batch.items()}


def replicate(mesh: Mesh, tree):
  """Every rank's tensors overwritten with rank 0's, in place (ddsp_tpu
  replicate: parameters and optimizer state); nothing to do in one
  process. `tree` is a sequence or a dict of tensors, and is returned."""
  if mesh.n_ranks > 1:
    tensors = tree.values() if isinstance(tree, dict) else tree
    distributed.broadcast_(list(tensors))
  return tree
