"""Device meshes for the time-sharded (sequence-parallel) path.

Port of ddsp_tpu/parallel/mesh.py for one controlling process: the JAX
package drives every shard of its mesh from one program (shard_map), and so
does the port, with a Python loop over the shards. A `Mesh` is a row-major
('data', 'time') grid of torch devices, and a device may appear more than
once: on one card the 'time' shards of a mesh share that card, and the halo
kernel (K3, kernels/halo.py) reads a neighbour's shard through its device
pointer.

A mesh whose shards sit on more than one card raises NotImplementedError:
peer access between cards comes with ROADMAP.md queue 1 item 8. The JAX
package's `shard_batch` and `replicate` place arrays on a mesh of devices
owned by one or more processes; one process that holds every shard on one
device has nothing to place, so they have no counterpart here. The split and
concatenate helpers below are what shard_map's in_specs and out_specs do.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

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
  """A ('data', 'time') grid of torch devices.

  Shard i sits at (d, t) = divmod(i, n_time) on `devices[i]`. Lists of
  shards throughout the port follow this row-major order.
  """

  def __init__(self, devices: Sequence[DeviceLike], n_data: int,
               n_time: int):
    devices = tuple(normalize_device(d) for d in devices)
    if n_data < 1 or n_time < 1 or len(devices) != n_data * n_time:
      raise ValueError(f'A ({n_data} x {n_time}) mesh needs '
                       f'{n_data * n_time} devices, got {len(devices)}.')
    kinds = {d.type for d in devices}
    if len(kinds) > 1 or not kinds <= {'cpu', 'cuda'}:
      raise ValueError('A mesh holds CPU shards or CUDA shards, not '
                       f'{sorted(kinds)}.')
    if len(set(devices)) > 1:
      raise NotImplementedError(
          f'The mesh spans {len(set(devices))} distinct cards; meshes over '
          'several cards (peer access, cross-device events) come with '
          'ROADMAP.md queue 1 item 8. Put every shard on one card.')
    self.devices = devices
    self.n_data = n_data
    self.n_time = n_time

  @property
  def shape(self):
    return {DATA_AXIS: self.n_data, TIME_AXIS: self.n_time}

  @property
  def size(self) -> int:
    return self.n_data * self.n_time

  @property
  def first_device(self) -> torch.device:
    return self.devices[0]

  def coords(self, i: int):
    """(data index, time index) of shard i."""
    return divmod(i, self.n_time)


def create_mesh(n_data: Optional[int] = None, n_time: int = 1,
                devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
  """A ('data', 'time') mesh.

  Args:
    n_data: Size of the data axis. Defaults to len(devices) // n_time.
    n_time: Size of the time axis (audio-sample sharding).
    devices: Devices of the shards in row-major order, repeats allowed
      (['cuda:0'] * 4 puts four time shards on one card; tests pass
      ['cpu'] * n). Default: the visible CUDA cards; raises without one.
  """
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
  """
  return batch_size % mesh.n_data == 0


def _rows(mesh: Mesh, batch_size: int, d: int) -> slice:
  if not batch_is_sharded(mesh, batch_size):
    return slice(0, batch_size)
  local = batch_size // mesh.n_data
  return slice(d * local, (d + 1) * local)


def split_batch(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
  """Per-shard views of x [batch, ...]: each data row's batch rows,
  replicated over 'time' (shard_map in_specs P('data'))."""
  return [x[_rows(mesh, x.shape[0], mesh.coords(i)[0])].to(mesh.devices[i])
          for i in range(mesh.size)]


def split_time(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
  """Per-shard views of x [batch, T]: the data row's batch rows and the
  shard's T / n_time samples (in_specs P('data', 'time'))."""
  n = x.shape[1]
  if n % mesh.n_time:
    raise ValueError(f'{n} samples do not divide over {mesh.n_time} time '
                     'shards.')
  t_local = n // mesh.n_time
  out = []
  for i in range(mesh.size):
    d, t = mesh.coords(i)
    out.append(x[_rows(mesh, x.shape[0], d),
                 t * t_local:(t + 1) * t_local].to(mesh.devices[i]))
  return out


def concat_time(mesh: Mesh, shards: Sequence[torch.Tensor],
                batch_size: int) -> torch.Tensor:
  """The global [batch, T] tensor of per-shard [rows, t_local] blocks
  (out_specs P('data', 'time')). A replicated batch reads data row 0."""
  n_rows = mesh.n_data if batch_is_sharded(mesh, batch_size) else 1
  rows = [torch.cat(list(shards[d * mesh.n_time:(d + 1) * mesh.n_time]),
                    dim=1) for d in range(n_rows)]
  return torch.cat(rows, dim=0) if n_rows > 1 else rows[0]
