"""Kernel K3: the neighbour halo shift of a time-sharded mesh.

Wraps csrc/halo.cu, which replaces ddsp_tpu/parallel/pallas_halo.py:
_shift_kernel (reached through _shift). `HaloShift` is the
torch.autograd.Function around it: for a list of shards (this process's,
row-major over ('data', 'time')), shard (d, t) receives the block of shard
(d, t - direction), and zeros where that falls off the end of the time
axis. Shifts by +1 and -1 are each other's adjoint, so the backward is the
same kernel in the opposite direction.

Shards of one process launch `ddsp_halo_shift` (counted as 'shift'). On a
mesh over ranks (parallel/distributed.py) a rank's edge shard has its
neighbour in another process: that block goes through the remote copy,
`ddsp_halo_remote` (counted as 'remote_shift'), which writes it into the
neighbour's receive slot, mapped with CUDA IPC, and waits for its own.
Every rank of a row makes the same K3 calls in the same order, forward and
backward, as the JAX package's collective-id pool arranges for its
barriers; the stamp of each slot's use and each call makes a mismatch
raise instead of reading stale data. CPU shards take the plain versions:
`halo_shift_plain` in a process, `remote_shift_plain` (torch.distributed
point-to-point sends, the yardstick on the card) between ranks.

The Pallas kernel's interpret-mode fallback to ppermute is a simulator
detail with no counterpart here.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ddsp_torch.kernels import _build

# Kernel launches so far; a run reads it to show that its path went
# through K3.
launches: Dict[str, int] = {'shift': 0, 'remote_shift': 0}

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
MAX_SHARDS = 64


def reset_launches() -> None:
  for key in launches:
    launches[key] = 0


def halo_shift_plain(shards: Sequence[torch.Tensor], mesh,
                     direction: int) -> List[torch.Tensor]:
  """The plain version of K3 in one process: shard (d, t) gets a copy of
  shard (d, t - direction), or zeros where that index leaves [0, n_time)."""
  out = []
  for i, x in enumerate(shards):
    t = mesh.coords(i)[1]
    if 0 <= t - direction < mesh.n_time:
      out.append(shards[i - direction].clone(
          memory_format=torch.contiguous_format))
    else:
      out.append(torch.zeros_like(x, memory_format=torch.contiguous_format))
  return out


def _device_type(x: torch.Tensor) -> str:
  return x.device.type


def _route(shards: Sequence[torch.Tensor], mesh) -> str:
  """'cpu' or 'cuda' for the shards; raises on a mix or a bad list."""
  if len(shards) != len(mesh.devices):
    raise ValueError('K3 takes one shard per mesh position of this process '
                     f'({len(mesh.devices)}), got {len(shards)}.')
  first = shards[0]
  for x in shards[1:]:
    if x.shape != first.shape or x.dtype != first.dtype:
      raise ValueError('K3 takes shards of one shape and dtype, got '
                       f'{tuple(first.shape)} {first.dtype} and '
                       f'{tuple(x.shape)} {x.dtype}.')
  kinds = {_device_type(x) for x in shards}
  if len(kinds) != 1 or not kinds <= {'cpu', 'cuda'}:
    raise ValueError('K3 takes shards all on the CPU or all on CUDA, got '
                     f'{sorted(kinds)}.')
  return kinds.pop()


def _rows_view(x: torch.Tensor) -> Optional[Tuple[int, int, int]]:
  """(rows, cols, row stride in elements) of x read as [rows, cols] with
  contiguous rows, or None if its strides do not allow that."""
  shape, stride = tuple(x.shape), x.stride()
  cols = shape[-1]
  if cols > 1 and stride[-1] != 1:
    return None
  lead = [(n, s) for n, s in zip(shape[:-1], stride[:-1]) if n > 1]
  if not lead:
    return 1, cols, cols
  row_stride = expected = lead[-1][1]
  for n, s in reversed(lead):
    if s != expected:
      return None
    expected = s * n
  return int(np.prod([n for n, _ in lead])), cols, row_stride


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    'ddsp_halo_shift': [_PTRS, _PTRS, ctypes.POINTER(ctypes.c_longlong)] +
                       [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p],
    'ddsp_halo_slot_alloc': [ctypes.c_longlong, _PTRS, ctypes.c_char_p],
    'ddsp_halo_slot_open': [ctypes.c_char_p, _PTRS],
    'ddsp_halo_slot_close': [ctypes.c_void_p],
    'ddsp_halo_slot_free': [ctypes.c_void_p],
    'ddsp_halo_remote': [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_uint, ctypes.c_uint, ctypes.c_ulonglong,
                         ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
}
IPC_HANDLE_BYTES = 64
# How long the remote copy waits for a neighbour before it raises. Ranks
# time-sliced on one card wait for whole timeslices, and a rank may reach a
# shift while its neighbour still runs host code before it.
REMOTE_TIMEOUT_S = 60.0
REMOTE_ERRORS = {
    1: 'waited past its bound for the neighbour to consume its slot',
    2: "waited past its bound for the neighbour's block",
    3: 'received the stamp of another call (the ranks made different K3 '
       'calls)',
}


def _launch(shards: Sequence[torch.Tensor], mesh,
            direction: int) -> List[torch.Tensor]:
  """One K3 launch over every shard, all on one CUDA device; the outputs
  are new contiguous tensors."""
  devices = {x.device for x in shards}
  if len(devices) != 1:
    raise NotImplementedError(
        f'K3 reads the shards of one process on one card, got '
        f'{sorted(map(str, devices))}; a mesh over several cards takes one '
        'rank per card (ROADMAP.md queue 1 item 8).')
  if mesh.size > MAX_SHARDS:
    raise ValueError(f'K3 takes at most {MAX_SHARDS} shards, not '
                     f'{mesh.size}.')
  dtype = shards[0].dtype
  if dtype not in ELEM_BYTES:
    raise TypeError(f'K3 takes float32 or bfloat16, not {dtype}.')
  views = []
  for x in shards:
    layout = _rows_view(x)
    if layout is None:
      x = x.contiguous()
      layout = _rows_view(x)
    views.append((x, layout))
  rows, cols, _ = views[0][1]
  fn = _build.load('halo', _SIGNATURES).ddsp_halo_shift
  dev = devices.pop()
  with torch.cuda.device(dev):
    out = [torch.empty(x.shape, dtype=dtype, device=dev) for x in shards]
    src = (ctypes.c_void_p * mesh.size)(*(x.data_ptr() for x, _ in views))
    dst = (ctypes.c_void_p * mesh.size)(*(y.data_ptr() for y in out))
    strides = (ctypes.c_longlong * mesh.size)(
        *(layout[2] for _, layout in views))
    stream = torch.cuda.current_stream().cuda_stream
    status = fn(src, dst, strides, mesh.n_data, mesh.n_time, direction, rows,
                cols, ELEM_BYTES[dtype], stream)
  _build.check(status, 'ddsp_halo_shift')
  launches['shift'] += 1
  return out


def _local(shards, mesh, direction):
  """The shift among one process's shards."""
  if _route(shards, mesh) == 'cpu':
    return halo_shift_plain(shards, mesh, direction)
  return _launch(shards, mesh, direction)


@dataclasses.dataclass
class _Edge:
  """A rank's remote part of one shift: it sends its edge shard `send` to
  rank `to`, and shard `recv` receives from rank `frm` (None: no such
  neighbour; shard `recv` then gets zeros)."""
  send: int
  to: Optional[int]
  recv: int
  frm: Optional[int]


def _edge(mesh, direction) -> _Edge:
  ranks = mesh.ranks
  n = len(mesh.devices)
  t_first = mesh.shard_coords(0)[1]
  t_last = t_first + n - 1
  ahead = t_last + 1 < mesh.n_time
  behind = t_first > 0
  if direction > 0:
    return _Edge(n - 1, ranks.rank + 1 if ahead else None, 0,
                 ranks.rank - 1 if behind else None)
  return _Edge(0, ranks.rank - 1 if behind else None, n - 1,
               ranks.rank + 1 if ahead else None)


def remote_shift_plain(block: torch.Tensor, to: Optional[int],
                       frm: Optional[int]) -> torch.Tensor:
  """The plain version of the remote copy: `block` sent to rank `to` and a
  block of its shape received from rank `frm` (zeros without one), by
  torch.distributed point-to-point operations on the default group."""
  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel.distributed import staged
  ops, received = [], None
  if to is not None:
    ops.append(dist.P2POp(dist.isend, staged(block.contiguous())[0], to))
  if frm is not None:
    received = staged(torch.empty(block.shape, dtype=block.dtype,
                                  device=block.device))[0]
    ops.append(dist.P2POp(dist.irecv, received, frm))
  if ops:
    for work in dist.batch_isend_irecv(ops):
      work.wait()
  if received is None:
    return torch.zeros(block.shape, dtype=block.dtype, device=block.device)
  return received.to(block.device)


@dataclasses.dataclass
class _Slot:
  """A receive slot of one byte size: this rank's allocation, its
  neighbours' mapped ones and how many shifts have used it."""
  own: int
  peers: Dict[int, int]
  uses: int = 0


# The receive slots of this process by (row's ranks, bytes), and each row's
# count of remote copies: state of the CUDA allocations behind them, which
# release_remote_slots frees.
_SLOTS: Dict[Tuple[Tuple[int, ...], int], _Slot] = {}
_CALLS: Dict[Tuple[int, ...], int] = {}


def _slot(mesh, nbytes: int) -> _Slot:
  """The row's slot of `nbytes`, made on first use: cudaMalloc'd, its IPC
  handle gathered over the row's ranks, the neighbours' mapped."""
  ranks = mesh.ranks
  key = (ranks.time_ranks, nbytes)
  if key in _SLOTS:
    return _SLOTS[key]
  lib = _build.load('halo', _SIGNATURES)
  own = ctypes.c_void_p()
  handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
  _build.check(lib.ddsp_halo_slot_alloc(nbytes, ctypes.byref(own), handle),
               'ddsp_halo_slot_alloc')
  handles = [None] * len(ranks.time_ranks)
  dist.all_gather_object(handles, handle.raw, group=ranks.time_group)
  peers = {}
  for peer in (ranks.rank - 1, ranks.rank + 1):
    if peer in ranks.time_ranks:
      ptr = ctypes.c_void_p()
      _build.check(lib.ddsp_halo_slot_open(
          handles[ranks.time_ranks.index(peer)], ctypes.byref(ptr)),
                   'ddsp_halo_slot_open')
      peers[peer] = ptr.value
  _SLOTS[key] = _Slot(own.value, peers)
  return _SLOTS[key]


def _launch_remote(block: torch.Tensor, mesh, edge: _Edge) -> torch.Tensor:
  """The remote copy: one launch that pushes `block` into rank edge.to's
  slot and returns what rank edge.frm pushed into this rank's (zeros
  without one). Synchronises its stream to read the kernel's error word."""
  dtype = block.dtype
  if dtype not in ELEM_BYTES:
    raise TypeError(f'K3 takes float32 or bfloat16, not {dtype}.')
  eb = ELEM_BYTES[dtype]
  layout = _rows_view(block)
  if layout is None:
    block = block.contiguous()
    layout = _rows_view(block)
  rows, cols, stride = layout
  if (cols * eb) % 16 == 0 and (block.data_ptr() % 16 or (stride * eb) % 16):
    # The 16-byte route follows the shape on both ends: align the source.
    block = block.contiguous()
    rows, cols, stride = _rows_view(block)
  nbytes = rows * cols * eb
  lib = _build.load('halo', _SIGNATURES)
  with torch.cuda.device(block.device):
    slot = _slot(mesh, nbytes)
    slot.uses += 1
    row = mesh.ranks.time_ranks
    _CALLS[row] = _CALLS.get(row, 0) + 1
    out = torch.empty(block.shape, dtype=dtype, device=block.device)
    error = ctypes.c_int(0)
    status = lib.ddsp_halo_remote(
        block.data_ptr() if edge.to is not None else None, stride,
        slot.peers.get(edge.to), out.data_ptr(), slot.own,
        int(edge.frm is not None), rows, cols, eb, slot.uses,
        _CALLS[row] & 0xffffffff, int(REMOTE_TIMEOUT_S * 1e9),
        torch.cuda.current_stream().cuda_stream, ctypes.byref(error))
  _build.check(status, 'ddsp_halo_remote')
  if error.value:
    raise RuntimeError(
        f'K3 remote copy (call {_CALLS[row]} of row {row}, use {slot.uses} '
        f'of its {nbytes}-byte slot, rank {mesh.ranks.rank}) '
        f'{REMOTE_ERRORS.get(error.value, f"failed ({error.value})")}.')
  launches['remote_shift'] += 1
  return out


def release_remote_slots() -> None:
  """Unmap the neighbours' slots and free this rank's (collective: every
  rank calls it, before the process group ends)."""
  lib = _build.load('halo', _SIGNATURES) if _SLOTS else None
  if _SLOTS:
    torch.cuda.synchronize()
  dist.barrier()  # no rank writes into a slot any more
  for slot in _SLOTS.values():
    for ptr in slot.peers.values():
      _build.check(lib.ddsp_halo_slot_close(ptr), 'ddsp_halo_slot_close')
  dist.barrier()  # every mapping of a slot is closed
  for slot in _SLOTS.values():
    _build.check(lib.ddsp_halo_slot_free(slot.own), 'ddsp_halo_slot_free')
  _SLOTS.clear()
  _CALLS.clear()


def _shift(shards, mesh, direction):
  if mesh.ranks is None:
    return _local(shards, mesh, direction)
  local = mesh.local_mesh()
  if mesh.ranks.time_group is None:
    return _local(shards, local, direction)
  out = _local(shards, local, direction) if len(shards) > 1 else [None]
  edge = _edge(mesh, direction)
  if _route(shards, local) == 'cpu':
    out[edge.recv] = remote_shift_plain(shards[edge.send], edge.to, edge.frm)
  else:
    out[edge.recv] = _launch_remote(shards[edge.send], mesh, edge)
  return out


class HaloShift(torch.autograd.Function):
  """K3 with its adjoint: apply(mesh, direction, *shards) -> shifted shards.

  The backward shifts the cotangents by -direction: the halo exchange
  transposes to the reverse exchange. A shard that needs no gradient (the
  target's halos) records no backward.
  """

  @staticmethod
  def forward(ctx, mesh, direction, *shards):
    ctx.mesh = mesh
    ctx.direction = direction
    ctx.likes = [(x.shape, x.dtype, x.device) for x in shards]
    return tuple(_shift(shards, mesh, direction))

  @staticmethod
  def backward(ctx, *grads):
    # autograd may hand over None or an expanded cotangent.
    grads = [torch.zeros(shape, dtype=dtype, device=device) if g is None
             else g.contiguous()
             for g, (shape, dtype, device) in zip(grads, ctx.likes)]
    return (None, None) + tuple(_shift(grads, ctx.mesh, -ctx.direction))
