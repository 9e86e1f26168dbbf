"""Kernel K3: the neighbour halo shift of a time-sharded mesh.

Wraps csrc/halo.cu, which replaces ddsp_tpu/parallel/pallas_halo.py:
_shift_kernel (reached through _shift). `HaloShift` is the
torch.autograd.Function around it: for a list of shards (this process's
run of the mesh, row-major over ('data', 'time'); parallel/distributed.py
Run), shard (d, t) receives the block of shard (d, t - direction), and
zeros where that falls off the end of the time axis. Shifts by +1 and -1
are each other's adjoint, so the backward is the same kernel in the
opposite direction.

Shards of one process launch `ddsp_halo_shift` (counted as 'shift'), with
the run's first time position: a rank's run may start and end inside a
data row. On a mesh over ranks a rank's first and last shards may have
their neighbours in other processes, the ranks before and after it
(distributed.Ranks.neighbours, in one data row or two): those blocks go
through the remote copy, `ddsp_halo_remote` (counted as 'remote_shift'),
which pushes the edge block into the neighbour's receive slot, mapped with
CUDA IPC, and copies out its own slot once the neighbour's stamp is there.
The waits are on the stream: a launch returns at once and nothing
synchronises. Every rank of the mesh makes the same K3 calls in the same
order, forward and backward, as the JAX package's collective-id pool
arranges for its barriers; the stamp of each slot's use, call and
direction makes a mismatch a fault instead of stale data. The kernels
write a fault into pinned host memory, which each launch reads without
waiting; `check` waits for the stream with a deadline and raises on a
fault or at the deadline. The places where the host waits anyway call it
(parallel/distributed.py re-exports it). CPU shards take the plain
versions: `halo_shift_plain` in a process, `remote_shift_plain`
(torch.distributed point-to-point sends, the yardstick on the card)
between ranks.

The Pallas kernel's interpret-mode fallback to ppermute is a simulator
detail with no counterpart here.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

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


def halo_shift_plain(shards: Sequence[torch.Tensor], run,
                     direction: int) -> List[torch.Tensor]:
  """The plain version of K3 in one process: the run's shard (d, t) (a
  distributed.Run: a whole mesh, or a rank's shards) gets a copy of shard
  (d, t - direction), or zeros where that index leaves [0, n_time) or the
  run."""
  out = []
  for j, x in enumerate(shards):
    t = run.coords(j)[1]
    if 0 <= t - direction < run.n_time and 0 <= j - direction < len(shards):
      out.append(shards[j - direction].clone(
          memory_format=torch.contiguous_format))
    else:
      out.append(torch.zeros_like(x, memory_format=torch.contiguous_format))
  return out


def _device_type(x: torch.Tensor) -> str:
  return x.device.type


def _route(shards: Sequence[torch.Tensor], run) -> str:
  """'cpu' or 'cuda' for the shards; raises on a mix or a bad list."""
  if len(shards) != run.count:
    raise ValueError('K3 takes one shard per mesh position of this process '
                     f'({run.count}), got {len(shards)}.')
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
  return math.prod(n for n, _ in lead), cols, row_stride


_PTRS = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    'ddsp_halo_shift': [_PTRS, _PTRS, ctypes.POINTER(ctypes.c_longlong)] +
                       [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p],
    'ddsp_halo_slot_alloc': [ctypes.c_longlong, _PTRS, ctypes.c_char_p],
    'ddsp_halo_slot_open': [ctypes.c_char_p, _PTRS],
    'ddsp_halo_slot_close': [ctypes.c_void_p],
    'ddsp_halo_slot_free': [ctypes.c_void_p],
    'ddsp_halo_remote': [ctypes.c_void_p, ctypes.c_longlong] +
                        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 +
                        [ctypes.c_longlong, ctypes.c_int] +
                        [ctypes.c_uint] * 4 + [ctypes.c_void_p],
    'ddsp_halo_fault_block': [_PTRS],
}
IPC_HANDLE_BYTES = 64
# How long `check` waits for the stream of the remote copies before it
# raises. Ranks time-sliced on one card wait for whole timeslices, and a
# rank may reach a shift while its neighbour still runs host code before
# it.
REMOTE_TIMEOUT_S = 60.0
REMOTE_ERRORS = {
    1: 'did not see the neighbour consume its slot',
    2: "did not receive the neighbour's block",
    3: 'received the stamp of another call (the ranks made different K3 '
       'calls)',
}


class FaultBlock(ctypes.Structure):
  """csrc/halo.cu's FaultBlock, in pinned host memory mapped into the
  device: the first fault's code (written last), the launch's tag, call and
  use, the stamp seen, and the last tags whose push and copy-out passed
  their waits."""
  _fields_ = [('code', ctypes.c_uint32), ('tag', ctypes.c_uint32),
              ('call', ctypes.c_uint32), ('use', ctypes.c_uint32),
              ('seen', ctypes.c_uint64), ('pushed', ctypes.c_uint32),
              ('copied', ctypes.c_uint32)]


def _launch(shards: Sequence[torch.Tensor], run,
            direction: int) -> List[torch.Tensor]:
  """One K3 launch over every shard of the run, all on one CUDA device;
  the outputs are new contiguous tensors."""
  devices = {x.device for x in shards}
  if len(devices) != 1:
    raise NotImplementedError(
        f'K3 reads the shards of one process on one card, got '
        f'{sorted(map(str, devices))}; a mesh over several cards takes one '
        'rank per card (ROADMAP.md queue 1 item 8).')
  if run.count > MAX_SHARDS:
    raise ValueError(f'K3 takes at most {MAX_SHARDS} shards, not '
                     f'{run.count}.')
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
    src = (ctypes.c_void_p * run.count)(*(x.data_ptr() for x, _ in views))
    dst = (ctypes.c_void_p * run.count)(*(y.data_ptr() for y in out))
    strides = (ctypes.c_longlong * run.count)(
        *(layout[2] for _, layout in views))
    stream = torch.cuda.current_stream().cuda_stream
    status = fn(src, dst, strides, run.count, run.n_time, run.coords(0)[1],
                direction, rows, cols, ELEM_BYTES[dtype], stream)
  _build.check(status, 'ddsp_halo_shift')
  launches['shift'] += 1
  return out


def _local(shards, run, direction):
  """The shift among one process's shards."""
  if _route(shards, run) == 'cpu':
    return halo_shift_plain(shards, run, direction)
  return _launch(shards, run, direction)


@dataclasses.dataclass
class _Edge:
  """A rank's remote part of one shift by `direction`: it sends its edge
  shard `send` to rank `to`, and shard `recv` receives from rank `frm`
  (None: no such neighbour; shard `recv` then gets zeros)."""
  send: int
  to: Optional[int]
  recv: int
  frm: Optional[int]
  direction: int = 1


def _edge(mesh, direction) -> _Edge:
  """The remote part of a rank's shift: its run's last shard goes to the
  rank after it and its first receives from the rank before it (+1), or
  the other way round (-1)."""
  left, right = mesh.ranks.neighbours
  n = mesh.ranks.per_rank
  if direction > 0:
    return _Edge(n - 1, right, 0, left, 1)
  return _Edge(0, left, n - 1, right, -1)


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


@dataclasses.dataclass
class _Launch:
  """A remote copy enqueued and not yet known to have passed its waits."""
  tag: int
  call: int
  scope: str
  rank: int
  use: int
  nbytes: int
  pushes: bool
  stream: object

  def __str__(self):
    return (f'K3 remote copy (call {self.call} of the {self.scope}, use '
            f'{self.use} of its {self.nbytes}-byte slot, rank {self.rank})')


# The receive slots of this process by (mesh, bytes), each mesh's count of
# remote copies, and the launches in flight by tag: state of the CUDA
# allocations behind them, which release_remote_slots frees. A mesh is
# named by its shape: within one process group the shape fixes every
# rank's run and neighbours, and every rank makes the same calls on it.
_SLOTS: Dict[Tuple[str, int], _Slot] = {}
_CALLS: Dict[str, int] = {}
_PENDING: 'collections.OrderedDict[int, _Launch]' = collections.OrderedDict()
_TAG = 0  # the last launch's
_FAULT: Optional[FaultBlock] = None  # the process's fault block, once mapped
_FAULTS_REPORTED = 0  # csrc/halo.cu's fault_gen
LOOPBACK = 'loopback'


def _scope(ranks) -> str:
  return f'({ranks.n_data} x {ranks.n_time}) mesh'


def _slot(mesh, nbytes: int) -> _Slot:
  """The mesh's slot of `nbytes`, made on first use: cudaMalloc'd, its
  IPC handle gathered over every rank (each rank of a mesh whose runs do
  not hold whole rows makes it, since each has a neighbour), the
  neighbours' mapped."""
  ranks = mesh.ranks
  key = (_scope(ranks), nbytes)
  if key in _SLOTS:
    return _SLOTS[key]
  lib = _build.load('halo', _SIGNATURES)
  own = ctypes.c_void_p()
  handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
  _build.check(lib.ddsp_halo_slot_alloc(nbytes, ctypes.byref(own), handle),
               'ddsp_halo_slot_alloc')
  handles = [None] * ranks.n_ranks
  dist.all_gather_object(handles, handle.raw)
  peers = {}
  for peer in ranks.neighbours:
    if peer is not None:
      ptr = ctypes.c_void_p()
      _build.check(lib.ddsp_halo_slot_open(handles[peer], ctypes.byref(ptr)),
                   'ddsp_halo_slot_open')
      peers[peer] = ptr.value
  _SLOTS[key] = _Slot(own.value, peers)
  return _SLOTS[key]


def _before(a: int, b: int) -> bool:
  """Tag a comes before tag b (32-bit tags that wrap)."""
  return 0 < (b - a) % 2**32 < 2**31


def _map_fault_block(lib) -> None:
  global _FAULT
  if _FAULT is None:
    ptr = ctypes.c_void_p()
    _build.check(lib.ddsp_halo_fault_block(ctypes.byref(ptr)),
                 'ddsp_halo_fault_block')
    _FAULT = FaultBlock.from_address(ptr.value)


def _raise_fault() -> None:
  """Raise on a fault the kernels wrote, without waiting; otherwise drop
  the launches whose copy-out has passed its wait."""
  global _FAULTS_REPORTED
  fault = _FAULT
  if fault is None:
    return
  code = fault.code
  if code:
    launch = _PENDING.get(fault.tag)
    what = (str(launch) if launch is not None else
            f'K3 remote copy (call {fault.call}, use {fault.use})')
    seen = fault.seen
    found = (f'the neighbour had consumed use {seen}' if code == 1 else
             f'the stamp seen: use {seen >> 32}, call '
             f'{(seen & 0xffffffff) >> 1}, direction '
             f'{"+1" if seen & 1 else "-1"}')
    # Cleared before the count moves on, so no fault of a later launch is
    # lost; nothing on the device is reset.
    fault.code = 0
    _FAULTS_REPORTED += 1
    _PENDING.clear()
    raise RuntimeError(
        f'{what} {REMOTE_ERRORS.get(code, f"failed ({code})")} ({found}).')
  copied = fault.copied
  while _PENDING:
    tag = next(iter(_PENDING))
    if not (tag == copied or _before(tag, copied)):
      break
    del _PENDING[tag]


def _record_event(stream):
  event = torch.cuda.Event()
  event.record(stream)
  return event


def _stalled(last: _Launch) -> RuntimeError:
  """The error of a wait past REMOTE_TIMEOUT_S: the first launch in flight
  whose push or copy-out has not passed its wait, from the tags the kernels
  wrote, and the last call launched."""
  for launch in _PENDING.values():
    if launch.pushes and _before(_FAULT.pushed, launch.tag):
      code = 1
    elif _before(_FAULT.copied, launch.tag):
      code = 2
    else:
      continue
    return RuntimeError(
        f'{launch} {REMOTE_ERRORS[code]} within {REMOTE_TIMEOUT_S} s; the '
        f'last call launched: {last}.')
  return RuntimeError(
      f'The stream of the K3 remote copies did not finish within '
      f'{REMOTE_TIMEOUT_S} s; the last call launched: {last}.')


def check() -> None:
  """Raise if a remote copy of this process has faulted or its stream has
  not finished within REMOTE_TIMEOUT_S.

  Waits for the streams of the launches in flight by polling an event (no
  stream synchronisation), so a wait for a neighbour that never comes ends
  in an error that names the call. Costs nothing where no remote copy was
  launched. The places where the host waits for the device anyway call it
  first: the gloo staging of a collective, the training loop's loss read
  and synchronisation, Trainer.save, the eval batch's gather,
  release_remote_slots.
  """
  _raise_fault()
  if not _PENDING:
    return
  last = next(reversed(_PENDING.values()))
  streams = {id(launch.stream): launch.stream
             for launch in _PENDING.values()}
  events = [_record_event(stream) for stream in streams.values()]
  start = time.monotonic()
  while not all(event.query() for event in events):
    waited = time.monotonic() - start
    if waited > REMOTE_TIMEOUT_S:
      _raise_fault()
      raise _stalled(last)
    time.sleep(0 if waited < 1e-3 else 1e-4)
  _raise_fault()
  _PENDING.clear()


def _device(device):
  return torch.cuda.device(device)


def _current_stream(device):
  return torch.cuda.current_stream(device)


def _enqueue(block: torch.Tensor, layout: Tuple[int, int, int],
             slot: _Slot, left: Optional[int], right: Optional[int],
             sends: bool, receives: bool, direction: int, scope: str,
             rank: int) -> torch.Tensor:
  """One remote copy on the current stream: `block` ([rows, cols] with
  row stride `stride`: `layout`) pushed into the neighbour on
  `direction`'s side (when `sends`), and the output, the own slot's block
  (when `receives`) or zeros. Reads the fault block first and raises on a
  fault; synchronises nothing."""
  global _TAG
  dtype = block.dtype
  eb = ELEM_BYTES[dtype]
  rows, cols, stride = layout
  lib = _build.load('halo', _SIGNATURES)
  _map_fault_block(lib)
  _raise_fault()
  slot.uses += 1
  _CALLS[scope] = _CALLS.get(scope, 0) + 1
  _TAG = _TAG % 0xffffffff + 1
  out = torch.empty(block.shape, dtype=dtype, device=block.device)
  stream = _current_stream(block.device)
  launch = _Launch(_TAG, _CALLS[scope], scope, rank, slot.uses,
                   rows * cols * eb, sends, stream)
  status = lib.ddsp_halo_remote(
      block.data_ptr() if sends else None, stride, left, right,
      out.data_ptr(), slot.own, int(receives), direction, rows, cols, eb,
      slot.uses, _CALLS[scope] & 0xffffffff, launch.tag,
      _FAULTS_REPORTED & 0xffffffff, stream.cuda_stream)
  _build.check(status, f'ddsp_halo_remote ({launch})')
  _PENDING[launch.tag] = launch
  launches['remote_shift'] += 1
  return out


def _aligned(block: torch.Tensor):
  """(block, its layout), or a contiguous copy's where the layout does not
  suit the remote copy: rows must be contiguous, and the 16-byte route
  (which follows the shape on both ends) needs an aligned source."""
  if block.dtype not in ELEM_BYTES:
    raise TypeError(f'K3 takes float32 or bfloat16, not {block.dtype}.')
  layout = _rows_view(block)
  if layout is not None:
    _, cols, stride = layout
    eb = ELEM_BYTES[block.dtype]
    if not ((cols * eb) % 16 == 0 and
            (block.data_ptr() % 16 or (stride * eb) % 16)):
      return block, layout
  block = block.contiguous()
  return block, _rows_view(block)


def _launch_remote(block: torch.Tensor, mesh, edge: _Edge) -> torch.Tensor:
  """The remote copy: pushes `block` into rank edge.to's slot and returns
  what rank edge.frm pushed into this rank's (zeros without one). The
  launch is enqueued on the current stream and returns at once: it reads
  the fault block without waiting, and a fault or a neighbour that never
  comes raises at the next `check`."""
  block, layout = _aligned(block)
  ranks = mesh.ranks
  left, right = ranks.neighbours
  nbytes = block.numel() * ELEM_BYTES[block.dtype]
  with _device(block.device):
    slot = _slot(mesh, nbytes)
    return _enqueue(block, layout, slot, slot.peers.get(left),
                    slot.peers.get(right), edge.to is not None,
                    edge.frm is not None, edge.direction, _scope(ranks),
                    ranks.rank)


def loopback_shift(block: torch.Tensor,
                   direction: int = 1) -> torch.Tensor:
  """The remote copy with this process's own slot as its neighbour on both
  sides: the block is pushed, stamped, waited for and copied out on one
  context, with no other process to wait for (the kernels' own device time
  against their bound). Returns the block's copy. Outside the main path:
  a measurement of the card."""
  block, layout = _aligned(block)
  nbytes = block.numel() * ELEM_BYTES[block.dtype]
  key = (LOOPBACK, nbytes)
  with _device(block.device):
    if key not in _SLOTS:
      lib = _build.load('halo', _SIGNATURES)
      own = ctypes.c_void_p()
      handle = ctypes.create_string_buffer(IPC_HANDLE_BYTES)
      _build.check(lib.ddsp_halo_slot_alloc(nbytes, ctypes.byref(own),
                                            handle), 'ddsp_halo_slot_alloc')
      _SLOTS[key] = _Slot(own.value, {})
    slot = _SLOTS[key]
    return _enqueue(block, layout, slot, slot.own, slot.own, True, True,
                    direction, LOOPBACK, 0)


def release_remote_slots() -> None:
  """Wait for the remote copies (`check`), then unmap the neighbours' slots
  and free this process's (collective where a process group exists: every
  rank calls it, before the group ends)."""
  lib = _build.load('halo', _SIGNATURES) if _SLOTS else None
  check()
  grouped = dist.is_available() and dist.is_initialized()
  if grouped:
    dist.barrier()  # no rank writes into a slot any more
  for slot in _SLOTS.values():
    for ptr in slot.peers.values():
      _build.check(lib.ddsp_halo_slot_close(ptr), 'ddsp_halo_slot_close')
  if grouped:
    dist.barrier()  # every mapping of a slot is closed
  for slot in _SLOTS.values():
    _build.check(lib.ddsp_halo_slot_free(slot.own), 'ddsp_halo_slot_free')
  _SLOTS.clear()
  _CALLS.clear()


def _shift(shards, mesh, direction):
  run = mesh.run
  if mesh.ranks is None or not mesh.ranks.shares_rows:
    return _local(shards, run, direction)
  out = _local(shards, run, direction) if len(shards) > 1 else [None]
  edge = _edge(mesh, direction)
  if _route(shards, run) == 'cpu':
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
