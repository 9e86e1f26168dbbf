"""Kernel K3: the neighbour halo shift of a time-sharded mesh.

Wraps csrc/halo.cu, which replaces ddsp_tpu/parallel/pallas_halo.py:
_shift_kernel (reached through _shift). `HaloShift` is the
torch.autograd.Function around it: for a list of shards (one per mesh
position, row-major over ('data', 'time')), shard (d, t) receives the block
of shard (d, t - direction), and zeros where that falls off the end of the
time axis. Shifts by +1 and -1 are each other's adjoint, so the backward is
the same kernel in the opposite direction. CUDA shards launch the kernel in
both directions; CPU shards take the plain version (`halo_shift_plain`).

The Pallas kernel's collective-id pool (`reset_collective_id_counter`) and
its interpret-mode fallback to ppermute are Mosaic and simulator details
(barrier semaphores between chips, a CPU simulator limited to one mesh
axis); the CUDA kernel has no counterpart of either.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ddsp_torch.kernels import _build

# Kernel launches so far; a run reads it to show that its path went
# through K3.
launches: Dict[str, int] = {'shift': 0}

ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}
MAX_SHARDS = 64


def reset_launches() -> None:
  for key in launches:
    launches[key] = 0


def halo_shift_plain(shards: Sequence[torch.Tensor], mesh,
                     direction: int) -> List[torch.Tensor]:
  """The plain version of K3: shard (d, t) gets a copy of shard
  (d, t - direction), or zeros where that index leaves [0, n_time)."""
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
  if len(shards) != mesh.size:
    raise ValueError(f'K3 takes one shard per mesh position ({mesh.size}), '
                     f'got {len(shards)}.')
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
}


def _launch(shards: Sequence[torch.Tensor], mesh,
            direction: int) -> List[torch.Tensor]:
  """One K3 launch over every shard, all on one CUDA device; the outputs
  are new contiguous tensors."""
  devices = {x.device for x in shards}
  if len(devices) != 1:
    raise NotImplementedError(
        f'K3 reads shards on one card, got {sorted(map(str, devices))}; '
        'meshes over several cards come with ROADMAP.md queue 1 item 8.')
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


def _shift(shards, mesh, direction):
  if _route(shards, mesh) == 'cpu':
    return halo_shift_plain(shards, mesh, direction)
  return _launch(shards, mesh, direction)


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
