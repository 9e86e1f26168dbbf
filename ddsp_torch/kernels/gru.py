"""Kernel K2: the fused GRU sequence (forward), the whole recurrence in one launch.

Wraps csrc/gru.cu, which replaces ddsp_tpu/ops/pallas_kernels/gru.py:
_fwd_kernel. Beside it, `gru_sequence_plain` is the plain PyTorch version of
the same function (a Python loop of the same step in the same dtypes): the
CPU tests hold it against the JAX package, and chip_smoke.py holds the
kernel against it.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ddsp_torch.kernels import _build

# Kernel launches so far; a run reads it to show its path went through K2.
launches = 0


def stream_dtype(dtype: torch.dtype) -> torch.dtype:
  """bf16 xp selects bf16 streams and recurrent-dot operands; else float32."""
  return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def gru_sequence_plain(xp: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
                       h0: torch.Tensor) -> torch.Tensor:
  """Reset-after GRU over time-major xp [T, B, 3H]; returns ys [T, B, H] f32.

  In bf16 mode (bf16 xp) the recurrent dot takes bf16 h and wh with float32
  accumulation (exact bf16 products summed in float32); gates and carry are
  float32.
  """
  sdt = stream_dtype(xp.dtype)
  h_dim = wh.shape[0]
  wh = wh.to(sdt).float()
  bn = bn.float()
  h = h0.float()
  ys = []
  for t in range(xp.shape[0]):
    xp_t = xp[t].float()
    hp = h.to(sdt).float() @ wh
    r = torch.sigmoid(xp_t[:, :h_dim] + hp[:, :h_dim])
    z = torch.sigmoid(xp_t[:, h_dim:2 * h_dim] + hp[:, h_dim:2 * h_dim])
    n = torch.tanh(xp_t[:, 2 * h_dim:] + r * (hp[:, 2 * h_dim:] + bn))
    h = (1.0 - z) * n + z * h
    ys.append(h)
  return torch.stack(ys, dim=0)


def _check(xp, wh, bn, h0):
  if xp.ndim != 3 or wh.ndim != 2 or wh.shape[1] != 3 * wh.shape[0]:
    raise ValueError(f'K2 takes xp [T, B, 3H] and wh [H, 3H]; got '
                     f'{tuple(xp.shape)}, {tuple(wh.shape)}.')
  seq_len, batch, three_h = xp.shape
  h_dim = wh.shape[0]
  if three_h != 3 * h_dim or tuple(bn.shape) != (h_dim,) or tuple(
      h0.shape) != (batch, h_dim):
    raise ValueError(f'K2 shapes disagree: xp {tuple(xp.shape)}, wh '
                     f'{tuple(wh.shape)}, bn {tuple(bn.shape)}, h0 '
                     f'{tuple(h0.shape)}.')
  if seq_len < 1:
    raise ValueError('K2 needs at least one timestep.')
  if xp.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'K2 takes float32 or bfloat16 xp, not {xp.dtype}.')
  for name, t in (('wh', wh), ('bn', bn), ('h0', h0)):
    if t.device != xp.device:
      raise ValueError(f'{name} is on {t.device}, xp on {xp.device}.')


_SIGNATURES = {
    'ddsp_gru_occupancy': [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)] * 2,
    'ddsp_gru_fwd': [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p],
}

# Chosen u per (device index, H, B, bf16): it depends on nothing else.
_UNITS_PER_BLOCK: Dict[Tuple[int, int, int, bool], int] = {}


def _lib():
  return _build.load('gru', _SIGNATURES)


def pick_units_per_block(device: torch.device, hidden: int, batch: int,
                         bf16: bool) -> int:
  """Smallest u dividing H whose H/u blocks fit one per SM, co-resident.

  One block per SM gives each block the whole SM and keeps the number of
  barrier arrivals per step low. Raises if no u gives a co-resident grid.
  The occupancy queries run once per (device, H, B, dtype); call it with
  `device` current.
  """
  key = (device.index, hidden, batch, bf16)
  if key in _UNITS_PER_BLOCK:
    return _UNITS_PER_BLOCK[key]
  lib = _lib()
  for u in range(1, hidden + 1):
    if hidden % u:
      continue
    per_sm, n_sms = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib.ddsp_gru_occupancy(hidden, batch, u, int(bf16),
                                        ctypes.byref(per_sm),
                                        ctypes.byref(n_sms)),
                 'ddsp_gru_occupancy')
    n_blocks = hidden // u
    if n_blocks <= n_sms.value and per_sm.value >= 1:
      _UNITS_PER_BLOCK[key] = u
      return u
  raise RuntimeError(f'K2 cannot make a co-resident grid for H={hidden}, '
                     f'B={batch}: the shared-memory slice does not fit.')


def _launch(xp, wh, bn, h0):
  global launches
  lib = _lib()
  seq_len, batch, _ = xp.shape
  h_dim = wh.shape[0]
  bf16 = xp.dtype == torch.bfloat16
  xp = xp.contiguous()
  wh = wh.to(xp.dtype).contiguous()
  bn = bn.float().contiguous()
  h0 = h0.float().contiguous()
  with torch.cuda.device(xp.device):
    u = pick_units_per_block(xp.device, h_dim, batch, bf16)
    ys = torch.empty((seq_len, batch, h_dim), dtype=torch.float32,
                     device=xp.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=xp.device)
    stream = torch.cuda.current_stream().cuda_stream
    status = lib.ddsp_gru_fwd(xp.data_ptr(), wh.data_ptr(), bn.data_ptr(),
                              h0.data_ptr(), ys.data_ptr(),
                              barrier.data_ptr(), seq_len, batch, h_dim, u,
                              int(bf16), stream)
  _build.check(status, 'ddsp_gru_fwd')
  launches += 1
  return ys


def gru_sequence(xp: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
  """Run the whole GRU recurrence.

  Args:
    xp: Hoisted input projections incl. bias, time-major [T, B, 3H]
      ([reset, update, candidate] gate order), float32 or bfloat16 (bf16
      selects bf16 recurrent-dot operands with float32 accumulation).
    wh: Recurrent weights [H, 3H] (cast to xp's dtype).
    bn: Candidate recurrent bias [H].
    h0: Initial hidden state [B, H].

  Returns:
    ys [T, B, H] float32. A CUDA input launches K2; a CPU input takes the
    plain version.
  """
  _check(xp, wh, bn, h0)
  if xp.device.type == 'cpu':
    return gru_sequence_plain(xp, wh, bn, h0)
  if xp.device.type != 'cuda':
    raise ValueError(f'K2 runs on CUDA or the CPU, not {xp.device}.')
  return _launch(xp, wh, bn, h0)
