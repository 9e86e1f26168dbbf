"""Kernel family K2: the fused GRU sequence, the whole recurrence in one
launch each way.

Wraps csrc/gru.cu, which replaces ddsp_tpu/ops/pallas_kernels/gru.py:
_fwd_kernel (K2f) and _bwd_kernel (K2b). `GruSequence` is the
torch.autograd.Function around them: a CUDA tensor launches the kernels in
both directions, a CPU tensor takes the plain PyTorch versions beside them
(`gru_sequence_plain`, `gru_bwd_plain`: Python loops of the same steps in
the same dtypes). The CPU tests hold the plain versions against the JAX
package, and chip_smoke.py holds each kernel against its plain version.

With bf16 streams (the main path) the kernels run one thread-block cluster
per tile of TILE_ROWS batch rows, on tensor cores, and K2b is two kernels:
the serial reverse-time pass (a), whose plain version is
`gru_bwd_serial_plain`, and the weight-gradient pass (b), `gru_wgrad_plain`.
float32 streams keep one cooperative kernel each way.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ddsp_torch.kernels import _build

# Kernel launches so far, per kernel; a run reads them to show which
# kernels its path went through.
# 'bwd' counts K2b calls, 'wgrad' its weight-gradient pass (bf16 only).
launches: Dict[str, int] = {'fwd': 0, 'bwd': 0, 'wgrad': 0}

# The bf16 kernels: one cluster per tile of TILE_ROWS batch rows, u =
# UNITS_PER_CTA hidden units per CTA, so H / u CTAs per cluster; they take
# these H (csrc/gru.cu: H a multiple of 64, at most 16 CTAs per cluster).
TILE_ROWS = 16
UNITS_PER_CTA = 32
CLUSTER_HIDDEN = (64, 128, 256, 512)


def reset_launches() -> None:
  for key in launches:
    launches[key] = 0


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


def h_prev_stream(h0: torch.Tensor, ys: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
  """[h0, ys[:-1]] at the stream dtype, [T, B, H]: what each step started
  from. In bf16 mode only the (h_prev - n) term of the backward sees the
  rounding; both recurrent products cast h to bf16 anyway."""
  return torch.cat([h0.to(dtype)[None], ys[:-1].to(dtype)], dim=0)


def gru_bwd_plain(g: torch.Tensor, xp: torch.Tensor, h_prev: torch.Tensor,
                  wh: torch.Tensor, bn: torch.Tensor):
  """Reverse-time backward of the GRU sequence: the plain version of K2b.

  Args:
    g: Cotangent of ys, [T, B, H] float32.
    xp: [T, B, 3H] at the stream dtype (float32 or bfloat16).
    h_prev: `h_prev_stream`, [T, B, H] at the stream dtype.
    wh: [H, 3H] (cast to the stream dtype); bn: [H].

  Returns:
    dxp [T, B, 3H] at xp's dtype; dwh [H, 3H], dbn [H], dh0 [B, H] float32.
    The recurrent products take operands at the stream dtype (dhp rounded
    to it) with float32 accumulation; gates and carries are float32.
  """
  sdt = stream_dtype(xp.dtype)
  h_dim = wh.shape[0]
  wh = wh.to(sdt).float()
  bn = bn.float()
  dh = torch.zeros_like(h_prev[0], dtype=torch.float32)
  dwh = torch.zeros_like(wh)
  dbn = torch.zeros_like(bn)
  dxp = torch.empty_like(xp)
  for t in reversed(range(xp.shape[0])):
    xp_t = xp[t].float()
    hp_t = h_prev[t].float()
    hp = hp_t @ wh
    hpn = hp[:, 2 * h_dim:] + bn
    r = torch.sigmoid(xp_t[:, :h_dim] + hp[:, :h_dim])
    z = torch.sigmoid(xp_t[:, h_dim:2 * h_dim] + hp[:, h_dim:2 * h_dim])
    n = torch.tanh(xp_t[:, 2 * h_dim:] + r * hpn)
    dht = dh + g[t]
    dn_pre = dht * (1.0 - z) * (1.0 - n * n)
    dz = dht * (hp_t - n) * z * (1.0 - z)
    dr_pre = dn_pre * hpn * r * (1.0 - r)
    dhn = dn_pre * r
    dxp[t] = torch.cat([dr_pre, dz, dn_pre], dim=1).to(xp.dtype)
    dhp = torch.cat([dr_pre, dz, dhn], dim=1).to(sdt).float()
    dh = dht * z + dhp @ wh.t()
    dwh += hp_t.t() @ dhp
    dbn += dhn.sum(dim=0)
  return dxp, dwh, dbn, dh


def batch_tiles(batch: int) -> int:
  """Clusters the bf16 kernels launch for a batch: ceil(B / TILE_ROWS)."""
  return -(-batch // TILE_ROWS)


def cluster_shape(hidden: int) -> Tuple[int, int]:
  """(CTAs per cluster, hidden units per CTA) of the bf16 kernels at H."""
  if hidden not in CLUSTER_HIDDEN:
    raise ValueError(
        f'K2 with bf16 streams takes H in {CLUSTER_HIDDEN}, not H={hidden}: '
        f'each CTA of a cluster owns {UNITS_PER_CTA} hidden units, the '
        'tensor-core product splits H four ways in steps of 16, and a '
        'cluster holds at most 16 CTAs.')
  return hidden // UNITS_PER_CTA, UNITS_PER_CTA


def gru_bwd_serial_plain(g: torch.Tensor, xp: torch.Tensor,
                         h_prev: torch.Tensor, wh: torch.Tensor,
                         bn: torch.Tensor):
  """The serial pass of K2b (a): `gru_bwd_plain` without dwh and dbn.

  Returns dxp [T, B, 3H] and the dhn stream [T, B, H] at xp's dtype (dhp is
  [dxp_r, dxp_z, dhn]), per-tile float32 sums of dhn [batch_tiles(B), H]
  (the tiles' rows summed over time, in the kernel's tiling) and dh0
  [B, H] float32.
  """
  sdt = stream_dtype(xp.dtype)
  seq_len, batch, _ = xp.shape
  h_dim = wh.shape[0]
  wh = wh.to(sdt).float()
  bn = bn.float()
  n_tiles = batch_tiles(batch)
  dh = torch.zeros_like(h_prev[0], dtype=torch.float32)
  dxp = torch.empty_like(xp)
  dhn_stream = torch.empty((seq_len, batch, h_dim), dtype=xp.dtype,
                           device=xp.device)
  dhn_rows = torch.zeros((n_tiles * TILE_ROWS, h_dim), device=xp.device)
  for t in reversed(range(seq_len)):
    xp_t = xp[t].float()
    hp_t = h_prev[t].float()
    hp = hp_t @ wh
    hpn = hp[:, 2 * h_dim:] + bn
    r = torch.sigmoid(xp_t[:, :h_dim] + hp[:, :h_dim])
    z = torch.sigmoid(xp_t[:, h_dim:2 * h_dim] + hp[:, h_dim:2 * h_dim])
    n = torch.tanh(xp_t[:, 2 * h_dim:] + r * hpn)
    dht = dh + g[t]
    dn_pre = dht * (1.0 - z) * (1.0 - n * n)
    dz = dht * (hp_t - n) * z * (1.0 - z)
    dr_pre = dn_pre * hpn * r * (1.0 - r)
    dhn = dn_pre * r
    dxp[t] = torch.cat([dr_pre, dz, dn_pre], dim=1).to(xp.dtype)
    dhn_stream[t] = dhn.to(xp.dtype)
    dhp = torch.cat([dr_pre, dz, dhn], dim=1).to(sdt).float()
    dh = dht * z + dhp @ wh.t()
    dhn_rows[:batch] += dhn
  dbn_tiles = dhn_rows.view(n_tiles, TILE_ROWS, h_dim).sum(dim=1)
  return dxp, dhn_stream, dbn_tiles, dh


def gru_wgrad_plain(h_prev: torch.Tensor, dxp: torch.Tensor,
                    dhn: torch.Tensor, dbn_tiles: torch.Tensor):
  """The weight-gradient pass of K2b (b): dwh [H, 3H] = h_prev^T dhp over
  the T * B rows, dhp = [dxp_r, dxp_z, dhn] at the stream dtype (exact
  products, float32 sums), and dbn [H] = the tiles' dhn sums added up."""
  h_dim = h_prev.shape[-1]
  hp = h_prev.reshape(-1, h_dim).float()
  dhp = torch.cat([dxp[..., :2 * h_dim], dhn], dim=-1).reshape(
      -1, 3 * h_dim).float()
  return hp.t() @ dhp, dbn_tiles.sum(dim=0)


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


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIGNATURES = {
    'ddsp_gru_occupancy': [_INT] * 4 + [ctypes.POINTER(_INT)] * 2,
    'ddsp_gru_fwd': [_PTR] * 6 + [_INT] * 4 + [_PTR],
    'ddsp_gru_bwd': [_PTR] * 11 + [_INT] * 4 + [_PTR],
    'ddsp_gru_cluster_query': [_INT] * 2 + [ctypes.POINTER(_INT)] * 4,
    'ddsp_gru_cluster_fwd': [_PTR] * 5 + [_INT] * 3 + [_PTR],
    'ddsp_gru_cluster_bwd': [_PTR] * 9 + [_INT] * 3 + [_PTR],
    'ddsp_gru_wgrad': [_PTR] * 6 + [_INT] * 3 + [_PTR],
}

# Chosen u per (device index, H, B, backward) of the float32 kernels, and
# the cluster of the bf16 kernels per (device index, H, backward): each
# depends on nothing else.
_UNITS_PER_BLOCK: Dict[Tuple[int, int, int, bool], int] = {}
_CLUSTERS: Dict[Tuple[int, int, bool], Dict[str, int]] = {}


def _lib():
  return _build.load('gru', _SIGNATURES)


def pick_units_per_block(device: torch.device, hidden: int, batch: int,
                         backward: bool = False) -> int:
  """float32 kernels: the smallest u dividing H whose H/u blocks fit one per
  SM, co-resident.

  One block per SM gives each block the whole SM and keeps the number of
  barrier arrivals per step low. Raises if no u gives a co-resident grid
  (the kernels hold their slices of wh in shared memory, which bounds H).
  The occupancy queries run once per (device, H, B, direction); call it
  with `device` current.
  """
  key = (device.index, hidden, batch, backward)
  if key in _UNITS_PER_BLOCK:
    return _UNITS_PER_BLOCK[key]
  lib = _lib()
  for u in range(1, hidden + 1):
    if hidden % u:
      continue
    per_sm, n_sms = _INT(0), _INT(0)
    status = lib.ddsp_gru_occupancy(hidden, batch, u, int(backward),
                                    ctypes.byref(per_sm), ctypes.byref(n_sms))
    # A slice too large for an SM's shared memory is refused here, and a
    # wider u only grows it.
    if status != 0 or per_sm.value < 1:
      break
    if hidden // u <= n_sms.value:
      _UNITS_PER_BLOCK[key] = u
      return u
  which = 'K2b' if backward else 'K2f'
  raise RuntimeError(f'{which} (float32) cannot make a co-resident grid for '
                     f'H={hidden}, B={batch}: its shared-memory slice of wh '
                     'does not fit one SM.')


def pick_cluster(device: torch.device, hidden: int,
                 backward: bool = False) -> Dict[str, int]:
  """bf16 kernels: the cluster for H and how many the device holds at once.

  Returns {'cluster': CTAs per cluster, 'units': hidden units per CTA,
  'max_active_clusters': from cudaOccupancyMaxActiveClusters, 'smem_bytes':
  dynamic shared memory per CTA}. Raises ValueError for an H the kernels
  do not take and RuntimeError when no such cluster fits the device.
  Queried once per (device, H, direction); call it with `device` current.
  """
  cluster_shape(hidden)
  key = (device.index, hidden, backward)
  if key not in _CLUSTERS:
    out = [_INT(0) for _ in range(4)]
    status = _lib().ddsp_gru_cluster_query(hidden, int(backward),
                                           *(ctypes.byref(v) for v in out))
    _build.check(status, 'ddsp_gru_cluster_query')
    info = dict(zip(('cluster', 'units', 'max_active_clusters',
                     'smem_bytes'), (v.value for v in out)))
    if info['max_active_clusters'] < 1:
      which = 'K2b' if backward else 'K2f'
      raise RuntimeError(
          f"{which} (bf16) at H={hidden}: no cluster of {info['cluster']} "
          f"CTAs with {info['smem_bytes']} bytes of shared memory each fits "
          'this device.')
    _CLUSTERS[key] = info
  return _CLUSTERS[key]


def _bf16_launch_check(device: torch.device, hidden: int):
  """Raise for a shape the bf16 kernels do not take, before any CUDA call."""
  cluster_shape(hidden)
  if device.type != 'cuda':
    raise ValueError(f'the K2 kernels take CUDA tensors, not {device}.')


def _launch_fwd(xp, wh, bn, h0):
  seq_len, batch, _ = xp.shape
  h_dim = wh.shape[0]
  bf16 = xp.dtype == torch.bfloat16
  if bf16:
    _bf16_launch_check(xp.device, h_dim)
  lib = _lib()
  with torch.cuda.device(xp.device):
    ys = torch.empty((seq_len, batch, h_dim), dtype=torch.float32,
                     device=xp.device)
    stream = torch.cuda.current_stream().cuda_stream
    if bf16:
      pick_cluster(xp.device, h_dim)
      status = lib.ddsp_gru_cluster_fwd(xp.data_ptr(), wh.data_ptr(),
                                        bn.data_ptr(), h0.data_ptr(),
                                        ys.data_ptr(), seq_len, batch, h_dim,
                                        stream)
    else:
      u = pick_units_per_block(xp.device, h_dim, batch)
      barrier = torch.zeros(1, dtype=torch.int32, device=xp.device)
      status = lib.ddsp_gru_fwd(xp.data_ptr(), wh.data_ptr(), bn.data_ptr(),
                                h0.data_ptr(), ys.data_ptr(),
                                barrier.data_ptr(), seq_len, batch, h_dim, u,
                                stream)
  _build.check(status, 'ddsp_gru_cluster_fwd' if bf16 else 'ddsp_gru_fwd')
  launches['fwd'] += 1
  return ys


def _launch_bwd_serial(g, xp, h_prev, wh, bn):
  """K2b (a), bf16: (dxp, dhn stream, per-tile dbn sums, dh0)."""
  seq_len, batch, _ = xp.shape
  h_dim = wh.shape[0]
  dev = xp.device
  _bf16_launch_check(dev, h_dim)
  lib = _lib()
  with torch.cuda.device(dev):
    pick_cluster(dev, h_dim, backward=True)
    dxp = torch.empty_like(xp)
    dhn = torch.empty((seq_len, batch, h_dim), dtype=xp.dtype, device=dev)
    dbn_tiles = torch.empty((batch_tiles(batch), h_dim), dtype=torch.float32,
                            device=dev)
    dh0 = torch.empty((batch, h_dim), dtype=torch.float32, device=dev)
    status = lib.ddsp_gru_cluster_bwd(
        g.data_ptr(), xp.data_ptr(), h_prev.data_ptr(), wh.data_ptr(),
        bn.data_ptr(), dxp.data_ptr(), dhn.data_ptr(), dbn_tiles.data_ptr(),
        dh0.data_ptr(), seq_len, batch, h_dim,
        torch.cuda.current_stream().cuda_stream)
  _build.check(status, 'ddsp_gru_cluster_bwd')
  launches['bwd'] += 1
  return dxp, dhn, dbn_tiles, dh0


def _launch_wgrad(h_prev, dxp, dhn, dbn_tiles):
  """K2b (b), bf16: (dwh, dbn) from K2b (a)'s streams."""
  seq_len, batch, h_dim = h_prev.shape
  dev = dxp.device
  _bf16_launch_check(dev, h_dim)
  lib = _lib()
  with torch.cuda.device(dev):
    dwh = torch.empty((h_dim, 3 * h_dim), dtype=torch.float32, device=dev)
    dbn = torch.empty((h_dim,), dtype=torch.float32, device=dev)
    status = lib.ddsp_gru_wgrad(
        h_prev.data_ptr(), dxp.data_ptr(), dhn.data_ptr(),
        dbn_tiles.data_ptr(), dwh.data_ptr(), dbn.data_ptr(),
        seq_len * batch, h_dim, dbn_tiles.shape[0],
        torch.cuda.current_stream().cuda_stream)
  _build.check(status, 'ddsp_gru_wgrad')
  launches['wgrad'] += 1
  return dwh, dbn


def _launch_bwd(g, xp, h_prev, wh, bn):
  """K2b: (dxp, dwh, dbn, dh0); bf16 as passes (a) and (b)."""
  if xp.dtype == torch.bfloat16:
    dxp, dhn, dbn_tiles, dh0 = _launch_bwd_serial(g, xp, h_prev, wh, bn)
    dwh, dbn = _launch_wgrad(h_prev, dxp, dhn, dbn_tiles)
    return dxp, dwh, dbn, dh0
  lib = _lib()
  seq_len, batch, three_h = xp.shape
  h_dim = wh.shape[0]
  dev = xp.device
  with torch.cuda.device(dev):
    u = pick_units_per_block(dev, h_dim, batch, backward=True)
    dxp = torch.empty_like(xp)
    exchange = torch.empty((2, batch, three_h), dtype=xp.dtype, device=dev)
    dwh = torch.empty((h_dim, three_h), dtype=torch.float32, device=dev)
    dbn = torch.empty((h_dim,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((batch, h_dim), dtype=torch.float32, device=dev)
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    status = lib.ddsp_gru_bwd(
        g.data_ptr(), xp.data_ptr(), h_prev.data_ptr(), wh.data_ptr(),
        bn.data_ptr(), dxp.data_ptr(), exchange.data_ptr(), dwh.data_ptr(),
        dbn.data_ptr(), dh0.data_ptr(), barrier.data_ptr(), seq_len, batch,
        h_dim, u, torch.cuda.current_stream().cuda_stream)
  _build.check(status, 'ddsp_gru_bwd')
  launches['bwd'] += 1
  return dxp, dwh, dbn, dh0


class GruSequence(torch.autograd.Function):
  """K2 with its backward: kernels on CUDA tensors, plain versions on CPU
  tensors, the same gradients either way.

  wh is cast to the stream dtype in here, so dwh comes back float32 for
  the float32 parameter. Saves time-major xp, wh, bn, h0 and ys; backward
  rebuilds the h_prev stream and runs K2b (with bf16 streams its serial
  pass, then its weight-gradient pass).
  """

  @staticmethod
  def forward(ctx, xp, wh, bn, h0):
    xp = xp.contiguous()
    wh_s = wh.to(stream_dtype(xp.dtype)).contiguous()
    bn = bn.float().contiguous()
    h0 = h0.float().contiguous()
    if xp.device.type == 'cpu':
      ys = gru_sequence_plain(xp, wh_s, bn, h0)
    else:
      ys = _launch_fwd(xp, wh_s, bn, h0)
    if any(ctx.needs_input_grad):  # nothing is kept when serving
      ctx.save_for_backward(xp, wh_s, bn, h0, ys)
    return ys

  @staticmethod
  def backward(ctx, g):
    xp, wh_s, bn, h0, ys = ctx.saved_tensors
    # autograd may hand over an expanded or strided cotangent.
    g = g.float().contiguous()
    h_prev = h_prev_stream(h0, ys, wh_s.dtype)
    if xp.device.type == 'cpu':
      dxp, dwh, dbn, dh0 = gru_bwd_plain(g, xp, h_prev, wh_s, bn)
    else:
      dxp, dwh, dbn, dh0 = _launch_bwd(g, xp, h_prev, wh_s, bn)
    return dxp, dwh, dbn, dh0


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
    ys [T, B, H] float32, differentiable in all four inputs. A CUDA input
    launches K2f (and K2b in backward); a CPU input takes the plain
    versions.
  """
  _check(xp, wh, bn, h0)
  if xp.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'K2 runs on CUDA or the CPU, not {xp.device}.')
  return GruSequence.apply(xp, wh, bn, h0)
