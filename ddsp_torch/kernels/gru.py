"""Kernel family K2: the fused GRU sequence, the whole recurrence in one
launch each way.

Wraps csrc/gru.cu, which replaces ddsp_tpu/ops/pallas_kernels/gru.py:
_fwd_kernel (K2f) and _bwd_kernel (K2b). Each is a torch.library op
(ddsp_torch::gru_fwd, ::gru_bwd), and `GruSequence` is the
torch.autograd.Function around them: a CUDA tensor launches the kernels in
both directions, a CPU tensor takes the plain PyTorch versions beside them
(`gru_sequence_plain`, `gru_bwd_plain`: Python loops of the same steps in
the same dtypes), and torch.export traces a GRU into one gru_fwd node. The
CPU tests hold the plain versions against the JAX package, and
chip_smoke.py holds each kernel against its plain version.

K2f takes one of three routes (`fwd_route`). With bf16 streams (the main
path) the route depends on H (`bf16_route`): up to 512 units the kernels
run one thread-block cluster per tile of TILE_ROWS batch rows, on tensor
cores, at the next H in CLUSTER_HIDDEN (the operands zero-padded, which is
exact: padded units stay 0), and K2b is two kernels: the serial
reverse-time pass (a), whose plain version is `gru_bwd_serial_plain`, and
the weight-gradient pass (b), a split-K GEMM (`wgrad_plan`) whose plain
versions are `gru_wgrad_plain` and, in its order of summation,
`gru_wgrad_split_plain`. Past 512 units, and with float32 streams, the
cooperative kernels run (`plan_cooperative`: H_pad / u CTAs per tile, the
tiles that fit one co-resident grid per launch): with bf16 streams K2b is
again the serial pass (a), on the cooperative kernel, and the
weight-gradient pass (b); with float32 streams one kernel each way, whose
per-tile dwh the wrapper adds in tile order (`gru_bwd_tiles_plain`). A
float32 forward of one step (the VST hop) runs the step kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ddsp_torch.kernels import _build

# Kernel launches so far, per kernel; a run reads them to show which
# kernels its path went through. Counted where a kernel launches, inside
# the ops' CUDA implementations: an exported program's run counts its own
# launches, and a trace (fake tensors) none.
# 'fwd' and 'bwd' count K2f and K2b launches (one per call, or one per
# launch of tiles on the cooperative route), 'wgrad' K2b's weight-gradient
# pass (bf16 streams); 'fwd_cooperative' and 'fwd_step' count the K2f
# launches of 'fwd' that took the cooperative route (float32 streams at
# T >= 2, or bf16 past 512 units) and the step kernel (float32, T = 1).
launches: Dict[str, int] = {'fwd': 0, 'bwd': 0, 'wgrad': 0,
                            'fwd_cooperative': 0, 'fwd_step': 0}

# The bf16 cluster kernels: one cluster per tile of TILE_ROWS batch rows,
# u = UNITS_PER_CTA hidden units per CTA, so H / u CTAs per cluster; they
# take these H (csrc/gru.cu: H a multiple of 64, at most 16 CTAs per
# cluster), and other H up to the last one zero-padded.
TILE_ROWS = 16
UNITS_PER_CTA = 32
CLUSTER_HIDDEN = (64, 128, 256, 512)

# K2b's weight-gradient pass (csrc/gru.cu gru_wgrad_kernel): rows of K per
# pipeline stage, the output tile's largest height and width, the most K
# slices (CTAs in a portable cluster) and the fewest chunks a slice gets.
WGRAD_CHUNK = 64
WGRAD_MAX_TILE = (128, 256)
WGRAD_MAX_SPLITS = 8
WGRAD_MIN_SLICE_CHUNKS = 4
# Past CLUSTER_HIDDEN the pass takes H a multiple of WGRAD_WIDE_MULTIPLE
# (other H are zero-padded to one).
WGRAD_WIDE_MULTIPLE = 128

# The cooperative kernels (csrc/gru.cu gru_coop_fwd, gru_coop_bwd): u units
# per CTA, u in COOP_UNITS (the first that gives the fewest launches wins:
# u = 8, the least work a CTA does per step, ran faster than u = 16 at every
# shape measured on an H100); H is padded inside the kernels to a multiple
# of u and of the mma's K.
COOP_UNITS = (8, 16)
COOP_MMA_K = {True: 16, False: 8}  # bf16: m16n8k16; float32: m16n8k8 TF32


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
  """(CTAs per cluster, hidden units per CTA) of the bf16 cluster kernels
  at H, one of CLUSTER_HIDDEN (`bf16_route` pads other H to one)."""
  if hidden not in CLUSTER_HIDDEN:
    raise ValueError(
        f'the K2 cluster kernels take H in {CLUSTER_HIDDEN}, not H={hidden}: '
        f'each CTA of a cluster owns {UNITS_PER_CTA} hidden units, the '
        'tensor-core product splits H four ways in steps of 16, and a '
        'cluster holds at most 16 CTAs.')
  return hidden // UNITS_PER_CTA, UNITS_PER_CTA


def bf16_route(hidden: int) -> Tuple[str, int]:
  """How the bf16 kernels run H units: ('cluster', h_pad) with h_pad the
  smallest of CLUSTER_HIDDEN >= H (the operands zero-padded to it), or
  ('cooperative', H) past the largest, where no cluster holds wh."""
  if hidden < 1:
    raise ValueError(f'K2 needs at least one hidden unit, not H={hidden}.')
  for h_pad in CLUSTER_HIDDEN:
    if h_pad >= hidden:
      return 'cluster', h_pad
  return 'cooperative', hidden


def fwd_route(dtype: torch.dtype, seq_len: int, hidden: int) -> str:
  """Which K2f kernel runs a forward: 'step' (float32 streams, one step),
  'cluster' (bf16 up to 512 units, zero-padded to CLUSTER_HIDDEN) or
  'cooperative' (float32 from two steps, bf16 past 512 units)."""
  if stream_dtype(dtype) == torch.bfloat16:
    return bf16_route(hidden)[0]
  return 'step' if seq_len == 1 else 'cooperative'


def wgrad_tile(hidden: int) -> Tuple[int, int]:
  """The weight-gradient kernel's output tile (bm, bn) at H: min(128, H) x
  min(256, H) for H in CLUSTER_HIDDEN; past 512, H a multiple of
  WGRAD_WIDE_MULTIPLE, 128 x 256 where 256 divides H, else 128 x 128.
  Raises ValueError for other H (`wgrad_hidden` pads them)."""
  if hidden in CLUSTER_HIDDEN:
    return min(WGRAD_MAX_TILE[0], hidden), min(WGRAD_MAX_TILE[1], hidden)
  if hidden > CLUSTER_HIDDEN[-1] and hidden % WGRAD_WIDE_MULTIPLE == 0:
    return WGRAD_MAX_TILE[0], (WGRAD_MAX_TILE[1]
                               if hidden % WGRAD_MAX_TILE[1] == 0 else 128)
  raise ValueError(
      f'the weight-gradient kernel takes H in {CLUSTER_HIDDEN} or a multiple '
      f'of {WGRAD_WIDE_MULTIPLE} past {CLUSTER_HIDDEN[-1]}, not H={hidden}: '
      'its tiles must divide H.')


def wgrad_hidden(hidden: int) -> int:
  """The H at which the weight-gradient pass runs H units: the next of
  CLUSTER_HIDDEN up to 512, the next multiple of WGRAD_WIDE_MULTIPLE past
  it (streams zero-padded to it)."""
  if hidden <= CLUSTER_HIDDEN[-1]:
    return bf16_route(hidden)[1]
  return -(-hidden // WGRAD_WIDE_MULTIPLE) * WGRAD_WIDE_MULTIPLE


def wgrad_plan(hidden: int, rows: int, n_sms: int,
               max_clusters: Optional[Callable[[int, int, int], int]] = None
               ) -> Dict[str, int]:
  """How K2b's weight-gradient kernel cuts dwh [H, 3H] = h_prev^T dhp over
  K = rows (T * B) for a card of n_sms SMs.

  Output tiles of bm x bn (`wgrad_tile`): bn divides H, so no tile
  straddles dxp's 2H columns and dhn. K runs in chunks of WGRAD_CHUNK
  rows, cut into `splits` slices of whole chunks, one CTA per tile and
  slice; a tile's CTAs form one cluster, which adds up their partial tiles.
  The wave rule: tiles x splits <= n_sms, and where `max_clusters(bm, bn,
  splits)` (the clusters the device holds at once) is given, tiles <= it:
  every CTA in one wave. splits is the largest that allows, at most
  WGRAD_MAX_SPLITS, while every slice keeps WGRAD_MIN_SLICE_CHUNKS chunks
  (or one slice has all of them). Returns {'bm', 'bn', 'tiles', 'chunk',
  'chunks', 'splits'}; H must be one `wgrad_tile` takes (the wrapper pads
  other H).
  """
  bm, bn = wgrad_tile(hidden)
  if rows < 1:
    raise ValueError(f'the weight-gradient pass needs rows >= 1, not {rows}.')
  tiles = (hidden // bm) * (3 * hidden // bn)
  chunks = -(-rows // WGRAD_CHUNK)
  splits = max(1, min(WGRAD_MAX_SPLITS, n_sms // tiles,
                      chunks // WGRAD_MIN_SLICE_CHUNKS))
  while (splits > 1 and max_clusters is not None and
         max_clusters(bm, bn, splits) < tiles):
    splits -= 1
  return {'bm': bm, 'bn': bn, 'tiles': tiles, 'chunk': WGRAD_CHUNK,
          'chunks': chunks, 'splits': splits}


def wgrad_blocks(plan: Dict[str, int], hidden: int, rows: int):
  """The CTAs of the weight-gradient kernel in launch order, as the kernel
  computes them from its index and cluster rank: [(m0, n0, first row, end
  row)]."""
  m_blocks = hidden // plan['bm']
  out = []
  for block in range(plan['tiles'] * plan['splits']):
    tile, piece = divmod(block, plan['splits'])
    c0 = piece * plan['chunks'] // plan['splits']
    c1 = (piece + 1) * plan['chunks'] // plan['splits']
    out.append(((tile % m_blocks) * plan['bm'], (tile // m_blocks) * plan['bn'],
                c0 * plan['chunk'], min(rows, c1 * plan['chunk'])))
  return out


def pad_units(x: torch.Tensor, h_pad: int) -> torch.Tensor:
  """[..., H] -> [..., h_pad] with zeros after the H units."""
  return torch.nn.functional.pad(x, (0, h_pad - x.shape[-1]))


def pad_gates(x: torch.Tensor, h_pad: int) -> torch.Tensor:
  """[..., 3H] -> [..., 3 h_pad]: each gate block [r | z | n] padded with
  zeros to h_pad units."""
  hidden = x.shape[-1] // 3
  return pad_units(x.unflatten(-1, (3, hidden)), h_pad).flatten(-2)


def unpad_gates(x: torch.Tensor, hidden: int) -> torch.Tensor:
  """[..., 3 h_pad] -> [..., 3H], the first H units of each gate block."""
  h_pad = x.shape[-1] // 3
  return x.unflatten(-1, (3, h_pad))[..., :hidden].flatten(-2).contiguous()


def pad_gru_inputs(h_pad: int, xp: torch.Tensor, wh: torch.Tensor,
                   bn: torch.Tensor, *per_unit: torch.Tensor):
  """K2's operands zero-padded from H to h_pad units: xp [..., 3H] per gate
  block, wh [H, 3H] in its rows and each gate's columns, bn [H] and every
  [..., H] tensor of `per_unit` (h0, g, h_prev). Padded units then stay
  exactly 0 forward and backward, and add exact zeros to the real units'
  sums. At h_pad = H they are returned as they are."""
  if h_pad == wh.shape[0]:
    return (xp, wh, bn, *per_unit)
  wh_p = pad_gates(torch.nn.functional.pad(wh, (0, 0, 0, h_pad - wh.shape[0])),
                   h_pad)
  return (pad_gates(xp, h_pad), wh_p, pad_units(bn, h_pad),
          *(pad_units(t, h_pad).contiguous() for t in per_unit))


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


def gru_wgrad_split_plain(h_prev: torch.Tensor, dxp: torch.Tensor,
                          dhn: torch.Tensor, dbn_tiles: torch.Tensor,
                          plan: Dict[str, int]):
  """`gru_wgrad_plain` in the kernel's order of summation for `plan`
  (`wgrad_plan`): one float32 product per K slice, the slices' partials
  added in slice order (a cluster's rank order), the tiles' dbn sums in
  tile order."""
  h_dim = h_prev.shape[-1]
  hp = h_prev.reshape(-1, h_dim).float()
  dhp = torch.cat([dxp[..., :2 * h_dim], dhn], dim=-1).reshape(
      -1, 3 * h_dim).float()
  slices = sorted({(r0, r1) for _, _, r0, r1 in
                   wgrad_blocks(plan, h_dim, hp.shape[0])})
  dwh = None
  for r0, r1 in slices:
    part = hp[r0:r1].t() @ dhp[r0:r1]
    dwh = part if dwh is None else dwh + part
  dbn = dbn_tiles[0].clone()
  for row in dbn_tiles[1:]:
    dbn = dbn + row
  return dwh, dbn


def gru_bwd_tiles_plain(g: torch.Tensor, xp: torch.Tensor,
                        h_prev: torch.Tensor, wh: torch.Tensor,
                        bn: torch.Tensor):
  """`gru_bwd_plain` in the order of summation of the float32 cooperative
  K2b: dwh summed step by step over each tile of TILE_ROWS rows, dbn per
  tile as `gru_bwd_serial_plain` sums it, and the tiles' dwh and dbn then
  added in tile order. dxp and dh0 are `gru_bwd_plain`'s."""
  dxp, _, dbn_tiles, dh0 = gru_bwd_serial_plain(g, xp, h_prev, wh, bn)
  dwh, dbn = None, None
  for i, b0 in enumerate(range(0, xp.shape[1], TILE_ROWS)):
    rows = slice(b0, b0 + TILE_ROWS)
    part = gru_bwd_plain(g[:, rows], xp[:, rows], h_prev[:, rows], wh, bn)[1]
    dwh = part if dwh is None else dwh + part
    dbn = dbn_tiles[i].clone() if dbn is None else dbn + dbn_tiles[i]
  return dxp, dwh, dbn, dh0


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
    'ddsp_gru_coop_occupancy': [_INT] * 4 + [ctypes.POINTER(_INT)] * 2,
    'ddsp_gru_coop_fwd': [_PTR] * 6 + [_INT] * 8 + [_PTR],
    'ddsp_gru_coop_bwd': [_PTR] * 11 + [_INT] * 8 + [_PTR],
    'ddsp_gru_cluster_query': [_INT] * 2 + [ctypes.POINTER(_INT)] * 4,
    'ddsp_gru_cluster_fwd': [_PTR] * 5 + [_INT] * 3 + [_PTR],
    'ddsp_gru_cluster_bwd': [_PTR] * 9 + [_INT] * 3 + [_PTR],
    'ddsp_gru_wgrad_clusters': [_INT] * 3 + [ctypes.POINTER(_INT)],
    'ddsp_gru_wgrad': [_PTR] * 6 + [_INT] * 7 + [_PTR],
    'ddsp_gru_step': [_PTR] * 5 + [_INT] * 2 + [_PTR],
}

# The plan of the cooperative kernels per (device index, H, B, backward,
# bf16), and the cluster of the bf16 cluster kernels per (device index, H,
# backward): each depends on nothing else.
_PLANS: Dict[Tuple[int, int, int, bool, bool], Dict[str, int]] = {}
_CLUSTERS: Dict[Tuple[int, int, bool], Dict[str, int]] = {}
# Clusters of the weight-gradient kernel a device holds at once, per
# (device index, bm, bn, splits).
_WGRAD_CLUSTERS: Dict[Tuple[int, int, int, int], int] = {}


def _lib():
  return _build.load('gru', _SIGNATURES)


def coop_h_pad(hidden: int, units: int, bf16: bool) -> int:
  """H padded for the cooperative kernels at u units per CTA: the next
  multiple of u and of the mma's K (COOP_MMA_K)."""
  step = math.lcm(units, COOP_MMA_K[bool(bf16)])
  return -(-hidden // step) * step


def plan_cooperative(hidden: int, batch: int, n_sms: int,
                     fits: Callable[[int, int], int],
                     bf16: bool) -> Dict[str, int]:
  """How the cooperative kernels run H units over a batch on a card of n_sms
  SMs.

  Each tile of TILE_ROWS rows takes h_pad / u CTAs (u of COOP_UNITS units
  each, h_pad = `coop_h_pad`), one unit range each; all CTAs of a launch
  must be co-resident, so a launch takes `tiles_per_launch` tiles and the
  rest follow in later launches. `fits(u, h_pad)` is the occupancy query:
  blocks of that kernel per SM (0 where one does not fit). The u with the
  fewest launches wins, the first of COOP_UNITS on a tie. Returns {'units', 'h_pad', 'ctas' (per tile),
  'tiles', 'tiles_per_launch', 'launches'}; raises RuntimeError where no u
  makes a co-resident grid.
  """
  if hidden < 1 or batch < 1:
    raise ValueError(f'K2 needs H >= 1 and B >= 1, not H={hidden}, '
                     f'B={batch}.')
  tiles = batch_tiles(batch)
  best = None
  for units in COOP_UNITS:
    h_pad = coop_h_pad(hidden, units, bf16)
    capacity = fits(units, h_pad) * n_sms
    ctas = h_pad // units
    if ctas > capacity:
      continue
    per_launch = min(tiles, capacity // ctas)
    plan = {'units': units, 'h_pad': h_pad, 'ctas': ctas, 'tiles': tiles,
            'tiles_per_launch': per_launch,
            'launches': -(-tiles // per_launch)}
    if best is None or plan['launches'] < best['launches']:
      best = plan
  if best is None:
    raise RuntimeError(
        f'the cooperative K2 kernels cannot make a co-resident grid for '
        f'H={hidden} ({"bf16" if bf16 else "float32"} streams): at u in '
        f'{COOP_UNITS} units per CTA either the slices of wh do not fit '
        f'an SM or the H / u CTAs exceed the {n_sms} SMs.')
  return best


def coop_launches(plan: Dict[str, int], batch: int):
  """The launches of a plan: [(first tile, tiles, first row, rows)]."""
  out = []
  for tile0 in range(0, plan['tiles'], plan['tiles_per_launch']):
    n_tiles = min(plan['tiles_per_launch'], plan['tiles'] - tile0)
    b0 = tile0 * TILE_ROWS
    out.append((tile0, n_tiles, b0, min(batch, b0 + n_tiles * TILE_ROWS) - b0))
  return out


def pick_cooperative(device: torch.device, hidden: int, batch: int,
                     backward: bool = False,
                     bf16: bool = False) -> Dict[str, int]:
  """`plan_cooperative` on this device, from the kernels' occupancy
  queries; once per (device, H, B, direction, dtype). Call it with `device`
  current."""
  key = (device.index, hidden, batch, backward, bf16)
  if key not in _PLANS:
    lib = _lib()

    def fits(units, h_pad):
      per_sm, n_sms = _INT(0), _INT(0)
      status = lib.ddsp_gru_coop_occupancy(h_pad, units, int(backward),
                                           int(bf16), ctypes.byref(per_sm),
                                           ctypes.byref(n_sms))
      _build.check(status, 'ddsp_gru_coop_occupancy')
      return per_sm.value

    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    _PLANS[key] = plan_cooperative(hidden, batch, n_sms, fits, bf16)
  return _PLANS[key]


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


def _cuda_check(device: torch.device):
  if device.type != 'cuda':
    raise ValueError(f'the K2 kernels take CUDA tensors, not {device}.')


def _launch_fwd(xp, wh, bn, h0):
  """K2f: ys [T, B, H] float32 from contiguous xp, wh at the stream dtype
  and float32 bn, h0, on the route of this T, H and dtype (`fwd_route`)."""
  hidden = wh.shape[0]
  _cuda_check(xp.device)
  route = fwd_route(xp.dtype, xp.shape[0], hidden)
  if route == 'step':
    return _launch_step_fwd(xp, wh, bn, h0)
  if route == 'cluster':
    h_pad = bf16_route(hidden)[1]
    ys = _launch_cluster_fwd(*pad_gru_inputs(h_pad, xp, wh, bn, h0))
    return ys[..., :hidden].contiguous()  # a no-op at h_pad = H
  return _launch_coop_fwd(xp, wh, bn, h0)


def _launch_step_fwd(xp, wh, bn, h0):
  """K2f at T = 1 with float32 streams: the step kernel, one launch."""
  batch, hidden = h0.shape
  dev = xp.device
  lib = _lib()
  with torch.cuda.device(dev):
    ys = torch.empty((1, batch, hidden), dtype=torch.float32, device=dev)
    status = lib.ddsp_gru_step(xp.data_ptr(), wh.data_ptr(), bn.data_ptr(),
                               h0.data_ptr(), ys.data_ptr(), batch, hidden,
                               torch.cuda.current_stream().cuda_stream)
  _build.check(status, 'ddsp_gru_step')
  launches['fwd'] += 1
  launches['fwd_step'] += 1
  return ys


def _launch_cluster_fwd(xp, wh, bn, h0):
  seq_len, batch, _ = xp.shape
  hidden = wh.shape[0]
  cluster_shape(hidden)
  lib = _lib()
  with torch.cuda.device(xp.device):
    pick_cluster(xp.device, hidden)
    ys = torch.empty((seq_len, batch, hidden), dtype=torch.float32,
                     device=xp.device)
    status = lib.ddsp_gru_cluster_fwd(xp.data_ptr(), wh.data_ptr(),
                                      bn.data_ptr(), h0.data_ptr(),
                                      ys.data_ptr(), seq_len, batch, hidden,
                                      torch.cuda.current_stream().cuda_stream)
  _build.check(status, 'ddsp_gru_cluster_fwd')
  launches['fwd'] += 1
  return ys


def _coop_exchange(plan: Dict[str, int], columns: int, bf16: bool,
                   device: torch.device):
  """The zeroed exchange buffers of a plan's tiles: per tile two buffers of
  columns / group column groups x 32 lanes x 16 bytes (group: 8 bf16 or 4
  float32 columns, half an mma k-tile)."""
  groups = columns // (COOP_MMA_K[bool(bf16)] // 2)
  return torch.zeros((plan['tiles'], 2, groups, 32, 4), dtype=torch.int32,
                     device=device)


def _launch_coop_fwd(xp, wh, bn, h0):
  """The cooperative K2f, one launch per `coop_launches` entry."""
  seq_len, batch, _ = xp.shape
  hidden = wh.shape[0]
  bf16 = xp.dtype == torch.bfloat16
  dev = xp.device
  lib = _lib()
  with torch.cuda.device(dev):
    plan = pick_cooperative(dev, hidden, batch, bf16=bf16)
    ys = torch.empty((seq_len, batch, hidden), dtype=torch.float32,
                     device=dev)
    xbuf = _coop_exchange(plan, plan['h_pad'], bf16, dev)
    stream = torch.cuda.current_stream().cuda_stream
    for tile0, n_tiles, b0, nb in coop_launches(plan, batch):
      status = lib.ddsp_gru_coop_fwd(
          xp[:, b0:].data_ptr(), wh.data_ptr(), bn.data_ptr(),
          h0[b0:].data_ptr(), ys[:, b0:].data_ptr(), xbuf[tile0].data_ptr(),
          seq_len, nb, batch, hidden, plan['h_pad'], plan['units'], n_tiles,
          int(bf16), stream)
      _build.check(status, 'ddsp_gru_coop_fwd')
      launches['fwd'] += 1
      launches['fwd_cooperative'] += 1
  return ys


def _launch_bwd_serial(g, xp, h_prev, wh, bn):
  """K2b (a), bf16 cluster kernel, H in CLUSTER_HIDDEN: (dxp, dhn stream,
  per-tile dbn sums, dh0)."""
  seq_len, batch, _ = xp.shape
  h_dim = wh.shape[0]
  dev = xp.device
  _cuda_check(dev)
  cluster_shape(h_dim)
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


def pick_wgrad(device: torch.device, hidden: int,
               rows: int) -> Dict[str, int]:
  """`wgrad_plan` for this device: its SM count and cluster occupancy (each
  queried once per device and shape). Call it with `device` current."""
  def max_clusters(bm, bn, splits):
    key = (device.index, bm, bn, splits)
    if key not in _WGRAD_CLUSTERS:
      out = _INT(0)
      status = _lib().ddsp_gru_wgrad_clusters(bm, bn, splits,
                                              ctypes.byref(out))
      _build.check(status, 'ddsp_gru_wgrad_clusters')
      _WGRAD_CLUSTERS[key] = out.value
    return _WGRAD_CLUSTERS[key]

  n_sms = torch.cuda.get_device_properties(device).multi_processor_count
  return wgrad_plan(hidden, rows, n_sms, max_clusters)


def _launch_wgrad(h_prev, dxp, dhn, dbn_tiles):
  """K2b (b), bf16 cluster route: (dwh, dbn) from K2b (a)'s streams."""
  seq_len, batch, h_dim = h_prev.shape
  rows = seq_len * batch
  dev = dxp.device
  for name, t, width in (('h_prev', h_prev, h_dim), ('dxp', dxp, 3 * h_dim),
                         ('dhn', dhn, h_dim)):
    if tuple(t.shape) != (seq_len, batch, width):
      raise ValueError(f'the weight-gradient pass takes {name} '
                       f'[{seq_len}, {batch}, {width}], not '
                       f'{tuple(t.shape)}.')
    if (t.dtype != torch.bfloat16 or not t.is_contiguous() or
        t.data_ptr() % 16):
      raise ValueError(f'the weight-gradient pass reads {name} through TMA: '
                       'contiguous bf16 at a 16-byte aligned address.')
  if (dbn_tiles.dtype != torch.float32 or not dbn_tiles.is_contiguous() or
      dbn_tiles.ndim != 2 or dbn_tiles.shape[1] != h_dim):
    raise ValueError(f'the weight-gradient pass takes float32 dbn_tiles '
                     f'[tiles, {h_dim}], not {dbn_tiles.dtype} '
                     f'{tuple(dbn_tiles.shape)}.')
  _cuda_check(dev)
  lib = _lib()
  with torch.cuda.device(dev):
    plan = pick_wgrad(dev, h_dim, rows)
    dwh = torch.empty((h_dim, 3 * h_dim), dtype=torch.float32, device=dev)
    dbn = torch.empty((h_dim,), dtype=torch.float32, device=dev)
    status = lib.ddsp_gru_wgrad(
        h_prev.data_ptr(), dxp.data_ptr(), dhn.data_ptr(),
        dbn_tiles.data_ptr(), dwh.data_ptr(), dbn.data_ptr(), rows, h_dim,
        dbn_tiles.shape[0], plan['bm'], plan['bn'], plan['chunk'],
        plan['splits'], torch.cuda.current_stream().cuda_stream)
  _build.check(status, 'ddsp_gru_wgrad')
  launches['wgrad'] += 1
  return dwh, dbn


def _launch_coop_bwd(g, xp, h_prev, wh, bn):
  """The cooperative K2b (a), one launch per `coop_launches` entry: (dxp,
  the dhn stream, the tiles' dbn sums, dh0) with bf16 streams; (dxp, the
  tiles' dwh [tiles, H, 3H], the tiles' dbn sums, dh0) with float32."""
  seq_len, batch, three_h = xp.shape
  hidden = wh.shape[0]
  bf16 = xp.dtype == torch.bfloat16
  dev = xp.device
  _cuda_check(dev)
  lib = _lib()
  with torch.cuda.device(dev):
    plan = pick_cooperative(dev, hidden, batch, backward=True, bf16=bf16)
    f32 = dict(dtype=torch.float32, device=dev)
    dxp = torch.empty_like(xp)
    dh0 = torch.empty((batch, hidden), **f32)
    dbn_tiles = torch.empty((plan['tiles'], hidden), **f32)
    if bf16:
      per_tile = torch.empty((seq_len, batch, hidden), dtype=xp.dtype,
                             device=dev)
    else:
      per_tile = torch.empty((plan['tiles'], hidden, three_h), **f32)
    xbuf = _coop_exchange(plan, 3 * plan['h_pad'], bf16, dev)
    stream = torch.cuda.current_stream().cuda_stream
    for tile0, n_tiles, b0, nb in coop_launches(plan, batch):
      status = lib.ddsp_gru_coop_bwd(
          g[:, b0:].data_ptr(), xp[:, b0:].data_ptr(),
          h_prev[:, b0:].data_ptr(), wh.data_ptr(), bn.data_ptr(),
          dxp[:, b0:].data_ptr(),
          per_tile[:, b0:].data_ptr() if bf16 else None,
          dbn_tiles[tile0].data_ptr(),
          None if bf16 else per_tile[tile0].data_ptr(),
          dh0[b0:].data_ptr(), xbuf[tile0].data_ptr(), seq_len, nb, batch,
          hidden, plan['h_pad'], plan['units'], n_tiles, int(bf16), stream)
      _build.check(status, 'ddsp_gru_coop_bwd')
      launches['bwd'] += 1
  return dxp, per_tile, dbn_tiles, dh0


def _launch_wgrad_any(h_prev, dxp, dhn, dbn_tiles):
  """K2b (b) at any H: the streams zero-padded to `wgrad_hidden` where the
  kernel's tiles do not divide H (exact: padded rows and columns of dwh
  are dropped), then sliced back."""
  hidden = h_prev.shape[-1]
  h_pad = wgrad_hidden(hidden)
  if h_pad == hidden:
    return _launch_wgrad(h_prev, dxp, dhn, dbn_tiles)
  dwh, dbn = _launch_wgrad(pad_units(h_prev, h_pad).contiguous(),
                           pad_gates(dxp, h_pad).contiguous(),
                           pad_units(dhn, h_pad).contiguous(),
                           pad_units(dbn_tiles, h_pad).contiguous())
  return unpad_gates(dwh[:hidden], hidden), dbn[:hidden].contiguous()


def _sum_tiles(parts: torch.Tensor) -> torch.Tensor:
  """parts [tiles, ...] added in tile order."""
  out = parts[0]
  for part in parts[1:]:
    out = out + part
  return out.contiguous()


def _launch_bwd(g, xp, h_prev, wh, bn):
  """K2b: (dxp, dwh, dbn, dh0) on the route of this H and dtype; with bf16
  streams as passes (a) and (b) (the cluster route at the padded H)."""
  hidden = wh.shape[0]
  _cuda_check(xp.device)
  if xp.dtype == torch.bfloat16:
    route, h_pad = bf16_route(hidden)
    if route == 'cluster':
      xp, wh, bn, g, h_prev = pad_gru_inputs(h_pad, xp, wh, bn, g, h_prev)
      dxp, dhn, dbn_tiles, dh0 = _launch_bwd_serial(g, xp, h_prev, wh, bn)
      dwh, dbn = _launch_wgrad(h_prev, dxp, dhn, dbn_tiles)
      # Slicing back is a no-op at h_pad = H.
      return (unpad_gates(dxp, hidden), unpad_gates(dwh[:hidden], hidden),
              dbn[:hidden].contiguous(), dh0[:, :hidden].contiguous())
    dxp, dhn, dbn_tiles, dh0 = _launch_coop_bwd(g, xp, h_prev, wh, bn)
    dwh, dbn = _launch_wgrad_any(h_prev, dxp, dhn, dbn_tiles)
    return dxp, dwh, dbn, dh0
  dxp, dwh_tiles, dbn_tiles, dh0 = _launch_coop_bwd(g, xp, h_prev, wh, bn)
  return dxp, _sum_tiles(dwh_tiles), _sum_tiles(dbn_tiles), dh0


# K2f and K2b as torch.library ops, one per launch entry, each with a CUDA
# implementation (the launches, which count themselves), a CPU one (the
# plain version) and a fake one (shapes and dtypes only), so torch.export
# traces a forward on the card into one node per GRU and the exported
# program launches the kernel itself. The inputs are contiguous, wh at the
# stream dtype, bn and h0 float32 (GruSequence prepares them).


@torch.library.custom_op('ddsp_torch::gru_fwd', mutates_args=(),
                         device_types='cpu')
def gru_fwd(xp: torch.Tensor, wh: torch.Tensor, bn: torch.Tensor,
            h0: torch.Tensor) -> torch.Tensor:
  """K2f on its route (`fwd_route`): ys [T, B, H] float32."""
  return gru_sequence_plain(xp, wh, bn, h0)


@gru_fwd.register_kernel('cuda')
def _gru_fwd_cuda(xp, wh, bn, h0):
  return _launch_fwd(xp, wh, bn, h0)


@gru_fwd.register_fake
def _gru_fwd_fake(xp, wh, bn, h0):
  return xp.new_empty((xp.shape[0], h0.shape[0], wh.shape[0]),
                      dtype=torch.float32)


@torch.library.custom_op('ddsp_torch::gru_bwd', mutates_args=(),
                         device_types='cpu')
def gru_bwd(g: torch.Tensor, xp: torch.Tensor, h_prev: torch.Tensor,
            wh: torch.Tensor, bn: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
  """K2b on its route: (dxp at xp's dtype, dwh, dbn, dh0 float32)."""
  return gru_bwd_plain(g, xp, h_prev, wh, bn)


@gru_bwd.register_kernel('cuda')
def _gru_bwd_cuda(g, xp, h_prev, wh, bn):
  return _launch_bwd(g, xp, h_prev, wh, bn)


@gru_bwd.register_fake
def _gru_bwd_fake(g, xp, h_prev, wh, bn):
  hidden = wh.shape[0]
  f32 = dict(dtype=torch.float32)
  return (torch.empty_like(xp), wh.new_empty((hidden, 3 * hidden), **f32),
          bn.new_empty((hidden,), **f32),
          g.new_empty((g.shape[1], hidden), **f32))


class GruSequence(torch.autograd.Function):
  """K2 with its backward, through the ops above: kernels on CUDA tensors,
  plain versions on CPU tensors, the same gradients either way.

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
    ys = gru_fwd(xp, wh_s, bn, h0)
    if any(ctx.needs_input_grad):  # nothing is kept when serving
      ctx.save_for_backward(xp, wh_s, bn, h0, ys)
    return ys

  @staticmethod
  def backward(ctx, g):
    xp, wh_s, bn, h0, ys = ctx.saved_tensors
    # autograd may hand over an expanded or strided cotangent.
    g = g.float().contiguous()
    h_prev = h_prev_stream(h0, ys, wh_s.dtype)
    return gru_bwd(g, xp, h_prev, wh_s, bn)


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
