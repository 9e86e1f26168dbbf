"""The batch-tiled, split backward of kernel family K2 on the CPU.

With bf16 streams the port's K2b is two kernels: a serial reverse-time pass
that emits dxp, the dhn stream, per-tile dbn sums and dh0
(`gru_bwd_serial_plain` is its plain version), and a weight-gradient pass
over K = T * B rows (`gru_wgrad_plain`). Their composition is held here
against the plain K2b (`gru_bwd_plain`) and the JAX package's Pallas VJP
(interpret mode). The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

Tolerances, relative to the largest element of the reference:
- float32, 1e-5: the split changes only the order of the float32 sums (dwh
  over T * B rows at once instead of step by step, dbn per tile first);
- bf16, 2e-2 with cosine > 0.999: the bf16 tolerance of K2b's existing
  tests (tests/test_torch_kernels.py), since dxp and dhp round to bf16 at
  3 significant digits where two float32 computations differ in the last
  bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops.pallas_kernels import fused_gru
from ddsp_torch.kernels import gru as k_gru

torch.set_num_threads(1)

GRADS = ('dxp', 'dwh', 'dbn', 'dh0')
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _inputs(b, t, h, seed):
  """xp [B, T, 3H], wh, bn, h0 and a cotangent g [B, T, H], from numpy."""
  rng = np.random.RandomState(seed)
  xp = (rng.randn(b, t, 3 * h) * 0.3).astype(np.float32)
  wh = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
  bn = (rng.randn(h) * 0.1).astype(np.float32)
  h0 = (rng.randn(b, h) * 0.1).astype(np.float32)
  g = rng.randn(b, t, h).astype(np.float32)
  return xp, wh, bn, h0, g


def _scaled_close(a, b, rtol, what):
  a = np.asarray(a, np.float64).ravel()
  b = np.asarray(b, np.float64).ravel()
  scale = max(np.abs(b).max(), 1e-12)
  np.testing.assert_allclose(a / scale, b / scale, atol=rtol, err_msg=what)


def _time_major(xp, wh, bn, h0, g, dtype):
  """The K2 operands as GruSequence hands them to its backward."""
  xp_t = torch.from_numpy(xp).transpose(0, 1).contiguous().to(dtype)
  wh_s = torch.from_numpy(wh).to(dtype)
  bn_t, h0_t = torch.from_numpy(bn), torch.from_numpy(h0)
  ys = k_gru.gru_sequence_plain(xp_t, wh_s, bn_t, h0_t)
  h_prev = k_gru.h_prev_stream(h0_t, ys, dtype)
  g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
  return g_t, xp_t, h_prev, wh_s, bn_t


def _split(g, xp, h_prev, wh, bn):
  dxp, dhn, dbn_tiles, dh0 = k_gru.gru_bwd_serial_plain(g, xp, h_prev, wh, bn)
  dwh, dbn = k_gru.gru_wgrad_plain(h_prev, dxp, dhn, dbn_tiles)
  return (dxp, dwh, dbn, dh0), dhn, dbn_tiles


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_split_backward_matches_plain_k2b(dtype):
  # B = 40: three tiles of 16 rows, the last one ragged.
  args = _time_major(*_inputs(40, 10, 64, seed=21), dtype)
  got, dhn, dbn_tiles = _split(*args)
  want = k_gru.gru_bwd_plain(*args)
  assert got[0].dtype == dtype and dhn.dtype == dtype
  assert all(t.dtype == torch.float32 for t in got[1:])
  # The serial pass repeats gru_bwd_plain's per-step arithmetic exactly.
  assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
  for a, b, what in zip(got, want, GRADS):
    _scaled_close(a.float().numpy(), b.float().numpy(), RTOL[dtype], what)
  # The tiles' dbn sums are the row sums of dhn over time, 16 rows each
  # (dhn at the stream dtype here, float32 in the sums: bf16 rounding).
  rows = dhn.float().sum(dim=0)
  want_tiles = torch.stack([rows[i:i + 16].sum(dim=0) for i in (0, 16, 32)])
  _scaled_close(dbn_tiles.numpy(), want_tiles.numpy(), RTOL[dtype], 'tiles')


@pytest.mark.parametrize('dtype,jdtype,b,t,h,seed', [
    (torch.float32, jnp.float32, 3, 24, 32, 22),
    (torch.bfloat16, jnp.bfloat16, 17, 16, 32, 23),
])
def test_split_backward_matches_pallas_vjp(dtype, jdtype, b, t, h, seed):
  xp, wh, bn, h0, g = _inputs(b, t, h, seed)
  # Both sides start from the same bf16-representable xp.
  xp = np.array(jnp.asarray(xp).astype(jdtype).astype(jnp.float32))
  got, _, _ = _split(*_time_major(xp, wh, bn, h0, g, dtype))
  got = [got[0].transpose(0, 1)] + list(got[1:])
  _, vjp = jax.vjp(lambda *a: fused_gru(*a, True)[0],
                   jnp.asarray(xp).astype(jdtype), jnp.asarray(wh),
                   jnp.asarray(bn), jnp.asarray(h0))
  want = vjp(jnp.asarray(g))
  for a, w, what in zip(got, want, GRADS):
    a = a.float().numpy()
    w = np.asarray(w.astype(jnp.float32))
    _scaled_close(a, w, RTOL[dtype], what)
    if dtype == torch.bfloat16:
      a, w = a.ravel().astype(np.float64), w.ravel().astype(np.float64)
      assert a @ w / (np.linalg.norm(a) * np.linalg.norm(w)) > 0.999, what


@pytest.mark.parametrize('batch,tiles', [(1, 1), (15, 1), (16, 1), (17, 2),
                                         (40, 3), (128, 8)])
def test_batch_tile_rule(batch, tiles):
  assert k_gru.batch_tiles(batch) == tiles
  # Every row lands in exactly one tile, and a tile holds at most 16 rows.
  assert (tiles - 1) * k_gru.TILE_ROWS < batch <= tiles * k_gru.TILE_ROWS


@pytest.mark.parametrize('hidden,cluster', [(64, 2), (128, 4), (256, 8),
                                            (512, 16)])
def test_cluster_shape(hidden, cluster):
  assert k_gru.cluster_shape(hidden) == (cluster, 32)


@pytest.mark.parametrize('hidden', [32, 96, 1024])
def test_wrapper_raises_on_a_hidden_size_it_does_not_take(hidden):
  """The bf16 kernels' wrapper names the shape and refuses it before any
  CUDA call (so this holds on the CPU); the plain path takes any H."""
  xp, wh, bn, h0, g = _inputs(2, 3, hidden, seed=24)
  g_t, xp_t, h_prev, wh_s, bn_t = _time_major(xp, wh, bn, h0, g,
                                              torch.bfloat16)
  h0_t = torch.from_numpy(h0)
  with pytest.raises(ValueError, match=f'H={hidden}'):
    k_gru._launch_fwd(xp_t, wh_s, bn_t, h0_t)
  with pytest.raises(ValueError, match=f'H={hidden}'):
    k_gru._launch_bwd(g_t, xp_t, h_prev, wh_s, bn_t)
  ys = k_gru.gru_sequence(xp_t, torch.from_numpy(wh), bn_t, h0_t)
  assert ys.shape == (3, 2, hidden) and torch.isfinite(ys).all()
