"""The batch-tiled, split backward of kernel family K2 on the CPU.

With bf16 streams the port's K2b is two kernels: a serial reverse-time pass
that emits dxp, the dhn stream, per-tile dbn sums and dh0
(`gru_bwd_serial_plain` is its plain version), and a weight-gradient pass
over K = T * B rows (`gru_wgrad_plain`). Their composition is held here
against the plain K2b (`gru_bwd_plain`) and the JAX package's Pallas VJP
(interpret mode). The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py.

The bf16 route of any H: `bf16_route` (the cluster kernels at the next size
they take, or the cooperative kernels past 512 units), the zero padding of
the cluster route (exact, bit for bit), the cooperative kernels' plan (CTAs
per tile, tiles per co-resident launch) and their wrappers' glue, the
float32 cooperative K2b's order of summation (`gru_bwd_tiles_plain`), and
the FastGRU of solo_instrument(rnn_channels=384) against the JAX package's.

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


@pytest.mark.parametrize('hidden,route', [
    (32, ('cluster', 64)), (96, ('cluster', 128)), (384, ('cluster', 512)),
    (512, ('cluster', 512)), (1024, ('cooperative', 1024))])
def test_bf16_route(hidden, route):
  """bf16 K2 takes any H: up to 512 the cluster kernels at the next size
  they take (zero-padded), past it the cooperative kernels."""
  assert k_gru.bf16_route(hidden) == route
  if route[0] == 'cluster':
    assert route[1] in k_gru.CLUSTER_HIDDEN
    assert k_gru.cluster_shape(route[1])[0] <= 16


def _matmul_in_sequence(a, b):
  """a @ b for 2-D a, b, each output summed over K one term at a time in
  index order, whatever K is."""
  out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
  for k in range(a.shape[1]):
    out += a[:, k:k + 1] * b[k:k + 1]
  return out


@pytest.mark.parametrize('hidden,h_pad', [(96, 128), (384, 512)])
def test_zero_padding_is_exact(hidden, h_pad, monkeypatch):
  """The padding of the cluster route changes no bit: in bf16 plain, the
  padded run's forward and its four backward outputs, sliced back, equal
  the unpadded ones, and the padded units stay exactly 0.

  The products run in index order over K: MKL's sgemm blocks K (at
  K = 512 it sums in two blocks, at 384 in one), which moves the last bit
  of a sum by its own choice of order (1.5e-5 at H = 384), not by the
  padding; the padded terms themselves add exact zeros."""
  monkeypatch.setattr(torch.Tensor, '__matmul__', _matmul_in_sequence)
  xp, wh, bn, h0, g = _inputs(3, 6, hidden, seed=25)
  g_t, xp_t, h_prev, wh_s, bn_t = _time_major(xp, wh, bn, h0, g,
                                              torch.bfloat16)
  h0_t = torch.from_numpy(h0)
  ys = k_gru.gru_sequence_plain(xp_t, wh_s, bn_t, h0_t)
  want = k_gru.gru_bwd_plain(g_t, xp_t, h_prev, wh_s, bn_t)
  xp_p, wh_p, bn_p, h0_p, g_p = k_gru.pad_gru_inputs(h_pad, xp_t, wh_s, bn_t,
                                                     h0_t, g_t)
  assert xp_p.shape[-1] == 3 * h_pad and wh_p.shape == (h_pad, 3 * h_pad)
  ys_p = k_gru.gru_sequence_plain(xp_p, wh_p, bn_p, h0_p)
  assert torch.equal(ys_p[..., :hidden], ys)
  assert torch.count_nonzero(ys_p[..., hidden:]) == 0
  h_prev_p = k_gru.h_prev_stream(h0_p, ys_p, torch.bfloat16)
  assert torch.equal(h_prev_p, k_gru.pad_gru_inputs(
      h_pad, xp_t, wh_s, bn_t, h_prev)[3])
  dxp, dwh, dbn, dh0 = k_gru.gru_bwd_plain(g_p, xp_p, h_prev_p, wh_p, bn_p)
  got = (k_gru.unpad_gates(dxp, hidden),
         k_gru.unpad_gates(dwh[:hidden], hidden), dbn[:hidden],
         dh0[:, :hidden])
  for a, b, what in zip(got, want, GRADS):
    assert a.dtype == b.dtype and torch.equal(a, b), what
  for t in (dbn[hidden:], dh0[:, hidden:], dwh[hidden:],
            dwh.unflatten(-1, (3, h_pad))[..., hidden:],
            dxp.unflatten(-1, (3, h_pad))[..., hidden:]):
    assert torch.count_nonzero(t) == 0


@pytest.mark.parametrize('hidden', [96, 512])
def test_cluster_route_pads_and_slices_back(hidden, monkeypatch):
  """The wrappers' glue of the cluster route on the CPU, with the plain
  versions standing in for the kernels (which see only H in
  CLUSTER_HIDDEN): K2f and both K2b passes through `_launch_fwd` and
  `_launch_bwd` give what the plain versions give at H (the forward bit
  for bit, the backward at the bf16 tolerance of the split)."""
  def cluster_only(fn):
    def run(*args):
      assert args[-1].shape[-1] in k_gru.CLUSTER_HIDDEN
      return fn(*args)
    return run

  monkeypatch.setattr(k_gru, '_cuda_check', lambda device: None)
  monkeypatch.setattr(k_gru, '_launch_cluster_fwd',
                      lambda xp, wh, bn, h0: k_gru.gru_sequence_plain(
                          xp, wh, bn, cluster_only(lambda t: t)(h0)))
  monkeypatch.setattr(k_gru, '_launch_bwd_serial',
                      cluster_only(k_gru.gru_bwd_serial_plain))
  monkeypatch.setattr(k_gru, '_launch_wgrad', k_gru.gru_wgrad_plain)
  xp, wh, bn, h0, g = _inputs(3, 5, hidden, seed=27)
  g_t, xp_t, h_prev, wh_s, bn_t = _time_major(xp, wh, bn, h0, g,
                                              torch.bfloat16)
  h0_t = torch.from_numpy(h0)
  ys = k_gru._launch_fwd(xp_t, wh_s, bn_t, h0_t)
  assert torch.equal(ys, k_gru.gru_sequence_plain(xp_t, wh_s, bn_t, h0_t))
  got = k_gru._launch_bwd(g_t, xp_t, h_prev, wh_s, bn_t)
  want = k_gru.gru_bwd_plain(g_t, xp_t, h_prev, wh_s, bn_t)
  for a, b, what in zip(got, want, GRADS):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    _scaled_close(a.float().numpy(), b.float().numpy(),
                  RTOL[torch.bfloat16], what)


# An H100 as the cooperative kernels' occupancy query sees it: 132 SMs,
# 227 KB of shared memory a block. The stand-in mirrors csrc/gru.cu's
# coop_fwd_smem / coop_bwd_smem and the float32 backward's register bound
# (dwh's accumulators: h_pad <= 128 * 8 at u = 8, 128 * 4 at u = 16).
N_SMS, SMEM = 132, 232448


def _coop_smem(units, h_pad, bf16, backward):
  item = 2 if bf16 else 4
  ld = lambda k: ((k * item // 4 + 31) // 32 * 32 + 4) * 4 // item
  pad = lambda n: n + (8 if (n // 8) % 2 == 0 else 0)
  a16 = lambda n: (n + 15) // 16 * 16
  cols = 3 * units
  w_col = a16(cols * ld(h_pad) * item)
  if not backward:
    return w_col + 4 * (8 * 16 * pad(cols) + 16 * units)
  return (w_col + a16(units * ld(3 * h_pad) * item) +
          4 * (8 * 16 * pad(cols) + 16 * cols))


def _h100_fits(bf16, backward):
  def fits(units, h_pad):
    if (backward and not bf16 and
        h_pad > 128 * (8 if units == 8 else 4)):
      return 0
    return 1 if _coop_smem(units, h_pad, bf16, backward) <= SMEM else 0
  return fits


@pytest.mark.parametrize('batch', [1, 16, 40])
@pytest.mark.parametrize('bf16,hidden', [(True, 640), (True, 768),
                                         (True, 1024), (False, 64),
                                         (False, 512), (False, 1024)])
def test_cooperative_plan(bf16, hidden, batch):
  """Every unit is owned by exactly one CTA, every row lies in exactly one
  tile and one launch, and each launch is one co-resident grid on the
  stand-in's H100, in both directions."""
  step = k_gru.COOP_MMA_K[bf16]
  for backward in (False, True):
    fits = _h100_fits(bf16, backward)
    plan = k_gru.plan_cooperative(hidden, batch, N_SMS, fits, bf16)
    units, h_pad = plan['units'], plan['h_pad']
    assert units in k_gru.COOP_UNITS and h_pad % units == 0
    assert h_pad % step == 0 and 0 <= h_pad - hidden < max(units, step)
    # CTA j owns units [j u, j u + u): a partition of the padded units.
    owned = sorted(j * units + i for j in range(plan['ctas'])
                   for i in range(units))
    assert owned == list(range(h_pad))
    assert plan['ctas'] <= N_SMS
    assert plan['ctas'] * plan['tiles_per_launch'] <= fits(units, h_pad) * N_SMS
    launched = k_gru.coop_launches(plan, batch)
    assert len(launched) == plan['launches']
    rows = [b for _, _, b0, nb in launched for b in range(b0, b0 + nb)]
    assert rows == list(range(batch))
    tiles = [t for t0, n, _, _ in launched for t in range(t0, t0 + n)]
    assert tiles == list(range(k_gru.batch_tiles(batch)))
    assert all(0 < nb <= n * k_gru.TILE_ROWS and n <= plan['tiles_per_launch']
               for _, n, _, nb in launched)
    # The fewest launches any u gives.
    for other in k_gru.COOP_UNITS:
      o_pad = k_gru.coop_h_pad(hidden, other, bf16)
      cap = fits(other, o_pad) * N_SMS
      if o_pad // other <= cap:
        per = min(plan['tiles'], cap // (o_pad // other))
        assert plan['launches'] <= -(-plan['tiles'] // per)


@pytest.mark.parametrize('hidden,fits,match', [
    (1024, lambda u, h_pad: 0, 'H=1024'),     # no slice of wh fits an SM
    (4096, lambda u, h_pad: 1, '132 SMs'),    # more CTAs than SMs
])
def test_cooperative_plan_raises_where_one_row_does_not_fit(hidden, fits,
                                                            match):
  """Where not even one tile of rows makes a co-resident grid at any u, the
  planner raises."""
  with pytest.raises(RuntimeError, match=match):
    k_gru.plan_cooperative(hidden, 16, N_SMS, fits, True)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tiles_order_matches_plain_k2b(dtype):
  # B = 40: three tiles of 16 rows, the last one ragged.
  args = _time_major(*_inputs(40, 10, 64, seed=28), dtype)
  got = k_gru.gru_bwd_tiles_plain(*args)
  want = k_gru.gru_bwd_plain(*args)
  assert torch.equal(got[0], want[0]) and torch.equal(got[3], want[3])
  for a, b, what in zip(got, want, GRADS):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    _scaled_close(a.float().numpy(), b.float().numpy(), RTOL[dtype], what)


@pytest.mark.parametrize('dtype,jdtype,b,seed', [
    (torch.float32, jnp.float32, 3, 29),
    (torch.bfloat16, jnp.bfloat16, 17, 30),
])
def test_tiles_order_matches_pallas_vjp(dtype, jdtype, b, seed):
  xp, wh, bn, h0, g = _inputs(b, 24, 64, seed)
  xp = np.array(jnp.asarray(xp).astype(jdtype).astype(jnp.float32))
  got = k_gru.gru_bwd_tiles_plain(*_time_major(xp, wh, bn, h0, g, dtype))
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


@pytest.mark.parametrize('dtype,hidden', [(torch.bfloat16, 520),
                                          (torch.bfloat16, 640),
                                          (torch.float32, 40)])
def test_cooperative_route_glue(dtype, hidden, monkeypatch):
  """`_launch_bwd` on the cooperative route on the CPU, with plain versions
  standing in for the kernels: bf16 adds the weight-gradient pass (the
  streams zero-padded to a multiple of 128 where H is not one), float32
  adds the tiles' dwh and dbn in order; both give `gru_bwd_plain`'s
  gradients at the tolerance of the split."""
  def coop_bwd(g, xp, h_prev, wh, bn):
    dxp, dhn, dbn_tiles, dh0 = k_gru.gru_bwd_serial_plain(g, xp, h_prev, wh,
                                                          bn)
    if dtype == torch.bfloat16:
      return dxp, dhn, dbn_tiles, dh0
    dwh_tiles = torch.stack([
        k_gru.gru_bwd_plain(g[:, b0:b0 + 16], xp[:, b0:b0 + 16],
                            h_prev[:, b0:b0 + 16], wh, bn)[1]
        for b0 in range(0, xp.shape[1], 16)])
    return dxp, dwh_tiles, dbn_tiles, dh0

  def wgrad(h_prev, dxp, dhn, dbn_tiles):
    k_gru.wgrad_tile(h_prev.shape[-1])  # raises where the kernel would
    return k_gru.gru_wgrad_plain(h_prev, dxp, dhn, dbn_tiles)

  monkeypatch.setattr(k_gru, '_cuda_check', lambda device: None)
  monkeypatch.setattr(k_gru, '_launch_coop_bwd', coop_bwd)
  monkeypatch.setattr(k_gru, '_launch_wgrad', wgrad)
  args = _time_major(*_inputs(20, 3, hidden, seed=hidden), dtype)
  got = k_gru._launch_bwd(*args)
  want = (k_gru.gru_bwd_tiles_plain(*args) if dtype == torch.float32 else
          k_gru.gru_bwd_plain(*args))
  for a, b, what in zip(got, want, GRADS):
    assert a.shape == b.shape and a.dtype == b.dtype, what
    _scaled_close(a.float().numpy(), b.float().numpy(), RTOL[dtype], what)


def test_solo_instrument_384_gru_matches_the_jax_fast_gru():
  """solo_instrument(rnn_channels=384)'s FastGRU (bf16) on the CPU against
  the JAX package's FastGRU, which takes its Pallas kernel at H = 384 (a
  multiple of 128), in interpret mode: values and the gradients of every
  parameter, at the bf16 tolerances of tests/test_torch_kernels.py."""
  from ddsp_tpu.nn.layers import FastGRU as JaxFastGRU
  from ddsp_torch.utils import build_model, load_jax_params
  port = build_model('solo_instrument', device='cpu', rnn_channels=384,
                     seed=0).decoder.rnn.FastGRU_0
  assert (port.wh.shape, port.dtype) == ((384, 1152), torch.bfloat16)
  rng = np.random.RandomState(26)
  x = rng.randn(2, 8, 1024).astype(np.float32)
  jax_gru = JaxFastGRU(dims=384, compute_dtype='bfloat16', use_pallas=True)
  params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_gru.init)(
      jax.random.PRNGKey(0), jnp.asarray(x))['params'])
  params['bi'] = (rng.randn(1152) * 0.1).astype(np.float32)
  params['bn'] = (rng.randn(384) * 0.1).astype(np.float32)
  load_jax_params(port, params)
  g = rng.randn(2, 8, 384).astype(np.float32)

  def jax_loss(p):
    ys, h = jax_gru.apply({'params': p}, jnp.asarray(x), return_state=True)
    return jnp.sum(ys * g) + jnp.sum(h * g[:, -1]), (ys, h)

  (_, (ys_j, hf_j)), grads_j = jax.value_and_grad(jax_loss, has_aux=True)(
      jax.tree_util.tree_map(jnp.asarray, params))
  ys_t, hf_t = port(torch.from_numpy(x), return_state=True)
  loss = (ys_t * torch.from_numpy(g)).sum() + (
      hf_t * torch.from_numpy(g[:, -1])).sum()
  grads_t = dict(zip(('wi', 'wh', 'bi', 'bn'), torch.autograd.grad(
      loss, [port.wi, port.wh, port.bi, port.bn])))
  np.testing.assert_allclose(ys_t.detach().numpy(), np.asarray(ys_j),
                             atol=5e-2)
  np.testing.assert_allclose(hf_t.detach().numpy(), np.asarray(hf_j),
                             atol=5e-2)
  for name, got in grads_t.items():
    a = got.numpy().astype(np.float64).ravel()
    b = np.asarray(grads_j[name], np.float64).ravel()
    _scaled_close(a, b, 2e-2, name)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999, name
