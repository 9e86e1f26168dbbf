"""K2's Hopper kernels on the CPU: what surrounds them, in Python.

The weight-gradient pass of K2b (bf16 cluster route) is a split-K GEMM on
the card: `wgrad_plan` cuts dwh [H, 3H] = h_prev^T dhp into output tiles
and K into slices, one CTA per tile and slice, a cluster per tile that adds
its slices' partials in rank order. Here: every row of K and every output
tile is covered exactly once, the wave rule holds, and the kernel's order
of summation (`gru_wgrad_split_plain`) agrees with the plain pass and with
the JAX package's Pallas VJP (interpret mode); past 512 units (the
cooperative route's bf16 streams) the pass takes H a multiple of 128. The
CUDA kernel is held against these plain versions on the card by
chip_smoke.py.

K2f's routes (`fwd_route`): the step kernel for float32 streams at T = 1,
the cluster kernels for bf16 up to 512 units, the cooperative kernels
otherwise.

FastGRU's stream dtype follows the JAX package's gru_kernel_supported
(ddsp_tpu/ops/pallas_kernels/gru.py:84): bf16 streams only from
MIN_BF16_STEPS steps and at a multiple of 128 units; elsewhere, as the
tiny preset's 64 units, the float32 recurrence of the JAX scan.

Tolerances, relative to the largest element of the reference:
- 1e-5 for the split order against the plain pass: the same exact
  products, float32 sums in another order;
- the bf16 tier of tests/test_torch_gru_tiles.py (2e-2, cosine > 0.999)
  against the Pallas VJP, whose dxp and dhp round to bf16 where the two
  float32 computations differ in the last bits;
- 1e-5 absolute for FastGRU against the JAX scan: both float32
  recurrences (bf16 operands in the input projection, exact products),
  summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn.layers import FastGRU as JaxFastGRU
from ddsp_tpu.ops.pallas_kernels import fused_gru
from ddsp_torch.kernels import gru as k_gru
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

N_SMS = 132  # an H100's SMs


def _scaled_close(a, b, rtol, what):
  a = np.asarray(a, np.float64).ravel()
  b = np.asarray(b, np.float64).ravel()
  scale = max(np.abs(b).max(), 1e-12)
  np.testing.assert_allclose(a / scale, b / scale, atol=rtol, err_msg=what)


@pytest.mark.parametrize('rows', [1, 24, 1000, 16000, 128000])
@pytest.mark.parametrize('hidden', [64, 128, 256, 512, 768, 1024])
def test_wgrad_plan_covers_every_row_and_tile_once(hidden, rows):
  plan = k_gru.wgrad_plan(hidden, rows, N_SMS)
  bm, bn, splits = plan['bm'], plan['bn'], plan['splits']
  blocks = k_gru.wgrad_blocks(plan, hidden, rows)
  assert len(blocks) == plan['tiles'] * splits
  # The output tiles partition dwh [H, 3H]; none straddles dxp's first 2H
  # columns and dhn.
  tiles = sorted({(m0, n0) for m0, n0, _, _ in blocks})
  assert tiles == [(m, n) for m in range(0, hidden, bm)
                   for n in range(0, 3 * hidden, bn)]
  assert all(n0 // hidden == (n0 + bn - 1) // hidden for _, n0 in tiles)
  # Each tile's slices are consecutive CTAs (one cluster) and cover the K
  # rows exactly once, in order, each a non-empty run of whole chunks.
  for m0, n0 in tiles:
    mine = [b for b in blocks if b[:2] == (m0, n0)]
    assert mine == blocks[blocks.index(mine[0]):][:splits]
    bounds = [(r0, r1) for _, _, r0, r1 in mine]
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(r1 == nxt for (_, r1), (nxt, _) in zip(bounds, bounds[1:]))
    assert all(r0 < r1 and r0 % plan['chunk'] == 0 for r0, r1 in bounds)
  # The wave rule: every CTA in one wave, at most a portable cluster a
  # tile, and no slice thinner than WGRAD_MIN_SLICE_CHUNKS chunks.
  assert 1 <= splits <= k_gru.WGRAD_MAX_SPLITS
  assert plan['tiles'] * splits <= N_SMS
  assert splits == 1 or (plan['chunks'] // splits >=
                         k_gru.WGRAD_MIN_SLICE_CHUNKS)
  if rows >= 16000:  # enough rows: the largest split the rule allows
    assert splits == min(k_gru.WGRAD_MAX_SPLITS, N_SMS // plan['tiles'])


def test_wgrad_plan_keeps_every_cluster_resident():
  """Where fewer clusters of a size fit the card than there are tiles, the
  plan takes smaller clusters (an H100 holds 22 clusters of 5 of the
  128 x 256 kernel, 30 of 4: measured by chip_smoke.py)."""
  held = {5: 22, 4: 30}
  seen = []

  def max_clusters(bm, bn, splits):
    seen.append((bm, bn, splits))
    return held.get(splits, 0)

  plan = k_gru.wgrad_plan(512, 16000, N_SMS, max_clusters)
  assert plan['splits'] == 4 and seen == [(128, 256, 5), (128, 256, 4)]
  assert k_gru.wgrad_plan(512, 16000, N_SMS, lambda *a: 0)['splits'] == 1


def test_wgrad_plan_refuses_what_the_kernel_does_not_take():
  with pytest.raises(ValueError, match='H in'):
    k_gru.wgrad_plan(96, 1000, N_SMS)  # the wrapper pads 96 to 128 first
  with pytest.raises(ValueError, match='H in'):
    k_gru.wgrad_plan(1000, 1000, N_SMS)  # past 512: a multiple of 128
  with pytest.raises(ValueError, match='rows'):
    k_gru.wgrad_plan(512, 0, N_SMS)


def test_wgrad_launch_checks_its_streams():
  """The kernel reads h_prev, dxp and dhn through TMA tensor maps built
  from their shapes: a wrong shape, dtype or layout raises before any
  launch, as does a CPU tensor (the CPU takes the plain pass)."""
  h_prev, dxp, dhn, tiles = _streams(3, 2, 64, seed=5)
  with pytest.raises(ValueError, match='dxp'):
    k_gru._launch_wgrad(h_prev, dxp[..., :128], dhn, tiles)
  with pytest.raises(ValueError, match='TMA'):
    k_gru._launch_wgrad(h_prev.float(), dxp, dhn, tiles)
  with pytest.raises(ValueError, match='TMA'):
    k_gru._launch_wgrad(h_prev, dxp, dhn.transpose(0, 1).contiguous()
                        .transpose(0, 1), tiles)
  with pytest.raises(ValueError, match='dbn_tiles'):
    k_gru._launch_wgrad(h_prev, dxp, dhn, tiles.double())
  with pytest.raises(ValueError, match='CUDA'):
    k_gru._launch_wgrad(h_prev, dxp, dhn, tiles)


def _streams(t, b, h, seed):
  """h_prev, dxp, dhn in bf16 and float32 tile sums, from numpy."""
  rng = np.random.RandomState(seed)
  as_bf16 = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
  return (as_bf16(rng.uniform(-1, 1, (t, b, h))),
          as_bf16(rng.randn(t, b, 3 * h) * 0.01),
          as_bf16(rng.randn(t, b, h) * 0.01),
          torch.from_numpy(rng.randn(k_gru.batch_tiles(b), h).astype(
              np.float32)))


@pytest.mark.parametrize('t,b,h,n_sms', [(24, 40, 64, N_SMS),
                                         (250, 16, 512, N_SMS),
                                         (100, 7, 128, 16)])
def test_split_order_matches_the_plain_pass(t, b, h, n_sms):
  streams = _streams(t, b, h, seed=h + t)
  plan = k_gru.wgrad_plan(h, t * b, n_sms)
  assert plan['splits'] > 1
  got = k_gru.gru_wgrad_split_plain(*streams, plan)
  want = k_gru.gru_wgrad_plain(*streams)
  for a, w, what in zip(got, want, ('dwh', 'dbn')):
    assert a.dtype == torch.float32 and a.shape == w.shape
    _scaled_close(a.numpy(), w.numpy(), 1e-5, what)


def test_split_order_matches_the_pallas_vjp():
  """dwh and dbn through the split order from the serial pass's streams,
  against the JAX package's fused_gru VJP (interpret mode), bf16 streams."""
  b, t, h = 17, 32, 64
  rng = np.random.RandomState(31)
  xp = (rng.randn(b, t, 3 * h) * 0.3).astype(np.float32)
  xp = np.array(jnp.asarray(xp).astype(jnp.bfloat16).astype(jnp.float32))
  wh = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
  bn = (rng.randn(h) * 0.1).astype(np.float32)
  h0 = (rng.randn(b, h) * 0.1).astype(np.float32)
  g = rng.randn(b, t, h).astype(np.float32)
  xp_t = torch.from_numpy(xp).transpose(0, 1).contiguous().bfloat16()
  wh_s = torch.from_numpy(wh).bfloat16()
  bn_t, h0_t = torch.from_numpy(bn), torch.from_numpy(h0)
  h_prev = k_gru.h_prev_stream(
      h0_t, k_gru.gru_sequence_plain(xp_t, wh_s, bn_t, h0_t), torch.bfloat16)
  g_t = torch.from_numpy(g).transpose(0, 1).contiguous()
  dxp, dhn, dbn_tiles, _ = k_gru.gru_bwd_serial_plain(g_t, xp_t, h_prev,
                                                      wh_s, bn_t)
  plan = k_gru.wgrad_plan(h, t * b, N_SMS)
  assert plan['splits'] == 2
  got = k_gru.gru_wgrad_split_plain(h_prev, dxp, dhn, dbn_tiles, plan)
  _, vjp = jax.vjp(lambda *a: fused_gru(*a, True)[0],
                   jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(wh),
                   jnp.asarray(bn), jnp.asarray(h0))
  want = vjp(jnp.asarray(g))[1:3]
  for a, w, what in zip(got, want, ('dwh', 'dbn')):
    a = a.numpy().astype(np.float64).ravel()
    w = np.asarray(w, np.float64).ravel()
    _scaled_close(a, w, 2e-2, what)
    assert a @ w / (np.linalg.norm(a) * np.linalg.norm(w)) > 0.999, what


@pytest.mark.parametrize('hidden', [64, 512, 1024])
@pytest.mark.parametrize('seq_len', [1, 2, 8])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_fwd_route(dtype, seq_len, hidden):
  if dtype == torch.float32:
    want = 'step' if seq_len == 1 else 'cooperative'
  else:
    want = 'cluster' if hidden <= 512 else 'cooperative'
  assert k_gru.fwd_route(dtype, seq_len, hidden) == want


def _jax_fast_gru_params(jax_gru, x, rng):
  params = jax.tree_util.tree_map(np.asarray, jax.jit(jax_gru.init)(
      jax.random.PRNGKey(0), jnp.asarray(x))['params'])
  params['bi'] = (rng.randn(*params['bi'].shape) * 0.1).astype(np.float32)
  params['bn'] = (rng.randn(*params['bn'].shape) * 0.1).astype(np.float32)
  return params


def _against_jax(port, x, rng):
  """The port's FastGRU (bf16 mode) and the JAX FastGRU with its default
  routing (the float32 scan on the CPU) on the same parameters and x."""
  jax_gru = JaxFastGRU(dims=port.dims, compute_dtype='bfloat16')
  params = _jax_fast_gru_params(jax_gru, x, rng)
  load_jax_params(port, params)
  h0 = (rng.randn(x.shape[0], port.dims) * 0.3).astype(np.float32)
  ys_j, hf_j = jax_gru.apply({'params': params}, jnp.asarray(x),
                             initial_state=jnp.asarray(h0), return_state=True)
  with torch.no_grad():
    ys_t, hf_t = port(torch.from_numpy(x), initial_state=torch.from_numpy(h0),
                      return_state=True)
  np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=1e-5)
  np.testing.assert_allclose(hf_t.numpy(), np.asarray(hf_j), atol=1e-5)


@pytest.mark.parametrize('hidden', [64, 96])
def test_fast_gru_off_the_128_multiple_matches_the_jax_scan(hidden):
  rng = np.random.RandomState(hidden)
  x = rng.randn(2, 24, 16).astype(np.float32)
  _against_jax(t_layers.FastGRU(16, hidden, compute_dtype='bfloat16'), x,
               rng)


def test_tiny_preset_decoder_gru_matches_the_jax_scan():
  port = build_model('tiny', device='cpu', seed=0).decoder.rnn.FastGRU_0
  assert port.dtype == torch.bfloat16 and port.dims == 64
  rng = np.random.RandomState(7)
  x = rng.randn(2, 24, port.wi.shape[0]).astype(np.float32)
  _against_jax(port, x, rng)
