"""The plain versions of kernels K1 and K2, forward and backward, against
the JAX package's Pallas kernels (interpret mode) and jnp paths, on the CPU.

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py. Tolerances, forward: K1 4e-3
(tests/test_pallas_harmonic.py); K2 1e-5 in float32 and 5e-2 with bf16 xp
(tests/test_pallas_gru.py). Backward: K1 cotangents scaled by their largest
element, atol 5e-3 (tests/test_pallas_harmonic.py); K2 1e-5 scaled in
float32, and with bf16 xp 2e-2 scaled and cosine > 0.999 (the reference
asks cosine > 0.99 of its own bf16 gradients). Shapes stay small (T <= 64,
H <= 128, <= 4000 samples) because interpret mode is slow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn.layers import FastGRU as JaxFastGRU
from ddsp_tpu.ops import oscillator as j_osc
from ddsp_tpu.ops.pallas_kernels import fused_gru, fused_harmonic_synthesis
from ddsp_tpu.ops.resample import resample as j_resample
from ddsp_torch.kernels import gru as k_gru
from ddsp_torch.kernels import harmonic as k_harmonic
from ddsp_torch.nn.layers import FastGRU
from ddsp_torch.utils.convert import load_jax_params

torch.set_num_threads(1)

SR = 16000


def _harmonic_inputs(hop, n_frames=12, n_harmonics=20, seed=0):
  """phase0, f0_env [B, n] and ham [B, n_frames, H]; f0 reaches Nyquist."""
  rng = np.random.RandomState(seed)
  f0 = (200.0 + 2000.0 * rng.rand(2, n_frames, 1)).astype(np.float32)
  ham = (rng.rand(2, n_frames, 1) *
         rng.rand(2, n_frames, n_harmonics)).astype(np.float32)
  n = n_frames * hop
  f0_env = j_resample(jnp.asarray(f0), n)
  phase0 = jnp.cumsum(f0_env * 2 * np.pi / SR, axis=1)[..., 0]
  return np.array(phase0), np.array(f0_env[..., 0]), ham, f0


@pytest.mark.parametrize('method', ['window', 'linear'])
@pytest.mark.parametrize('hop', [32, 64, 128, 320])
def test_harmonic_plain_matches_pallas_and_jnp(method, hop):
  phase0, f0_env, ham, f0 = _harmonic_inputs(hop)
  assert (f0_env * ham.shape[-1] >= SR / 2).any()  # the mask is exercised
  out_t = k_harmonic.fused_harmonic_synthesis(
      torch.from_numpy(phase0), torch.from_numpy(f0_env),
      torch.from_numpy(ham), SR, method).numpy()
  out_pallas = fused_harmonic_synthesis(
      jnp.asarray(phase0), jnp.asarray(f0_env), jnp.asarray(ham),
      sample_rate=SR, amp_resample_method=method, interpret=True)
  np.testing.assert_allclose(out_t, np.asarray(out_pallas), atol=4e-3)
  # The jnp path from frame controls (harmonic distribution = ham, amps 1).
  out_jnp = j_osc.harmonic_synthesis(
      jnp.asarray(f0), jnp.ones_like(jnp.asarray(f0)),
      harmonic_distribution=jnp.asarray(ham), n_samples=phase0.shape[1],
      sample_rate=SR, amp_resample_method=method, use_pallas=False)
  np.testing.assert_allclose(out_t, np.asarray(out_jnp), atol=4e-3)


def test_harmonic_wrapper_checks_inputs():
  phase0, f0_env, ham, _ = _harmonic_inputs(64)
  args = [torch.from_numpy(a) for a in (phase0, f0_env, ham)]
  with pytest.raises(ValueError, match='supports'):
    k_harmonic.fused_harmonic_synthesis(*args, SR, 'cubic')
  with pytest.raises(ValueError, match='n_frames'):
    k_harmonic.fused_harmonic_synthesis(args[0][:, :-1], args[1][:, :-1],
                                        args[2], SR)
  with pytest.raises(TypeError, match='float32'):
    k_harmonic.fused_harmonic_synthesis(args[0].double(), args[1], args[2])


def _gru_inputs(b=4, t=24, h=64, seed=0):
  rng = np.random.RandomState(seed)
  xp = (rng.randn(b, t, 3 * h) * 0.3).astype(np.float32)
  wh = (rng.randn(h, 3 * h) / np.sqrt(h)).astype(np.float32)
  bn = (rng.randn(h) * 0.1).astype(np.float32)
  h0 = (rng.randn(b, h) * 0.1).astype(np.float32)
  return xp, wh, bn, h0


def _plain_gru(xp, wh, bn, h0, dtype=torch.float32):
  xp_t = torch.from_numpy(xp).transpose(0, 1).contiguous().to(dtype)
  ys = k_gru.gru_sequence(xp_t, torch.from_numpy(wh), torch.from_numpy(bn),
                          torch.from_numpy(h0))
  assert ys.dtype == torch.float32
  return ys.transpose(0, 1).numpy()


@pytest.mark.parametrize('t,h', [(24, 64), (64, 128)])
def test_gru_plain_matches_pallas_f32(t, h):
  xp, wh, bn, h0 = _gru_inputs(t=t, h=h, seed=t)
  ys_p, hf_p = fused_gru(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bn),
                         jnp.asarray(h0), True)
  ys_t = _plain_gru(xp, wh, bn, h0)
  np.testing.assert_allclose(ys_t, np.asarray(ys_p), atol=1e-5)
  np.testing.assert_allclose(ys_t[:, -1], np.asarray(hf_p), atol=1e-5)


def test_gru_plain_matches_pallas_bf16():
  xp, wh, bn, h0 = _gru_inputs(b=8, t=64, h=128, seed=9)
  ys_p, _ = fused_gru(jnp.asarray(xp).astype(jnp.bfloat16), jnp.asarray(wh),
                      jnp.asarray(bn), jnp.asarray(h0), True)
  xp_bf16 = np.array(jnp.asarray(xp).astype(jnp.bfloat16).astype(
      jnp.float32))
  ys_t = _plain_gru(xp_bf16, wh, bn, h0, torch.bfloat16)
  np.testing.assert_allclose(ys_t, np.asarray(ys_p), atol=5e-2)


def test_gru_wrapper_checks_inputs():
  xp, wh, bn, h0 = (torch.from_numpy(a) for a in _gru_inputs())
  xp_t = xp.transpose(0, 1).contiguous()
  with pytest.raises(ValueError, match='shapes'):
    k_gru.gru_sequence(xp_t, wh, bn[:-1], h0)
  with pytest.raises(TypeError, match='bfloat16'):
    k_gru.gru_sequence(xp_t.double(), wh, bn, h0)


def test_fast_gru_matches_jax_scan_f32():
  rng = np.random.RandomState(3)
  x = rng.randn(3, 40, 16).astype(np.float32)
  jax_gru = JaxFastGRU(dims=32, compute_dtype='float32', use_pallas=False)
  variables = jax_gru.init(jax.random.PRNGKey(0), jnp.asarray(x))
  params = jax.tree_util.tree_map(np.asarray, variables['params'])
  params['bi'] = rng.randn(96).astype(np.float32) * 0.1
  params['bn'] = rng.randn(32).astype(np.float32) * 0.1
  ys_j, hf_j = jax_gru.apply({'params': params}, jnp.asarray(x),
                             return_state=True)
  port = FastGRU(16, 32, compute_dtype='float32')
  load_jax_params(port, params)
  with torch.no_grad():
    ys_t, hf_t = port(torch.from_numpy(x), return_state=True)
  np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=1e-5)
  np.testing.assert_allclose(hf_t.numpy(), np.asarray(hf_j), atol=1e-5)


# ---------------------------------------------------------------------------
# Backward: the plain versions of K1t, K1p and K2b
# ---------------------------------------------------------------------------
def _scaled_close(a, b, atol, what):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  scale = max(np.abs(b).max(), 1e-12)
  np.testing.assert_allclose(a / scale, b / scale, atol=atol, err_msg=what)


def _harmonic_grads_torch(fn, phase0, f0_env, ham, g, method):
  p = torch.from_numpy(phase0).requires_grad_()
  a = torch.from_numpy(ham).requires_grad_()
  out = fn(p, torch.from_numpy(f0_env), a, SR, method)
  return torch.autograd.grad(out, (p, a), torch.from_numpy(g))


@pytest.mark.parametrize('method', ['window', 'linear'])
@pytest.mark.parametrize('hop', [64, 320])
def test_harmonic_backward_matches_pallas_vjp(method, hop):
  phase0, f0_env, ham, _ = _harmonic_inputs(hop, seed=hop)
  assert (f0_env * ham.shape[-1] >= SR / 2).any()  # some harmonics are cut
  g = np.random.RandomState(1).randn(*phase0.shape).astype(np.float32)
  _, vjp = jax.vjp(
      lambda p, a: fused_harmonic_synthesis(
          p, jnp.asarray(f0_env), a, sample_rate=SR,
          amp_resample_method=method, interpret=True),
      jnp.asarray(phase0), jnp.asarray(ham))
  dphase_j, dham_j = vjp(jnp.asarray(g))
  dphase_t, dham_t = _harmonic_grads_torch(
      k_harmonic.fused_harmonic_synthesis, phase0, f0_env, ham, g, method)
  # The endpoint fold: the last frame also gets the endpoint copy's share.
  assert np.abs(np.asarray(dham_j)[:, -1]).max() > 0
  _scaled_close(dham_t.numpy(), dham_j, 5e-3, 'dham')
  _scaled_close(dphase_t.numpy(), dphase_j, 5e-3, 'dphase')


@pytest.mark.parametrize('method', ['window', 'linear'])
def test_harmonic_plain_backward_matches_autograd_of_plain_forward(method):
  phase0, f0_env, ham, _ = _harmonic_inputs(64, seed=5)
  g = np.random.RandomState(2).randn(*phase0.shape).astype(np.float32)
  got = _harmonic_grads_torch(k_harmonic.fused_harmonic_synthesis, phase0,
                              f0_env, ham, g, method)
  ref = _harmonic_grads_torch(k_harmonic.harmonic_synthesis_plain, phase0,
                              f0_env, ham, g, method)
  for a, b, what in zip(got, ref, ('dphase', 'dham')):
    _scaled_close(a.numpy(), b.numpy(), 5e-3, what)


def test_harmonic_fold_taps_places_the_endpoint_on_the_last_frame():
  dtaps = torch.zeros(1, 3, 2, 1)
  dtaps[0, :, 0, 0] = torch.tensor([1.0, 2.0, 3.0])   # fall: frame k
  dtaps[0, :, 1, 0] = torch.tensor([10.0, 20.0, 30.0])  # rise: frame k + 1
  assert k_harmonic.fold_taps(dtaps)[0, :, 0].tolist() == [1.0, 12.0, 53.0]


def test_harmonic_backward_skips_the_phase_when_it_needs_no_gradient(
    monkeypatch):
  calls = {'taps': 0, 'phase': 0}
  taps, phase = (k_harmonic.harmonic_bwd_taps_plain,
                 k_harmonic.harmonic_bwd_phase_plain)

  def count(name, fn):
    def wrapped(*args, **kwargs):
      calls[name] += 1
      return fn(*args, **kwargs)
    return wrapped

  monkeypatch.setattr(k_harmonic, 'harmonic_bwd_taps_plain',
                      count('taps', taps))
  monkeypatch.setattr(k_harmonic, 'harmonic_bwd_phase_plain',
                      count('phase', phase))
  phase0, f0_env, ham, _ = _harmonic_inputs(64)
  a = torch.from_numpy(ham).requires_grad_()
  out = k_harmonic.fused_harmonic_synthesis(
      torch.from_numpy(phase0), torch.from_numpy(f0_env), a, SR)
  out.sum().backward()  # an expanded (stride 0) cotangent
  assert calls == {'taps': 1, 'phase': 0}
  assert torch.isfinite(a.grad).all() and float(a.grad.abs().max()) > 0
  p = torch.from_numpy(phase0).requires_grad_()
  k_harmonic.fused_harmonic_synthesis(p, torch.from_numpy(f0_env), a,
                                      SR).sum().backward()
  assert calls == {'taps': 2, 'phase': 1}
  assert float(p.grad.abs().max()) > 0
  # Serving keeps nothing for a backward pass.
  with torch.no_grad():
    out = k_harmonic.fused_harmonic_synthesis(
        p, torch.from_numpy(f0_env), a, SR)
  assert out.grad_fn is None


def _gru_grads_torch(xp, wh, bn, h0, g, dtype):
  leaves = [torch.from_numpy(xp).transpose(0, 1).contiguous().to(dtype),
            torch.from_numpy(wh), torch.from_numpy(bn), torch.from_numpy(h0)]
  leaves = [t.requires_grad_() for t in leaves]
  ys = k_gru.gru_sequence(*leaves)
  grads = torch.autograd.grad(
      ys, leaves, torch.from_numpy(g).transpose(0, 1).contiguous())
  return [grads[0].transpose(0, 1)] + list(grads[1:])


def _gru_grads_pallas(xp, wh, bn, h0, g, dtype):
  _, vjp = jax.vjp(lambda *a: fused_gru(*a, True)[0],
                   jnp.asarray(xp).astype(dtype), jnp.asarray(wh),
                   jnp.asarray(bn), jnp.asarray(h0))
  return vjp(jnp.asarray(g))


GRU_GRADS = ('dxp', 'dwh', 'dbn', 'dh0')


def test_gru_backward_matches_pallas_vjp_f32():
  xp, wh, bn, h0 = _gru_inputs(b=3, t=24, h=32, seed=11)
  g = np.random.RandomState(3).randn(3, 24, 32).astype(np.float32)
  got = _gru_grads_torch(xp, wh, bn, h0, g, torch.float32)
  ref = _gru_grads_pallas(xp, wh, bn, h0, g, jnp.float32)
  for a, b, what in zip(got, ref, GRU_GRADS):
    assert a.dtype == torch.float32
    _scaled_close(a.numpy(), b, 1e-5, what)


def test_gru_backward_matches_pallas_vjp_bf16():
  xp, wh, bn, h0 = _gru_inputs(b=16, t=32, h=32, seed=12)
  xp = np.array(jnp.asarray(xp).astype(jnp.bfloat16).astype(jnp.float32))
  g = np.random.RandomState(4).randn(16, 32, 32).astype(np.float32)
  got = _gru_grads_torch(xp, wh, bn, h0, g, torch.bfloat16)
  ref = _gru_grads_pallas(xp, wh, bn, h0, g, jnp.bfloat16)
  assert got[0].dtype == torch.bfloat16 and ref[0].dtype == jnp.bfloat16
  assert all(a.dtype == torch.float32 for a in got[1:])
  for a, b, what in zip(got, ref, GRU_GRADS):
    a = a.float().numpy().astype(np.float64).ravel()
    b = np.asarray(b.astype(jnp.float32), np.float64).ravel()
    _scaled_close(a, b, 2e-2, what)
    assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999, what


@pytest.mark.parametrize('dtype,atol', [(torch.float32, 1e-5),
                                        (torch.bfloat16, 5e-2)])
def test_gru_plain_backward_matches_autograd_of_plain_forward(dtype, atol):
  """bf16: the plain forward differentiated in float32 is the unrounded
  gradient, so the bound is bf16 rounding through T = 24 steps."""
  xp, wh, bn, h0 = _gru_inputs(b=3, t=24, h=32, seed=13)
  xp = torch.from_numpy(xp).to(dtype).float().numpy()
  g = np.random.RandomState(5).randn(3, 24, 32).astype(np.float32)
  got = _gru_grads_torch(xp, wh, bn, h0, g, dtype)
  leaves = [torch.from_numpy(xp).transpose(0, 1).contiguous(),
            torch.from_numpy(wh), torch.from_numpy(bn), torch.from_numpy(h0)]
  leaves = [t.requires_grad_() for t in leaves]
  ref = torch.autograd.grad(
      k_gru.gru_sequence_plain(*leaves), leaves,
      torch.from_numpy(g).transpose(0, 1).contiguous())
  ref = [ref[0].transpose(0, 1)] + list(ref[1:])
  for a, b, what in zip(got, ref, GRU_GRADS):
    _scaled_close(a.float().numpy(), b.numpy(), atol, what)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_gradients_reach_the_gru_and_the_synth_parameters(dtype):
  """loss.backward() through FastGRU and through ops.harmonic_synthesis
  leaves finite, non-zero gradients (a wrapper that returned a tensor
  without a grad_fn would leave none)."""
  from ddsp_torch.ops import oscillator as t_osc
  rng = np.random.RandomState(6)
  gru = FastGRU(8, 16, compute_dtype=dtype)
  with torch.no_grad():
    gru.bi.normal_(0, 0.1, generator=torch.Generator().manual_seed(0))
  ys, state = gru(torch.from_numpy(rng.randn(2, 12, 8).astype(np.float32)),
                  return_state=True)
  (ys.float().pow(2).mean() + state.float().pow(2).mean()).backward()
  for name in ('wi', 'wh', 'bi', 'bn'):
    grad = getattr(gru, name).grad
    assert grad is not None and grad.dtype == torch.float32, name
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0, name

  amps = torch.from_numpy(rng.rand(2, 10, 1).astype(np.float32))
  dist = torch.from_numpy(rng.rand(2, 10, 6).astype(np.float32))
  f0 = torch.from_numpy((200 + 300 * rng.rand(2, 10, 1)).astype(np.float32))
  leaves = [t.requires_grad_() for t in (amps, dist, f0)]
  audio = t_osc.harmonic_synthesis(f0, amps, harmonic_distribution=dist,
                                   n_samples=640, sample_rate=SR)
  assert audio.grad_fn is not None
  audio.pow(2).mean().backward()
  for name, t in zip(('amplitudes', 'harmonic_distribution', 'f0_hz'),
                     leaves):
    assert t.grad is not None and torch.isfinite(t.grad).all(), name
    assert float(t.grad.abs().max()) > 0, name
