"""The plain versions of kernels K1 and K2 against the JAX package's Pallas
kernels (interpret mode) and jnp paths, on the CPU.

The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py. Tolerances: K1 4e-3 (tests/test_pallas_harmonic.py);
K2 1e-5 in float32 and 5e-2 with bf16 xp (tests/test_pallas_gru.py).
Shapes stay small (T <= 64, H <= 128) because interpret mode is slow.
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
