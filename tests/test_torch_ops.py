"""Parity of ddsp_torch.ops with ddsp_tpu.ops on the CPU.

The same seeded numpy inputs go through the JAX function and its port.
float32 tolerance 1e-5, except the harmonic synth at 4e-3 (the JAX
package's own Pallas-vs-jnp tolerance, tests/test_pallas_harmonic.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import fftconv as j_fftconv
from ddsp_tpu.ops import oscillator as j_osc
from ddsp_tpu.ops.resample import resample as j_resample
from ddsp_torch.ops import fftconv as t_fftconv
from ddsp_torch.ops import oscillator as t_osc
from ddsp_torch.ops.resample import resample as t_resample

torch.set_num_threads(1)

ATOL = 1e-5
SYNTH_ATOL = 4e-3
SR = 16000


def _rng(seed):
  return np.random.RandomState(seed)


def _close(jax_out, torch_out, atol=ATOL):
  np.testing.assert_allclose(np.asarray(torch_out), np.asarray(jax_out),
                             atol=atol, rtol=0)


@pytest.mark.parametrize('method', ['nearest', 'linear', 'cubic', 'window'])
@pytest.mark.parametrize('add_endpoint', [True, False])
@pytest.mark.parametrize('n_in,n_out', [(10, 640), (16, 50)])
def test_resample(method, add_endpoint, n_in, n_out):
  if method == 'window':
    n_intervals = n_in if add_endpoint else n_in - 1
    if n_out % n_intervals:
      n_out = n_intervals * (n_out // n_intervals + 1)
  x = _rng(0).randn(3, n_in, 4).astype(np.float32)
  out_j = j_resample(jnp.asarray(x), n_out, method, add_endpoint)
  out_t = t_resample(torch.from_numpy(x), n_out, method, add_endpoint)
  assert tuple(out_t.shape) == out_j.shape
  _close(out_j, out_t)


@pytest.mark.parametrize('shape', [(40,), (2, 40), (2, 40, 3, 2)])
def test_resample_ranks(shape):
  x = _rng(1).randn(*shape).astype(np.float32)
  _close(j_resample(jnp.asarray(x), 200),
         t_resample(torch.from_numpy(x), 200))


def test_angular_cumsum():
  omega = (_rng(2).rand(2, 2500, 3) * 0.05).astype(np.float32)
  _close(j_osc.angular_cumsum(jnp.asarray(omega), chunk_size=500),
         t_osc.angular_cumsum(torch.from_numpy(omega), chunk_size=500))


def test_phase_cumsum_rounds_each_sample_once():
  """The plain phase sum of the synths: float64 accumulation, one rounding
  per sample, on a 4 s training phase (~1e4 rad): within half a float32
  ulp of the exact sum, where a float32 accumulation drifts by ~0.2 rad,
  and the same bits as torch's CPU cumsum (values and gradients); the JAX
  package's float32 jnp.cumsum agrees within 5e-2 rad."""
  rng = _rng(3)
  f0 = 220.0 * 2.0**(rng.rand(2, 1, 1) + 0.2 * np.sin(
      np.linspace(0.0, 20.0, 64000))[None, :, None])
  omega = (f0 * 2 * np.pi / SR).astype(np.float32)
  exact = np.cumsum(omega.astype(np.float64), axis=1)
  w = torch.from_numpy(omega).requires_grad_()
  phase = t_osc.phase_cumsum(w)
  assert phase.dtype == torch.float32 and exact.max() > 8e3
  ulp = np.spacing(np.float32(exact.max()))
  assert np.abs(phase.detach().numpy() - exact).max() <= ulp / 2
  drift = np.abs(np.cumsum(omega, axis=1, dtype=np.float32) - exact).max()
  assert drift > 100 * ulp
  w2 = torch.from_numpy(omega).requires_grad_()
  plain = torch.cumsum(w2, dim=1)
  assert torch.equal(phase, plain)
  g = torch.from_numpy(rng.randn(*omega.shape).astype(np.float32))
  assert torch.equal(torch.autograd.grad(phase, w, g)[0],
                     torch.autograd.grad(plain, w2, g)[0])
  _close(jnp.cumsum(jnp.asarray(omega), axis=1), phase.detach(), atol=5e-2)


def _synth_controls(seed, b=2, t=20, h=24):
  rng = _rng(seed)
  f0 = (100.0 + 900.0 * rng.rand(b, t, 1)).astype(np.float32)
  amps = rng.rand(b, t, 1).astype(np.float32)
  hd = rng.rand(b, t, h).astype(np.float32)
  return f0, amps, hd


@pytest.mark.parametrize('factored', [True, False])
@pytest.mark.parametrize('method', ['window', 'linear', 'cubic'])
@pytest.mark.parametrize('angular', [True, False])
def test_harmonic_synthesis(factored, method, angular):
  f0, amps, hd = _synth_controls(3)
  kw = dict(n_samples=1280, sample_rate=SR, amp_resample_method=method,
            use_angular_cumsum=angular, factored_phase=factored)
  out_j = j_osc.harmonic_synthesis(jnp.asarray(f0), jnp.asarray(amps),
                                   harmonic_distribution=jnp.asarray(hd),
                                   use_pallas=False, **kw)
  out_t = t_osc.harmonic_synthesis(torch.from_numpy(f0),
                                   torch.from_numpy(amps),
                                   harmonic_distribution=torch.from_numpy(hd),
                                   **kw)
  _close(out_j, out_t, SYNTH_ATOL)


def test_harmonic_synthesis_shifts():
  f0, amps, hd = _synth_controls(4)
  shifts = (0.02 * _rng(5).randn(*hd.shape)).astype(np.float32)
  out_j = j_osc.harmonic_synthesis(
      jnp.asarray(f0), jnp.asarray(amps), jnp.asarray(shifts),
      jnp.asarray(hd), n_samples=1280)
  out_t = t_osc.harmonic_synthesis(
      torch.from_numpy(f0), torch.from_numpy(amps), torch.from_numpy(shifts),
      torch.from_numpy(hd), n_samples=1280)
  _close(out_j, out_t, SYNTH_ATOL)


def test_normalize_harmonics():
  f0, _, hd = _synth_controls(6)
  _close(j_osc.normalize_harmonics(jnp.asarray(hd), jnp.asarray(f0), SR),
         t_osc.normalize_harmonics(torch.from_numpy(hd),
                                   torch.from_numpy(f0), SR))


@pytest.mark.parametrize('padding', ['same', 'valid'])
@pytest.mark.parametrize('ir_batch', [1, 2])
def test_fft_convolve_lti(padding, ir_batch):
  rng = _rng(7)
  audio = rng.randn(2, 3000).astype(np.float32)
  ir = (rng.randn(ir_batch, 700) * np.exp(-np.arange(700) / 100.0)).astype(
      np.float32)
  for delay in (0, -1):
    _close(j_fftconv.fft_convolve(jnp.asarray(audio), jnp.asarray(ir),
                                  padding, delay),
           t_fftconv.fft_convolve(torch.from_numpy(audio),
                                  torch.from_numpy(ir), padding, delay))


@pytest.mark.parametrize('padding', ['same', 'valid'])
def test_fft_convolve_ltv(padding):
  rng = _rng(8)
  audio = rng.randn(2, 1024).astype(np.float32)
  ir = rng.randn(2, 16, 128).astype(np.float32) * 0.1
  _close(j_fftconv.fft_convolve(jnp.asarray(audio), jnp.asarray(ir), padding),
         t_fftconv.fft_convolve(torch.from_numpy(audio),
                                torch.from_numpy(ir), padding))


@pytest.mark.parametrize('window_size', [0, 33])
def test_frequency_impulse_response(window_size):
  mags = _rng(9).rand(2, 10, 65).astype(np.float32)
  _close(j_fftconv.frequency_impulse_response(jnp.asarray(mags), window_size),
         t_fftconv.frequency_impulse_response(torch.from_numpy(mags),
                                              window_size))


@pytest.mark.parametrize('window_size', [0, 33])
@pytest.mark.parametrize('ltv', [True, False])
def test_frequency_filter(window_size, ltv):
  rng = _rng(10)
  audio = rng.uniform(-1, 1, (2, 2048)).astype(np.float32)
  mags = rng.rand(*((2, 32, 65) if ltv else (2, 65))).astype(np.float32)
  _close(j_fftconv.frequency_filter(jnp.asarray(audio), jnp.asarray(mags),
                                    window_size),
         t_fftconv.frequency_filter(torch.from_numpy(audio),
                                    torch.from_numpy(mags), window_size))
