"""ops/resample.py and the phase sums of ops/oscillator.py against the JAX
package's, on the CPU: tests/test_torch_ops.py's cases of resampling and
cumsums, with its tolerances (its docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import oscillator as j_osc
from ddsp_tpu.ops.resample import resample as j_resample
from ddsp_torch.ops import oscillator as t_osc
from ddsp_torch.ops.resample import resample as t_resample
from test_torch_ops import (  # pylint: disable=g-bad-import-order
    SR, _close, _rng)

torch.set_num_threads(1)


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
