"""ddsp_torch.nn.vq.VectorQuantization against ddsp_tpu.nn.vq, on the CPU.

The JAX vq_stats (EMA counts and sums) are loaded into the port's buffers by
load_jax_params. With every code alive (no restart) both packages pick the
same centroids, give the same codes and straight-through output, update the
EMA statistics alike in training and not at all in eval, and give the same
commitment loss and gradients (the straight-through path, and the
commitment term's pull on the encoder). Restarts draw from the port's
generator where the JAX module draws from its 'vq' stream, so they are held
to their rule (batch rows into the dead codes) and to determinism, not to
the JAX draws. Tolerances: float32 products of 8-wide vectors and EMA
sums, rtol 1e-5 and atol 1e-6; codes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import vq as j_vq
from ddsp_torch.nn import vq as t_vq
from ddsp_torch.utils import load_jax_params

torch.set_num_threads(1)

K, DEPTH = 6, 8
RTOL, ATOL = 1e-5, 1e-6


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(got, want):
  np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _pair(num_heads, seed=0, alive=True):
  """JAX module and live vq_stats, the port's module with them, inputs."""
  rng = np.random.RandomState(seed)
  head = DEPTH // num_heads
  counts = (rng.rand(K) * 5 + 1).astype(np.float32) if alive else np.zeros(
      K, np.float32)
  sums = (rng.randn(K, head) * counts[:, None]).astype(np.float32)
  stats = {'counts': counts, 'sums': sums}
  x = rng.randn(2, 5, DEPTH).astype(np.float32)
  kw = dict(gamma=0.9, num_heads=num_heads, commitment_loss_weight=0.3)
  j_mod = j_vq.VectorQuantization(k=K, **kw)
  t_mod = t_vq.VectorQuantization(K, DEPTH, **kw)
  load_jax_params(t_mod, {}, vq_stats=stats)
  return j_mod, stats, t_mod, x


@pytest.mark.parametrize('num_heads', [1, 2])
@pytest.mark.parametrize('training', [False, True])
def test_quantize_and_ema_update(num_heads, training):
  j_mod, stats, t_mod, x = _pair(num_heads)
  (z_j, c_j), updated = j_mod.apply(
      {'vq_stats': stats}, jnp.asarray(x), training=training,
      mutable=['vq_stats'], rngs={'vq': jax.random.PRNGKey(0)})
  z_t, c_t = t_mod(_t(x), training=training)
  assert c_t.shape == c_j.shape == (2, 5, num_heads)
  np.testing.assert_array_equal(_np(c_t), _np(c_j))
  _close(z_t, z_j)
  new = updated['vq_stats']
  _close(t_mod.counts, new['counts'] if training else stats['counts'])
  _close(t_mod.sums, new['sums'] if training else stats['sums'])
  if training:
    assert not np.allclose(_np(t_mod.counts), stats['counts'])
  stats_now = new if training else stats
  _close(t_mod.unquantize(c_t), j_mod.apply(
      {'vq_stats': stats_now}, c_j,
      method=j_vq.VectorQuantization.unquantize))


@pytest.mark.parametrize('num_heads', [1, 2])
def test_commitment_loss_and_straight_through_gradient(num_heads):
  """z = x + sg(e - x): the gradient to x is the output's; the commitment
  loss pulls x toward its (stopped) centroid."""
  j_mod, stats, t_mod, x = _pair(num_heads, seed=1)
  w = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

  def objective(xv):
    z, _ = j_mod.apply({'vq_stats': stats}, xv, training=False)
    loss = j_mod.apply({'vq_stats': stats}, xv, z,
                       method=j_vq.VectorQuantization.commitment_loss)
    return jnp.sum(z * w) + loss, loss

  (_, loss_j), g_j = jax.value_and_grad(objective, has_aux=True)(
      jnp.asarray(x))
  x_t = _t(x).requires_grad_()
  z_t, _ = t_mod(x_t)
  losses = t_mod.get_losses_dict(x_t, z_t)
  assert list(losses) == ['vector_quantization_commitment_loss']
  loss_t = losses['vector_quantization_commitment_loss']
  _close(loss_t, loss_j)
  (g_t,) = torch.autograd.grad((z_t * _t(w)).sum() + loss_t, x_t)
  _close(g_t, g_j)
  named = t_vq.VectorQuantization(K, DEPTH, name='prior')
  assert list(named.get_losses_dict(x_t, z_t)) == ['prior_commitment_loss']


def test_restarts_take_batch_rows_from_the_generator():
  """All codes dead and k <= n: each restarts at a row of the batch, so
  every input is quantized to one of its own rows; the same generator
  seed gives the same codes; the EMA starts from the assigned rows."""
  _, _, t_mod, x = _pair(1, seed=3, alive=False)
  state = {k: v.clone() for k, v in t_mod.state_dict().items()}
  z, c = t_mod(_t(x), training=True,
               generator=torch.Generator().manual_seed(5))
  rows = x.reshape(-1, DEPTH)
  for v in _np(z).reshape(-1, DEPTH):
    assert np.min(np.abs(rows - v).max(axis=1)) <= 1e-6  # x + (e - x)
  counts_a = t_mod.counts.clone()
  np.testing.assert_allclose(_np(counts_a).sum(), 0.1 * rows.shape[0],
                             rtol=1e-6)
  t_mod.load_state_dict(state)
  _, c_again = t_mod(_t(x), training=True,
                     generator=torch.Generator().manual_seed(5))
  np.testing.assert_array_equal(_np(c), _np(c_again))


def test_vq_stats_load_is_strict():
  _, stats, t_mod, _ = _pair(1)
  with pytest.raises(ValueError, match='vq_stats.*missing'):
    load_jax_params(t_mod, {})
  with pytest.raises(ValueError, match='vq_stats.*extra'):
    load_jax_params(t_mod, {}, vq_stats=dict(stats, bias=np.zeros(K)))
  with pytest.raises(ValueError, match='shape'):
    load_jax_params(t_mod, {}, vq_stats=dict(stats, counts=np.zeros(K + 1)))
