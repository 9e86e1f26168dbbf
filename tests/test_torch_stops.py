"""ddsp_torch.nn.stops against ddsp_tpu.nn.stops, on the CPU.

Each function on the same seeded numpy inputs: the straight-through
estimators (values and gradients, rounding ties to even), the note masks
(note-off regions, onsets, regions past max_regions), the note moments,
pooling and the short-note loss mask. Everything is float32 elementwise
arithmetic and small sums: tolerance rtol 1e-5, atol 1e-6; masks, indices
and one-hots exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import stops as j_stops
from ddsp_torch.nn import stops as t_stops

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _t(x):
  return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
  np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                             atol=atol)


def _pitch_track(seed=0, batch=3, time=60, note_off=True):
  """Piecewise-constant MIDI pitches with note-off (0) stretches."""
  rng = np.random.RandomState(seed)
  out = np.zeros((batch, time), np.float32)
  for b in range(batch):
    t = 0
    while t < time:
      n = rng.randint(2, 12)
      pitch = 0.0 if (note_off and rng.rand() < 0.3) else float(
          rng.randint(40, 80))
      out[b, t:t + n] = pitch
      t += n
  return out


def test_straight_through_int_quantization_ties_and_gradient():
  x = np.array([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.49, 69.5, 70.5, 0.2]],
               np.float32)
  x_t = _t(x).requires_grad_()
  y_t = t_stops.straight_through_int_quantization(x_t)
  y_j = j_stops.straight_through_int_quantization(jnp.asarray(x))
  np.testing.assert_array_equal(y_t.detach().numpy(), np.asarray(y_j))
  # Ties to even, as jnp.round.
  np.testing.assert_array_equal(y_t.detach().numpy()[0, :6],
                                [-2, -2, -0, 0, 2, 2])
  w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
  (g_t,) = torch.autograd.grad((y_t * _t(w)).sum(), x_t)
  g_j = jax.grad(lambda v: jnp.sum(
      j_stops.straight_through_int_quantization(v) * w))(jnp.asarray(x))
  np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_straight_through_softmax_and_choice_argmax():
  rng = np.random.RandomState(2)
  logits = rng.randn(4, 5, 7).astype(np.float32)
  values = rng.randn(4, 5, 7).astype(np.float32)
  w = rng.randn(4, 5, 7).astype(np.float32)
  lt = _t(logits).requires_grad_()
  s_t, p_t = t_stops.straight_through_softmax(lt)
  s_j, p_j = j_stops.straight_through_softmax(jnp.asarray(logits))
  _close(s_t.detach(), s_j)
  _close(p_t.detach(), p_j)
  (g_t,) = torch.autograd.grad((s_t * _t(w)).sum(), lt)
  g_j = jax.grad(lambda l: jnp.sum(
      j_stops.straight_through_softmax(l)[0] * w))(jnp.asarray(logits))
  _close(g_t, g_j)
  c_t = t_stops.straight_through_choice(_t(logits), _t(values))
  c_j = j_stops.straight_through_choice(jnp.asarray(logits),
                                        jnp.asarray(values))
  _close(c_t, c_j)


def test_straight_through_softmax_samples_one_hots():
  """With a generator as the key it samples: one-hot rows, the draw's
  value in the forward, softmax gradients."""
  logits = torch.tensor([[0.0, 50.0, 0.0], [50.0, 0.0, 0.0]])
  sample, probs = t_stops.straight_through_softmax(
      logits, key=torch.Generator().manual_seed(3))
  np.testing.assert_array_equal(sample.numpy(), [[0, 1, 0], [1, 0, 0]])
  _close(probs.sum(-1), np.ones(2))


@pytest.mark.parametrize('note_on_only', [True, False])
@pytest.mark.parametrize('max_regions', [100, 5])
def test_get_note_mask(note_on_only, max_regions):
  """Regions past max_regions vanish in both packages (max_regions=5 is
  below this track's region count)."""
  q = _pitch_track(0)
  m_t = t_stops.get_note_mask(_t(q)[..., None], max_regions, note_on_only)
  m_j = j_stops.get_note_mask(jnp.asarray(q)[..., None], max_regions,
                              note_on_only)
  assert m_t.shape == (3, 60, max_regions)
  np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
  if max_regions == 5:
    assert m_t.numpy().sum() < 3 * 60  # the overflow's frames are dropped


@pytest.mark.parametrize('note_on_only', [True, False])
def test_get_note_mask_from_onset(note_on_only):
  q = _pitch_track(1)
  onset = np.zeros_like(q)
  onset[:, 1:] = (np.abs(np.diff(q, axis=1)) > 0)
  m_t = t_stops.get_note_mask_from_onset(_t(q), _t(onset), 20, note_on_only)
  m_j = j_stops.get_note_mask_from_onset(jnp.asarray(q), jnp.asarray(onset),
                                         20, note_on_only)
  np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))


def test_note_moments_pooling_and_short_note_mask():
  rng = np.random.RandomState(4)
  q = _pitch_track(2)
  x = rng.randn(3, 60, 4).astype(np.float32)
  mask_j = j_stops.get_note_mask(jnp.asarray(q), note_on_only=False)
  mask_t = _t(np.asarray(mask_j))
  _close(t_stops.get_note_lengths(mask_t), j_stops.get_note_lengths(mask_j))
  for values in (x, x[..., 0]):
    mean_t, std_t = t_stops.get_note_moments(_t(values), mask_t)
    mean_j, std_j = j_stops.get_note_moments(jnp.asarray(values), mask_j)
    _close(mean_t, mean_j)
    _close(std_t, std_j)
  pooled_t = t_stops.pool_over_notes(_t(x), mask_t)
  pooled_j = j_stops.pool_over_notes(jnp.asarray(x), mask_j)
  for a, b in zip(pooled_t, pooled_j):
    _close(a, b)
  _close(t_stops.pool_over_notes(_t(x), mask_t, return_std=False),
         pooled_j[0])
  lengths = t_stops.get_note_lengths(mask_t)
  pitches = t_stops.get_note_moments(_t(q), mask_t, return_std=False)
  short_t = t_stops.get_short_note_loss_mask(mask_t, lengths, pitches, 6)
  short_j = j_stops.get_short_note_loss_mask(
      mask_j, j_stops.get_note_lengths(mask_j),
      j_stops.get_note_moments(jnp.asarray(q), mask_j, return_std=False), 6)
  np.testing.assert_array_equal(short_t.numpy(), np.asarray(short_j))
  assert 0 < short_t.numpy().sum() < short_t.numel()


def test_note_moments_gradient():
  rng = np.random.RandomState(5)
  q = _pitch_track(3, note_off=False)
  x = rng.randn(3, 60, 2).astype(np.float32)
  w = rng.randn(3, 60, 2).astype(np.float32)
  mask_j = j_stops.get_note_mask(jnp.asarray(q))
  x_t = _t(x).requires_grad_()
  pooled = t_stops.pool_over_notes(x_t, _t(np.asarray(mask_j)),
                                   return_std=False)
  (g_t,) = torch.autograd.grad((pooled * _t(w)).sum(), x_t)
  g_j = jax.grad(lambda v: jnp.sum(j_stops.pool_over_notes(
      v, mask_j, return_std=False) * w))(jnp.asarray(x))
  _close(g_t, g_j)
