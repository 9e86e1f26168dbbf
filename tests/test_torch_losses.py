"""ddsp_torch.losses against ddsp_tpu.losses, values and gradients, on CPU.

Same numpy audio through both; the JAX side takes its jnp.fft branch off
the TPU. Tolerances: loss values rtol 2e-5 (float32 FFTs and reductions in
two libraries); gradients with respect to the audio relative L2 <= 1e-3 of
the gradient's norm (the L1 terms' sign(x) is discontinuous, so single
elements may flip at |difference| ~ 1e-7 while the vector agrees).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu import losses as j_losses
from ddsp_torch import losses as t_losses

torch.set_num_threads(1)

FFT_SIZES = (256, 128, 64)
TERMS = ('mag_weight', 'delta_time_weight', 'delta_freq_weight',
         'cumsum_freq_weight', 'logmag_weight', 'loudness_weight')


def _pair(seed=0, batch=2, n=3000):
  rng = np.random.RandomState(seed)
  t = np.arange(n) / 16000.0
  target = (0.3 * np.sin(2 * np.pi * 330.0 * t)[None] +
            0.05 * rng.randn(batch, n)).astype(np.float32)
  value = (0.25 * np.sin(2 * np.pi * 350.0 * t + 0.3)[None] +
           0.05 * rng.randn(batch, n)).astype(np.float32)
  return target, value


def _both(kwargs, target, value):
  """(loss, grad wrt value) from the JAX loss and from the port's."""
  loss_j = j_losses.SpectralLoss(**kwargs)
  fn = lambda v: loss_j.apply({}, jnp.asarray(target), v)
  val_j, grad_j = jax.value_and_grad(fn)(jnp.asarray(value))
  v = torch.from_numpy(value).requires_grad_()
  val_t = t_losses.SpectralLoss(**kwargs)(torch.from_numpy(target), v)
  grad_t, = torch.autograd.grad(val_t, v)
  return float(val_j), np.asarray(grad_j), val_t.item(), grad_t.numpy()


def _assert_match(val_j, grad_j, val_t, grad_t):
  np.testing.assert_allclose(val_t, val_j, rtol=2e-5)
  assert np.linalg.norm(grad_j) > 0
  rel = np.linalg.norm(grad_t - grad_j) / np.linalg.norm(grad_j)
  assert rel <= 1e-3, rel


@pytest.mark.parametrize('term', TERMS)
def test_spectral_loss_each_term_alone(term):
  kwargs = dict(fft_sizes=FFT_SIZES, loss_type='L1', mag_weight=0.0,
                compute_dtype='float32')
  kwargs[term] = 0.7
  target, value = _pair()
  # The loudness term takes n_fft = 2048 frames: give it enough audio.
  if term == 'loudness_weight':
    target, value = _pair(n=6000)
  _assert_match(*_both(kwargs, target, value))


@pytest.mark.parametrize('loss_type', ['L1', 'L2', 'COSINE'])
def test_spectral_loss_preset_terms(loss_type):
  """mag + logmag, the presets' loss, at every reduction."""
  kwargs = dict(fft_sizes=FFT_SIZES, loss_type=loss_type, mag_weight=1.0,
                logmag_weight=1.0, compute_dtype='float32')
  _assert_match(*_both(kwargs, *_pair(seed=1)))


def test_spectral_loss_defaults_and_compute_dtype():
  loss = t_losses.SpectralLoss()
  ref = j_losses.SpectralLoss()
  assert loss.fft_sizes == tuple(ref.fft_sizes)
  assert loss.compute_dtype == ref.compute_dtype == 'bfloat16'
  assert not list(loss.parameters())
  target, value = (torch.from_numpy(a) for a in _pair(n=2500))
  # compute_dtype has no effect on the FFT path.
  a = t_losses.SpectralLoss(fft_sizes=FFT_SIZES, compute_dtype='bfloat16')(
      target, value)
  b = t_losses.SpectralLoss(fft_sizes=FFT_SIZES, compute_dtype='float32')(
      target, value)
  assert float(a) == float(b)


@pytest.mark.parametrize('with_weights', [False, True])
@pytest.mark.parametrize('loss_type', ['L1', 'L2', 'COSINE', 'l1'])
def test_mean_difference(loss_type, with_weights):
  rng = np.random.RandomState(2)
  target = rng.randn(3, 5, 8).astype(np.float32)
  value = rng.randn(3, 5, 8).astype(np.float32)
  shape = (3, 5) if loss_type == 'COSINE' else (3, 5, 8)
  weights = rng.rand(*shape).astype(np.float32) if with_weights else None
  out_j = j_losses.mean_difference(
      jnp.asarray(target), jnp.asarray(value), loss_type,
      None if weights is None else jnp.asarray(weights))
  out_t = t_losses.mean_difference(
      torch.from_numpy(target), torch.from_numpy(value), loss_type,
      None if weights is None else torch.from_numpy(weights))
  np.testing.assert_allclose(float(out_t), float(out_j), rtol=1e-6)


def test_mean_difference_rejects_unknown_type():
  x = torch.zeros(2, 3)
  with pytest.raises(ValueError, match='Loss type'):
    t_losses.mean_difference(x, x, 'L3')


@pytest.mark.parametrize('loss_type', ['L1', 'L2'])
def test_param_loss(loss_type):
  rng = np.random.RandomState(3)
  pred = rng.randn(2, 10, 4).astype(np.float32)
  target = rng.randn(2, 10, 4).astype(np.float32)
  weights = rng.rand(2, 10, 1).astype(np.float32)
  out_j = j_losses.ParamLoss(weight=50.0, loss_type=loss_type).apply(
      {}, jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weights))
  loss = t_losses.ParamLoss(weight=50.0, loss_type=loss_type, name='f0_loss')
  out_t = loss(torch.from_numpy(pred), torch.from_numpy(target),
               torch.from_numpy(weights))
  np.testing.assert_allclose(float(out_t), float(out_j), rtol=1e-6)
  assert list(loss.get_losses_dict(torch.from_numpy(pred),
                                   torch.from_numpy(target))) == ['f0_loss']


def test_loss_group():
  target, value = _pair(seed=4, n=2500)
  rng = np.random.RandomState(4)
  amps = rng.rand(2, 20, 1).astype(np.float32)
  amps_pred = rng.rand(2, 20, 1).astype(np.float32)
  spectral = dict(fft_sizes=FFT_SIZES, loss_type='L1', mag_weight=1.0,
                  logmag_weight=1.0, compute_dtype='float32',
                  name='synth_spectral_loss')
  outputs = {'audio': target, 'synth_audio': value, 'amps': amps,
             'amps_pred': amps_pred}
  group_j = j_losses.LossGroup(dag=[
      (j_losses.SpectralLoss(**spectral), ['audio', 'synth_audio']),
      (j_losses.ParamLoss(weight=0.5, name='amps_loss'),
       ['amps', 'amps_pred'])])
  out_j = group_j.apply({}, {k: jnp.asarray(v) for k, v in outputs.items()})
  group_t = t_losses.LossGroup([
      (t_losses.SpectralLoss(**spectral), ['audio', 'synth_audio']),
      (t_losses.ParamLoss(weight=0.5, name='amps_loss'),
       ['amps', 'amps_pred'])])
  out_t = group_t.get_losses_dict(
      {k: torch.from_numpy(v) for k, v in outputs.items()})
  assert group_t.loss_names == ['synth_spectral_loss', 'amps_loss']
  assert sorted(out_t) == sorted(out_j) == ['amps_loss',
                                            'synth_spectral_loss']
  for k in out_j:
    np.testing.assert_allclose(float(out_t[k]), float(out_j[k]), rtol=2e-5)
  assert t_losses.SpectralLoss().get_losses_dict(
      torch.from_numpy(target), torch.from_numpy(value)).keys() == {
          'spectral_loss'}
