"""Sequence-parallel forward and training of ddsp_torch against ddsp_tpu.

The `tiny` model at 16384 samples (parameters from the JAX package's init,
carried over by load_jax_params, decoder in float32 on both sides):
  1. on a (1, 1) mesh the port's SP forward equals its dense forward bit
     for bit, noise included (the JAX package's test_trivial_mesh_is_exact);
  2. on a (1, 4) mesh the signals are within atol 3e-3 of the JAX SP
     forward (the two frameworks' float32 cumsums differ by ~5e-4 rad over
     16000 samples), filtered_noise within 1e-6 given the same noise;
  3. the port Trainer's SP step on a (2, 4) CPU mesh, mag-only loss,
     matches the JAX Trainer's SP step at rtol 1e-3, and so does the next
     step (tests/test_sp_model.py:90-147). The JAX Trainer draws its noise
     from flax rng streams; the test hands both sides one numpy draw by
     standing in for jax.random.uniform at the noise's shape.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu import losses as j_losses
from ddsp_tpu import nn as j_nn
from ddsp_tpu import proc as j_proc
from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.models import Autoencoder as JaxAutoencoder
from ddsp_tpu.parallel import create_mesh as j_create_mesh
from ddsp_tpu.parallel import sp_model as j_sp_model
from ddsp_tpu.train import Trainer as JaxTrainer
from ddsp_torch import losses as t_losses
from ddsp_torch import nn as t_nn
from ddsp_torch import proc as t_proc
from ddsp_torch.models import Autoencoder
from ddsp_torch.parallel import create_mesh, sp_forward_with_losses
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

N_SAMPLES, N_FRAMES = 16384, 128
TINY = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, n_harmonics=8,
            n_noise_magnitudes=9, reverb_length=3000, compute_dtype='float32')
NODES = ('harmonic', 'filtered_noise', 'add', 'reverb')


def _batch(batch_size=2, seed=0):
  rng = np.random.RandomState(seed)
  return {
      'audio': (0.1 * rng.randn(batch_size, N_SAMPLES)).astype(np.float32),
      'f0_hz': np.full((batch_size, N_FRAMES, 1), 220.0, np.float32),
  }


def _torch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope='module')
def jax_tiny():
  """The JAX tiny model and its initial parameters (numpy)."""
  model = j_presets.tiny(**TINY)
  variables = jax.jit(lambda b: model.init(
      {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}, b,
      training=True, return_losses=True))(_batch())
  return model, jax.tree_util.tree_map(np.array, variables['params'])


def _port_tiny(params):
  model = build_model('tiny', device='cpu', **TINY)
  load_jax_params(model, params)
  return model


def _jax_noise(batch_size=2):
  """What the JAX processors draw when applied without rngs."""
  return np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                     (batch_size, N_SAMPLES), minval=-1.0,
                                     maxval=1.0))


def test_trivial_mesh_sp_forward_equals_the_dense_forward(jax_tiny):
  _, params = jax_tiny
  model = _port_tiny(params)
  feats = _torch(_batch())
  noise = torch.from_numpy(_jax_noise())
  with torch.no_grad():
    out1, l1 = model(feats, training=True, return_losses=True, noise=noise)
    out2, l2 = sp_forward_with_losses(
        model, feats, create_mesh(1, 1, devices=['cpu']), noise=noise)
  for node in NODES:
    assert torch.equal(out1[node]['signal'], out2[node]['signal']), node
  assert torch.equal(out1['audio_synth'], out2['audio_synth'])
  np.testing.assert_allclose(float(l2['total_loss']),
                             float(l1['total_loss']), rtol=1e-6)


def test_sharded_forward_matches_the_jax_sp_forward(jax_tiny):
  j_model, params = jax_tiny
  batch = _batch()
  jmesh = j_create_mesh(n_data=1, n_time=4, devices=jax.devices()[:4])
  out_j, _ = jax.jit(lambda p, b: j_model.apply(
      {'params': p}, b, mesh=jmesh, halo_impl='pallas',
      method=j_sp_model.sp_forward_with_losses))(params, batch)
  model = _port_tiny(params)
  with torch.no_grad():
    out_t, losses = sp_forward_with_losses(
        model, _torch(batch), create_mesh(1, 4, devices=['cpu'] * 4),
        halo_impl='pallas', noise=torch.from_numpy(_jax_noise()))
  assert sorted(losses) == ['spectral_loss', 'total_loss']
  for node in NODES:
    np.testing.assert_allclose(out_t[node]['signal'].numpy(),
                               np.asarray(out_j[node]['signal']), atol=3e-3,
                               err_msg=node)
  np.testing.assert_allclose(out_t['filtered_noise']['signal'].numpy(),
                             np.asarray(out_j['filtered_noise']['signal']),
                             atol=1e-6)


def _mag_only(lib, nn_lib, proc_lib, autoencoder):
  """tests/test_sp_model.py's SP trainer model, in either framework."""
  return autoencoder(
      preprocessor=nn_lib.F0LoudnessPreprocessor(
          time_steps=N_FRAMES, sample_rate=16000,
          compute_loudness_fresh=True),
      encoder=None,
      decoder=nn_lib.RnnFcDecoder(
          rnn_channels=16, rnn_type='gru', ch=16, layers_per_stack=1,
          input_keys=('ld_scaled', 'f0_scaled'),
          output_splits=(('amps', 1), ('harmonic_distribution', 8),
                         ('noise_magnitudes', 9)), compute_dtype='float32'),
      processor_group=proc_lib.ProcessorGroup(dag=[
          (proc_lib.Harmonic(n_samples=N_SAMPLES, sample_rate=16000,
                             name='harmonic'),
           ['amps', 'harmonic_distribution', 'f0_hz']),
          (proc_lib.FilteredNoise(n_samples=N_SAMPLES, window_size=0,
                                  name='filtered_noise'),
           ['noise_magnitudes']),
          (proc_lib.Add(name='add'),
           ['filtered_noise/signal', 'harmonic/signal']),
          (proc_lib.Reverb(trainable=True, reverb_length=3000,
                           name='reverb'), ['add/signal']),
      ]),
      losses=(lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                               logmag_weight=0.0),))


def test_sp_trainer_steps_match_the_jax_trainer(monkeypatch):
  batch = _batch()
  noise = np.random.RandomState(9).uniform(
      -1, 1, (2, N_SAMPLES)).astype(np.float32)
  uniform = jax.random.uniform
  draws = []

  def fixed_noise(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
    if tuple(shape) == noise.shape:
      draws.append(shape)
      return jnp.asarray(noise)
    return uniform(key, shape, dtype, minval, maxval)

  monkeypatch.setattr(jax.random, 'uniform', fixed_noise)
  j_trainer = JaxTrainer(
      _mag_only(j_losses, j_nn, j_proc, JaxAutoencoder),
      mesh=j_create_mesh(n_data=2, n_time=4, devices=jax.devices()),
      seed=0, halo_impl='pallas')
  j_state = j_trainer.init(batch)
  params = jax.tree_util.tree_map(np.array, j_state.params)
  j_losses_seen = []
  for _ in range(2):
    j_state, losses = j_trainer.train_step(j_state, batch)
    j_losses_seen.append(float(losses['total_loss']))
  assert draws  # the JAX step drew its noise through the stand-in

  model = _mag_only(t_losses, t_nn, t_proc, Autoencoder)
  load_jax_params(model, params)
  trainer = Trainer(model, mesh=create_mesh(2, 4, devices=['cpu'] * 8),
                    seed=0, halo_impl='pallas')
  assert trainer.device.type == 'cpu'
  state = trainer.init()
  seen = []
  for _ in range(2):
    state, losses = trainer.train_step(state, batch,
                                       noise=torch.from_numpy(noise))
    seen.append(float(losses['total_loss']))
  np.testing.assert_allclose(seen, j_losses_seen, rtol=1e-3)
  assert seen[1] < seen[0]


def test_a_mesh_without_time_sharding_takes_the_dense_step(jax_tiny):
  _, params = jax_tiny
  batch = _batch(seed=1)
  losses = []
  for mesh in (None, create_mesh(2, 1, devices=['cpu'] * 2)):
    trainer = Trainer(_port_tiny(params), mesh=mesh, device='cpu', seed=0)
    _, step = trainer.train_step(trainer.init(), batch)
    losses.append(float(step['total_loss']))
  assert losses[0] == losses[1]


def test_parallel_package_imports_no_jax():
  code = ('import sys, ddsp_torch.parallel, ddsp_torch.train; '
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'ddsp_tpu', 'optax')]; print(bad)")
  out = subprocess.run([sys.executable, '-c', code], check=True,
                       capture_output=True, text=True,
                       cwd=str(pathlib.Path(__file__).resolve().parents[1]))
  assert out.stdout.strip() == '[]'


@pytest.mark.parametrize('n_time', [2, 4])
def test_sp_step_gradients_reach_every_parameter(jax_tiny, n_time):
  """Every parameter gets a finite, non-zero gradient through the sharded
  forward (the halo adjoints carry the reverb's and the noise's)."""
  _, params = jax_tiny
  model = _port_tiny(params)
  _, losses = sp_forward_with_losses(
      model, _torch(_batch()),
      create_mesh(1, n_time, devices=['cpu'] * n_time),
      noise=torch.from_numpy(_jax_noise()))
  named = list(model.named_parameters())
  grads = torch.autograd.grad(losses['total_loss'], [p for _, p in named])
  for (name, _), g in zip(named, grads):
    assert torch.isfinite(g).all() and g.abs().max() > 0, name
