"""The port's eval loop on a mesh that shards time, against the JAX
package's and against the port's dense eval, on the CPU.

The `tiny` model of tests/test_torch_sp.py at 16384 samples (float32
decoder), its parameters from the JAX Trainer's init on a (1 x 4) mesh,
carried over by load_jax_params; one checkpoint on each side; the same
SyntheticSinusoidProvider batches; one numpy noise draw handed to both
(the JAX loop's FilteredNoise draws through a stand-in for
jax.random.uniform, as tests/test_torch_sp.py does):

1. 'eval' on a (1 x 4) mesh against the JAX eval of its checkpoint on its
   own (1 x 4) mesh: the BasicEvaluator scalars within JAX_LOSS_RTOL.
2. 'eval' on (1 x 4) and (2 x 4) meshes against the port's dense eval of
   the same checkpoint: the evaluators see the same outputs (keys, the
   audio within SP_AUDIO_ATOL); the loss's mag term, computed from the
   audio the evaluators saw, within SP_MAG_RTOL; total_loss within
   SP_TOTAL_RTOL.
3. 'sample' writes the files of the dense run.
4. A model the sharded forward does not take is refused by name.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.data import SyntheticSinusoidProvider as JaxSinusoids
from ddsp_tpu.eval import eval_util as j_eval_util
from ddsp_tpu.eval import evaluators as j_evaluators
from ddsp_tpu.parallel import create_mesh as j_create_mesh
from ddsp_tpu.train import Trainer as JaxTrainer
from ddsp_torch import losses as t_losses
from ddsp_torch.data import SyntheticSinusoidProvider
from ddsp_torch.eval import evaluate_or_sample
from ddsp_torch.eval import evaluators as t_evaluators
from ddsp_torch.parallel import create_mesh
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

N_SAMPLES, N_FRAMES, FRAME_RATE = 16384, 128, 125
TINY = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, n_harmonics=8,
            n_noise_magnitudes=9, reverb_length=3000, compute_dtype='float32')
BATCH = 2
# The port's SP eval against the JAX package's: the two SP forwards' audio
# is 3e-3 apart (atol, tests/test_torch_sp.py: the frameworks' float32
# phase sums), which the loss's mag term passes on in proportion and its
# logmag term amplifies on quiet bins (measured 3.2e-4 on an x86 CPU).
JAX_LOSS_RTOL = 1e-3
# SP against dense in the port: the shards' own phase sums move the audio
# by ~1e-3 (9.2e-4 measured at a peak of 0.83), the mag term follows it
# (2.1e-4 measured); total_loss at the JAX package's own tier for this
# pair (tests/test_sp_model.py, test_sp_eval_matches_dense_eval: rtol
# 0.1), as its logmag term reads near-silent bins at 1/|X| (6.6e-2
# measured).
SP_AUDIO_ATOL = 3e-3
SP_MAG_RTOL = 1e-3
SP_TOTAL_RTOL = 0.1


def _noise():
  return np.random.RandomState(9).uniform(
      -1, 1, (BATCH, N_SAMPLES)).astype(np.float32)


def _provider(package):
  return package(n_samples=N_SAMPLES, sample_rate=16000,
                 frame_rate=FRAME_RATE, n_examples=BATCH)


def _metrics(save_dir, mode='eval'):
  with open(os.path.join(save_dir, mode, 'metrics.jsonl')) as f:
    return json.loads(f.read().splitlines()[-1])


@pytest.fixture(scope='module')
def jax_eval(tmp_path_factory):
  """The JAX Trainer's parameters (numpy) and its SP eval's metrics."""
  root = tmp_path_factory.mktemp('jax_sp_eval')
  noise = _noise()
  uniform = jax.random.uniform

  def fixed_noise(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
    if tuple(shape) == noise.shape:
      return jnp.asarray(noise)
    return uniform(key, shape, dtype, minval, maxval)

  provider = _provider(JaxSinusoids)
  batch = next(provider.get_batch(BATCH, shuffle=False))
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax.random, 'uniform', fixed_noise)
    trainer = JaxTrainer(
        j_presets.tiny(**TINY),
        mesh=j_create_mesh(n_data=1, n_time=4, devices=jax.devices()[:4]),
        seed=0, halo_impl='pallas')
    state = trainer.init(batch)
    trainer.save(state, str(root / 'ckpt'))
    j_eval_util.evaluate_or_sample(
        provider, trainer, str(root / 'eval'),
        restore_dir=str(root / 'ckpt'),
        evaluators=[j_evaluators.BasicEvaluator(16000, FRAME_RATE)],
        batch_size=BATCH, num_batches=1)
  params = jax.tree_util.tree_map(np.array, state.params)
  return params, _metrics(str(root / 'eval'))


class Recorder(t_evaluators.BaseEvaluator):
  """Keeps the outputs the evaluators saw."""

  def __init__(self):
    super().__init__(16000, FRAME_RATE)
    self.outputs = []

  def evaluate(self, batch, outputs, losses):
    self.outputs.append(outputs)


@pytest.fixture(scope='module')
def port_ckpt(jax_eval, tmp_path_factory):
  """A port checkpoint of the JAX parameters (step 0)."""
  params, _ = jax_eval
  path = str(tmp_path_factory.mktemp('port_ckpt'))
  trainer = Trainer(_port_model(params), device='cpu')
  trainer.save(trainer.init(), path)
  return path


def _port_model(params):
  model = build_model('tiny', device='cpu', **TINY)
  load_jax_params(model, params)
  return model


def _port_eval(params, ckpt, save_dir, mesh=None, mode='eval'):
  trainer = Trainer(_port_model(params), mesh=mesh, device='cpu',
                    halo_impl='pallas')
  recorder = Recorder()
  scalars = evaluate_or_sample(
      _provider(SyntheticSinusoidProvider), trainer, save_dir,
      restore_dir=ckpt, mode=mode,
      evaluators=[t_evaluators.BasicEvaluator(16000, FRAME_RATE), recorder],
      batch_size=BATCH, num_batches=1, noise=torch.from_numpy(_noise()))
  return scalars, recorder.outputs


def test_sp_eval_matches_the_jax_sp_eval(jax_eval, port_ckpt, tmp_path):
  params, want = jax_eval
  got, _ = _port_eval(params, port_ckpt, str(tmp_path),
                      create_mesh(1, 4, devices=['cpu'] * 4))
  assert set(got) == set(want) - {'step'} == {'losses/spectral_loss',
                                               'losses/total_loss'}
  for key, value in got.items():
    np.testing.assert_allclose(value, want[key], rtol=JAX_LOSS_RTOL,
                               err_msg=key)
  assert _metrics(str(tmp_path)) == dict(got, step=0)


@pytest.mark.parametrize('shape', [(1, 4), (2, 4)])
def test_sp_eval_matches_the_dense_eval(jax_eval, port_ckpt, tmp_path,
                                        shape):
  params, _ = jax_eval
  dense, dense_out = _port_eval(params, port_ckpt, str(tmp_path / 'dense'))
  sp, sp_out = _port_eval(params, port_ckpt, str(tmp_path / 'sp'),
                          create_mesh(*shape, devices=['cpu'] * 8))
  assert set(sp) == set(dense)
  (dense_out,), (sp_out,) = dense_out, sp_out
  assert set(sp_out) == set(dense_out)
  for node in ('harmonic', 'filtered_noise', 'add', 'reverb'):
    assert set(sp_out[node]) == set(dense_out[node]) == {'signal',
                                                          'controls'}
  np.testing.assert_allclose(sp_out['audio_synth'],
                             dense_out['audio_synth'], atol=SP_AUDIO_ATOL)
  np.testing.assert_allclose(sp_out['filtered_noise']['signal'],
                             dense_out['filtered_noise']['signal'],
                             atol=1e-6)
  target = torch.from_numpy(
      next(_provider(SyntheticSinusoidProvider).get_batch(
          BATCH, shuffle=False))['audio'])
  mag = t_losses.SpectralLoss(mag_weight=1.0, logmag_weight=0.0)
  mags = [float(mag(target, torch.from_numpy(out['audio_synth'])))
          for out in (sp_out, dense_out)]
  np.testing.assert_allclose(mags[0], mags[1], rtol=SP_MAG_RTOL)
  np.testing.assert_allclose(sp['losses/total_loss'],
                             dense['losses/total_loss'], rtol=SP_TOTAL_RTOL)


def test_sp_sample_writes_the_dense_files(jax_eval, port_ckpt, tmp_path):
  params, _ = jax_eval
  names = {}
  for kind, mesh in (('dense', None),
                     ('sp', create_mesh(1, 4, devices=['cpu'] * 4))):
    save_dir = str(tmp_path / kind)
    scalars, _ = _port_eval(params, port_ckpt, save_dir, mesh,
                            mode='sample')
    assert scalars == {}
    names[kind] = sorted(os.listdir(os.path.join(save_dir, 'samples',
                                                 'step_0')))
  assert names['sp'] == names['dense']
  assert {f'{i}_{kind}.wav' for i in range(BATCH)
          for kind in ('original', 'synth')} <= set(names['sp'])


@pytest.mark.parametrize('preset,kwargs', [
    ('midiae', dict(ch=8, layers_per_stack=2, stacks=1, n_samples=3200,
                    time_steps=50)),
    ('inverse_synthesis', dict(n_samples=4096, n_sinusoids=8,
                               n_harmonics=8)),
])
def test_sp_eval_refuses_a_model_it_cannot_shard(preset, kwargs, tmp_path):
  model = build_model(preset, device='cpu', seed=0, **kwargs)
  trainer = Trainer(model, mesh=create_mesh(1, 2, devices=['cpu'] * 2))
  name = type(model).__name__
  with pytest.raises(ValueError, match=f'got {name}'):
    evaluate_or_sample(_provider(SyntheticSinusoidProvider), trainer,
                       str(tmp_path))
