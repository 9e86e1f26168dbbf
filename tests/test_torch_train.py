"""The training slice of ddsp_torch against ddsp_tpu, on the CPU.

One whole step (loss and every parameter's gradient against
jax.value_and_grad of model.apply(..., return_losses=True)), an N-step
trajectory of the port's Trainer against a JAX loop over the JAX Trainer's
own optimizer, the learning-rate schedule, checkpoints, the train loop and
the isolation of the new packages.

Both sides get the same parameters (load_jax_params), the same numpy batch
and the same noise: the JAX model is applied without rngs, so FilteredNoise
draws uniform(PRNGKey(0)), which is handed to the port. Models use
use_angular_cumsum=True and 3200 samples, so the float32 phase of the two
frameworks agrees (their plain cumsums drift apart over long signals), and
a low f0 (110-170 Hz): the two float32 cumsums still differ by ~1e-6 rad,
harmonic h multiplies that, and the L1 loss's gradient amplifies it. The
head's noise bias is raised so no spectrogram bin is near silence: the
logmag term's gradient is 1/|bin|, and a bin near zero makes any comparison
of gradients meaningless.

Tolerances. float32: total_loss rtol 1e-5; each decoder gradient relative
L2 <= 1e-3; the reverb IR's gradient relative L2 <= 0.1 and cosine >= 0.995
(each entry is a length-3200 correlation that cancels to under 1 % of its
Cauchy-Schwarz bound, so forward differences of 1e-5 move it by percents).
bfloat16: total_loss rtol 2e-3; each decoder gradient relative L2 <= 0.15
and cosine >= 0.99, the decoder as a whole cosine >= 0.995, the reverb IR
cosine >= 0.9: the JAX side runs its float32 scan GRU off the TPU while the
port follows the Pallas kernel's bf16 streams (the reference asks cosine
> 0.99 of its own GRU's bf16 gradients, tests/test_pallas_gru.py).
"""

import itertools
import json
import logging
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.train import Trainer as JaxTrainer
from ddsp_torch.ops.core import flatten
from ddsp_torch.train import MetricsWriter, Trainer, TrainState, train
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N_SAMPLES, N_FRAMES, SR = 3200, 50, 16000
SMALL = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, reverb_length=800,
             use_angular_cumsum=True)
CASES = {
    'tiny': ('tiny', dict(SMALL)),
    'solo_narrow': ('solo_instrument', dict(
        SMALL, rnn_channels=32, ch=32, layers_per_stack=2, n_harmonics=16,
        n_noise_magnitudes=17)),
}


def _batch(seed=0, batch=2):
  """Harmonic tones with a gliding f0 plus noise, and their f0 frames."""
  rng = np.random.RandomState(seed)
  frames = np.arange(N_FRAMES) / 250.0
  f0 = 110.0 * 2.0**(0.5 * rng.rand(batch, 1) +
                     0.1 * np.sin(2 * np.pi * 1.5 * frames)[None])
  phase = 2 * np.pi * np.cumsum(np.repeat(f0, N_SAMPLES // N_FRAMES, axis=1),
                                axis=1) / SR
  audio = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
  audio = audio + 0.02 * rng.randn(batch, N_SAMPLES)
  return {'audio': audio.astype(np.float32),
          'f0_hz': f0.astype(np.float32)[:, :, None]}


def _jax_model_and_params(case, dtype, seed=0):
  preset, kwargs = CASES[case]
  model = getattr(j_presets, preset)(compute_dtype=dtype, **kwargs)
  feats = {k: jnp.asarray(v) for k, v in _batch().items()}
  variables = model.init({'params': jax.random.PRNGKey(seed),
                          'noise': jax.random.PRNGKey(seed + 1)}, feats,
                         training=True, return_losses=True)
  params = jax.tree_util.tree_map(np.array, variables['params'])
  rng = np.random.RandomState(seed + 2)
  n_ir = params['processor_group']['reverb']['ir'].shape[0]
  params['processor_group']['reverb']['ir'] = (
      0.05 * rng.randn(n_ir) *
      np.exp(-np.arange(n_ir) / (0.1 * n_ir))).astype(np.float32)
  bias = params['decoder']['dense_out']['bias'].copy()
  n_noise = kwargs.get('n_noise_magnitudes', 33)
  bias[-n_noise:] = 4.0  # an audible noise floor in every bin
  params['decoder']['dense_out']['bias'] = bias
  return model, params


def _port_model(case, dtype, params):
  preset, kwargs = CASES[case]
  model = build_model(preset, device='cpu', compute_dtype=dtype, **kwargs)
  load_jax_params(model, params)
  return model


def _jax_noise(batch):
  return np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                     (batch, N_SAMPLES), minval=-1.0,
                                     maxval=1.0))


def _jax_loss_fn(model, batch):
  feats = {k: jnp.asarray(v) for k, v in batch.items()}

  def loss_fn(params):
    _, losses = model.apply({'params': params}, feats, training=True,
                            return_losses=True)
    return losses['total_loss'], losses

  return loss_fn


def _cosine(a, b):
  a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
  return a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_one_step_loss_and_gradients_match_jax(case, dtype):
  model_j, params = _jax_model_and_params(case, dtype)
  batch = _batch(seed=1)
  (loss_j, losses_j), grads_j = jax.jit(jax.value_and_grad(
      _jax_loss_fn(model_j, batch), has_aux=True))(params)
  grads_j = {k: np.asarray(v) for k, v in flatten(grads_j).items()}

  model_t = _port_model(case, dtype, params)
  outputs, losses_t = model_t(
      {k: torch.from_numpy(v) for k, v in batch.items()}, training=True,
      return_losses=True, noise=torch.from_numpy(_jax_noise(2)))
  assert sorted(losses_t) == sorted(losses_j) == ['spectral_loss',
                                                   'total_loss']
  assert outputs['audio_synth'].shape == (2, N_SAMPLES)
  names = [k for k, _ in model_t.named_parameters()]
  grads_t = torch.autograd.grad(losses_t['total_loss'],
                                [p for _, p in model_t.named_parameters()])
  grads_t = {k.replace('.', '/'): g.numpy() for k, g in zip(names, grads_t)}
  assert sorted(grads_t) == sorted(grads_j)

  bf16 = dtype == 'bfloat16'
  np.testing.assert_allclose(losses_t['total_loss'].item(), float(loss_j),
                             rtol=2e-3 if bf16 else 1e-5)
  for key, g_j in grads_j.items():
    g_t = grads_t[key]
    assert np.isfinite(g_t).all() and np.abs(g_t).max() > 0, key
    rel = np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    cos = _cosine(g_t, g_j)
    if key.endswith('reverb/ir'):
      assert cos >= (0.9 if bf16 else 0.995), (key, cos)
      assert bf16 or rel <= 0.1, (key, rel)
    else:
      assert rel <= (0.15 if bf16 else 1e-3), (key, rel)
      assert cos >= 0.99, (key, cos)
  decoder = sorted(k for k in grads_j if k.startswith('decoder/'))
  whole_t = np.concatenate([grads_t[k].ravel() for k in decoder])
  whole_j = np.concatenate([grads_j[k].ravel() for k in decoder])
  assert _cosine(whole_t, whole_j) >= (0.995 if bf16 else 0.99999)


def test_model_losses_contract():
  model = build_model('tiny', device='cpu', seed=0, compute_dtype='float32',
                      **SMALL)
  feats = {k: torch.from_numpy(v) for k, v in _batch().items()}
  with torch.no_grad():
    outputs = model(feats)
    assert isinstance(outputs, dict) and 'audio_synth' in outputs
    outputs2, losses = model(feats, training=False, return_losses=True)
  assert set(losses) == {'spectral_loss', 'total_loss'}
  assert float(losses['total_loss']) == float(losses['spectral_loss'])
  torch.testing.assert_close(outputs2['audio_synth'], outputs['audio_synth'])
  # The fresh loudness comes from the audio; without audio it raises.
  assert outputs['loudness_db'].shape == (2, N_FRAMES, 1)
  with pytest.raises(ValueError, match="requires 'audio'"):
    model({'f0_hz': feats['f0_hz']})
  stale = build_model('tiny', device='cpu', compute_loudness_fresh=False,
                      **SMALL)
  with pytest.raises(ValueError, match="requires 'loudness_db'"):
    stale.preprocessor({'f0_hz': feats['f0_hz']})


def test_trainer_trajectory_tracks_the_jax_optimizer():
  """6 steps at lr 1e-3 from one start; the clip acts (norms above 3.0).

  The first loss is the one-step parity (rtol 1e-5). Adam's first updates
  are -lr * sign(g) whatever the gradient's size, so the few percent of
  reverb-IR entries whose small gradients differ in sign between the
  frameworks move the other way, and the runs drift apart from step 2 on:
  later losses rtol 1e-2 while the loss halves; the decoder's total change
  cosine >= 0.98 and relative L2 <= 0.2 of the JAX change. The optimizer
  alone is held to optax at 1e-6 in the next test."""
  n_steps = 6
  model_j, params0 = _jax_model_and_params('tiny', 'float32')
  batches = [_batch(seed=10 + i) for i in range(2)]
  jax_trainer = JaxTrainer(model_j, learning_rate=1e-3)
  optimizer = jax_trainer.optimizer

  @jax.jit
  def jax_step(params, opt_state, feats):
    def loss_fn(p):
      _, losses = model_j.apply({'params': p}, feats, training=True,
                                return_losses=True)
      return losses['total_loss']
    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss, \
        optax.global_norm(grads)

  params = jax.tree_util.tree_map(jnp.asarray, params0)
  opt_state = optimizer.init(params)
  losses_j, norms_j = [], []
  for i in range(n_steps):
    feats = {k: jnp.asarray(v) for k, v in batches[i % 2].items()}
    params, opt_state, loss, norm = jax_step(params, opt_state, feats)
    losses_j.append(float(loss))
    norms_j.append(float(norm))
  assert max(norms_j) > 3.0  # the clip acts

  trainer = Trainer(_port_model('tiny', 'float32', params0), device='cpu',
                    learning_rate=1e-3)
  state = trainer.init(batches[0])
  assert isinstance(state, TrainState)
  assert trainer.param_count(state) == sum(
      int(np.prod(v.shape)) for v in flatten(params0).values())
  noise = torch.from_numpy(_jax_noise(2))
  losses_t = []
  for i in range(n_steps):
    state, losses = trainer.train_step(state, batches[i % 2], noise=noise)
    losses_t.append(float(losses['total_loss']))
  assert state.step == n_steps and state.opt_state['count'] == n_steps
  np.testing.assert_allclose(losses_t[0], losses_j[0], rtol=1e-5)
  np.testing.assert_allclose(losses_t, losses_j, rtol=1e-2)
  assert losses_t[-1] < losses_t[0]

  final_j = {k: np.asarray(v) for k, v in flatten(
      jax.tree_util.tree_map(np.asarray, params)).items()}
  init = flatten(params0)
  keys = sorted(k for k in init if k.startswith('decoder/'))
  change_j = np.concatenate([(final_j[k] - init[k]).ravel() for k in keys])
  change_t = np.concatenate([
      (state.params[k.replace('/', '.')].detach().numpy() - init[k]).ravel()
      for k in keys])
  assert np.abs(change_j).max() > 1e-3
  assert _cosine(change_t, change_j) >= 0.98
  assert (np.linalg.norm(change_t - change_j) /
          np.linalg.norm(change_j)) <= 0.2


def test_clip_and_adam_follow_optax_on_given_gradients():
  """The optimizer alone, on hand-made gradients, against optax: one step
  under the clip limit, one over it, then more. atol 1e-6 on parameters of
  order 1 (a few float32 ulps of the same formulas in another order)."""
  rng = np.random.RandomState(0)
  shapes = {'a': (3, 4), 'b': (5,)}
  params0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
  scales = [0.1, 10.0, 1.0, 30.0, 0.01]
  grads = [{k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in shapes.items()} for scale in scales]
  optimizer = optax.chain(
      optax.clip_by_global_norm(3.0),
      optax.adam(optax.exponential_decay(1e-2, 10, 0.5)))
  params = {k: jnp.asarray(v) for k, v in params0.items()}
  opt_state = optimizer.init(params)
  for g in grads:
    updates, opt_state = optimizer.update(
        {k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
    params = optax.apply_updates(params, updates)

  class Holder(torch.nn.Module):
    def __init__(self):
      super().__init__()
      self.a = torch.nn.Parameter(torch.from_numpy(params0['a'].copy()))
      self.b = torch.nn.Parameter(torch.from_numpy(params0['b'].copy()))

  trainer = Trainer(Holder(), learning_rate=1e-2, lr_decay_steps=10,
                    lr_decay_rate=0.5, device='cpu')
  state = trainer.init()
  norms = []
  for g in grads:
    norm = trainer.apply_gradients(
        state, ['a', 'b'], [state.params['a'], state.params['b']],
        [torch.from_numpy(g['a']), torch.from_numpy(g['b'])])
    norms.append(float(norm))
  assert min(norms) < 3.0 < max(norms)
  for k in shapes:
    np.testing.assert_allclose(state.params[k].detach().numpy(),
                               np.asarray(params[k]), atol=1e-6, rtol=0)


@pytest.mark.parametrize('count', [0, 1, 10000, 25000])
def test_lr_schedule_matches_optax(count):
  model = build_model('tiny', device='cpu', **SMALL)
  trainer = Trainer(model, device='cpu')
  reference = JaxTrainer(j_presets.tiny(**SMALL))
  np.testing.assert_allclose(trainer.lr_schedule(count),
                             float(reference.lr_schedule(count)), rtol=1e-6)
  if count == 0:
    assert trainer.lr_schedule(0) == 3e-4


def _small_trainer(seed=0, **kwargs):
  model = build_model('tiny', device='cpu', seed=seed,
                      compute_dtype='float32', **SMALL)
  return Trainer(model, device='cpu', learning_rate=1e-3, **kwargs)


def test_save_restore_round_trip_and_pruning(tmp_path):
  trainer = _small_trainer(checkpoints_to_keep=2)
  state = trainer.init()
  batch = _batch(seed=3)
  for _ in range(3):
    state, _ = trainer.train_step(state, batch)
    assert trainer.save(state, str(tmp_path)) >= 0.0
  assert Trainer.checkpoint_steps(str(tmp_path)) == [2, 3]  # 1 was pruned
  state, next_losses = trainer.train_step(state, batch)

  other = _small_trainer(seed=7)
  fresh = other.init()
  restored = other.restore(fresh, str(tmp_path))
  assert restored.step == 3 and restored.opt_state['count'] == 3
  _, losses = other.train_step(restored, batch)
  # The same parameters, moments and per-step noise: the same next step.
  assert float(losses['total_loss']) == float(next_losses['total_loss'])
  # Nothing to restore: the state comes back as it was.
  empty = _small_trainer(seed=7)
  state0 = empty.init()
  assert empty.restore(state0, str(tmp_path / 'none')) is state0
  assert state0.step == 0


def test_restore_keys_takes_only_the_named_subtrees(tmp_path):
  trainer = _small_trainer()
  state = trainer.init()
  state, _ = trainer.train_step(state, _batch(seed=4))
  trainer.save(state, str(tmp_path))
  saved = {k: v.detach().clone() for k, v in state.params.items()}

  other = _small_trainer(seed=9)
  fresh = other.init()
  before = {k: v.detach().clone() for k, v in fresh.params.items()}
  restored = other.restore(fresh, str(tmp_path),
                           restore_keys=['decoder', 'no_such_module'])
  assert restored.step == 0 and restored.opt_state['count'] == 0
  for k, v in restored.params.items():
    expected = saved[k] if k.startswith('decoder.') else before[k]
    torch.testing.assert_close(v.detach(), expected, rtol=0, atol=0)
  assert not torch.equal(saved['processor_group.reverb.ir'],
                         before['processor_group.reverb.ir'])


def test_train_on_a_finite_iterator_stops_saves_and_writes_metrics(
    tmp_path, caplog):
  trainer = _small_trainer()
  batches = iter([_batch(seed=i) for i in range(5)])
  with caplog.at_level(logging.INFO, logger='ddsp_torch'):
    state = train(batches, trainer, num_steps=100, steps_per_summary=2,
                  steps_per_save=2, save_dir=str(tmp_path),
                  log_every_step=True)
  assert state.step == 5  # the iterator ran out, and the loop stopped
  assert 'Data iterator exhausted at step 5' in caplog.text
  assert Trainer.checkpoint_steps(str(tmp_path)) == [2, 4, 5]
  lines = [json.loads(l) for l in
           (tmp_path / 'metrics.jsonl').read_text().splitlines()]
  assert [r['step'] for r in lines] == [2, 4]
  assert set(lines[0]) == {'step', 'spectral_loss', 'total_loss',
                           'steps_per_sec'}
  # A second run restores step 5 and has nothing left to do up to 5.
  again = train(iter([_batch()]), _small_trainer(seed=1), num_steps=5,
                save_dir=str(tmp_path))
  assert again.step == 5


def test_train_stops_early_on_the_interval_mean(tmp_path):
  trainer = _small_trainer()
  batch = _batch(seed=5)
  with torch.no_grad():
    first = float(trainer.model(trainer.to_device(batch), return_losses=True,
                                generator=torch.Generator().manual_seed(2))
                  [1]['total_loss'])
  # The first interval's mean is below the first loss only because the
  # loss falls; a limit just under the first loss stops at step 3, not 1.
  state = train(itertools.repeat(batch), trainer, num_steps=30,
                steps_per_summary=3, early_stop_loss_value=first * 0.999,
                save_dir=str(tmp_path))
  assert state.step == 3
  never = train(itertools.repeat(batch), _small_trainer(), num_steps=4,
                steps_per_summary=2, early_stop_loss_value=0.0)
  assert never.step == 4


def test_train_profiles_a_window_of_steps(tmp_path):
  state = train(itertools.repeat(_batch()), _small_trainer(), num_steps=3,
                profile_dir=str(tmp_path), profile_start=1, profile_steps=1)
  assert state.step == 3
  traces = list(tmp_path.glob('*.json'))
  assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_metrics_writer_appends_jsonl(tmp_path):
  writer = MetricsWriter(str(tmp_path / 'logs'))
  writer.scalars(3, {'total_loss': torch.tensor(1.5), 'steps_per_sec': 2})
  writer.close()
  writer = MetricsWriter(str(tmp_path / 'logs'))
  writer.scalars(6, {'total_loss': 1.0})
  writer.close()
  lines = (tmp_path / 'logs' / 'metrics.jsonl').read_text().splitlines()
  assert [json.loads(l) for l in lines] == [
      {'step': 3, 'total_loss': 1.5, 'steps_per_sec': 2.0},
      {'step': 6, 'total_loss': 1.0}]


def test_trainer_refuses_the_cpu_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  model = build_model('tiny', device='cpu', **SMALL)
  with pytest.raises(RuntimeError, match='CUDA'):
    Trainer(model)
  assert Trainer(model, device='cpu').device.type == 'cpu'


def test_training_packages_import_no_jax():
  code = ('import sys, ddsp_torch.train, ddsp_torch.losses, '
          'ddsp_torch.ops.spectral, ddsp_torch.configs; '
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'ddsp_tpu', 'optax', 'orbax', 'tensorflow')]; "
          'print(bad)')
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                       capture_output=True, text=True)
  assert out.stdout.strip() == '[]'
  packages = {p.parent.name for p in (REPO / 'ddsp_torch').rglob('*.py')}
  assert {'losses', 'train'} <= packages
  assert os.path.exists(REPO / 'ddsp_torch' / 'train' / '__init__.py')
