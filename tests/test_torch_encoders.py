"""The ae preset and the encoders of ddsp_torch against ddsp_tpu, on the CPU.

The ae preset (MFCC-RNN encoder, z-conditioned decoder) at a small width:
its forward, one step's loss and gradients, and one Trainer step against
the JAX model with the same parameters (load_jax_params), batch and noise
(the JAX model applied without rngs draws uniform(PRNGKey(0)), handed to
the port). Then each of the eleven encoders against its JAX counterpart,
the refusal of AutoencoderInference and export_model on an ae directory,
and the CLI training and evaluating ae.

The encoder's GRU runs in bf16 in both packages whatever compute_dtype
says. At H = 32 it streams float32 on both sides (the JAX scan; the port's
FastGRU below BF16_HIDDEN_MULTIPLE). At H = 128 (`ae_bf16_streams`) both
sides take the bf16 stream route: the port's K2 plain versions, the JAX
package's Pallas kernel in interpret mode (its FastGRU with use_pallas).

Tolerances (tests/test_torch_model.py's _compare, test_torch_train.py's
step tiers): float32 controls 1e-5 (z and the controls it reaches 1e-3,
_compare says why), audio 4e-3 (the two frameworks' float32 phase sums),
bf16 controls 5e-2 and audio relative L2 5e-2;
loss rtol 1e-5 (float32) or 2e-3 (bf16); gradients relative L2 1e-3
(float32) or 0.15 with cosine 0.99 (bf16).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.nn import encoders as j_enc
from ddsp_tpu.nn import layers as j_layers
from ddsp_tpu.train import Trainer as JaxTrainer
from ddsp_torch import run
from ddsp_torch.infer import AutoencoderInference, export_model
from ddsp_torch.infer.export import unflatten
from ddsp_torch.nn import encoders as t_enc
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.ops.core import flatten
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model, load_jax_params, save_spec

torch.set_num_threads(1)

# The forward at 0.5 s: 16 MFCC frames, enough for the bf16 stream route
# (FastGRU.MIN_BF16_STEPS). A training step at 0.2 s: the ae takes no
# angular cumsum in either package, and the two frameworks' plain float32
# phase sums drift apart with length (10x the gradients' gap at 0.5 s).
N_SAMPLES, N_FRAMES, SR = 8000, 125, 16000
STEP_SAMPLES, STEP_FRAMES = 3200, 50
AE_KW = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, rnn_channels=32, ch=16,
             layers_per_stack=1, n_harmonics=8, n_noise_magnitudes=9,
             z_dims=4)
STEP_KW = dict(AE_KW, n_samples=STEP_SAMPLES, time_steps=STEP_FRAMES)
CASES = {
    'float32': dict(AE_KW, compute_dtype='float32'),
    'bfloat16': dict(AE_KW, compute_dtype='bfloat16'),
    'ae_bf16_streams': dict(AE_KW, rnn_channels=128,
                            compute_dtype='bfloat16'),
    'step_float32': dict(STEP_KW, compute_dtype='float32'),
    'step_bfloat16': dict(STEP_KW, compute_dtype='bfloat16'),
}


def _batch(seed=0, batch=2, n_samples=N_SAMPLES):
  """Harmonic tones with a gliding f0 plus noise, and their f0 frames."""
  rng = np.random.RandomState(seed)
  n_frames = n_samples // 64
  frames = np.arange(n_frames) / 250.0
  f0 = 110.0 * 2.0**(0.5 * rng.rand(batch, 1) +
                     0.1 * np.sin(2 * np.pi * 1.5 * frames)[None])
  phase = 2 * np.pi * np.cumsum(np.repeat(f0, 64, axis=1), axis=1) / SR
  audio = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
  audio = audio + 0.02 * rng.randn(batch, n_samples)
  return {'audio': audio.astype(np.float32),
          'f0_hz': f0.astype(np.float32)[:, :, None]}


def _jax_noise(batch=2, n_samples=N_SAMPLES):
  return np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                     (batch, n_samples), minval=-1.0,
                                     maxval=1.0))


class _PallasFastGRU(j_layers.FastGRU):
  """The JAX FastGRU on its Pallas kernel (interpret mode off the TPU)."""
  use_pallas: bool = True


_PallasFastGRU.__name__ = 'FastGRU'  # flax names the submodule FastGRU_0


@pytest.fixture
def jax_gru_route(monkeypatch):
  """Put the JAX package's FastGRUs on their Pallas kernel for a case."""

  def route(case):
    if case == 'ae_bf16_streams':
      monkeypatch.setattr(j_layers, 'FastGRU', _PallasFastGRU)

  return route


_JAX_MODELS = {}


def _jax_model_and_params(case):
  """The JAX ae and its parameters, built once per case: an audible noise
  floor in every bin (the head's noise bias raised), so the logmag term's
  1/|bin| conditions no gradient."""
  if case not in _JAX_MODELS:
    model = j_presets.ae(**CASES[case])
    feats = {k: jnp.asarray(v) for k, v in _batch(
        n_samples=CASES[case]['n_samples']).items()}
    variables = jax.jit(lambda key, f: model.init(
        {'params': key}, f, training=True, return_losses=True))(
            jax.random.PRNGKey(0), feats)
    params = jax.tree_util.tree_map(np.array, variables['params'])
    bias = params['decoder']['dense_out']['bias'].copy()
    bias[-CASES[case]['n_noise_magnitudes']:] = 4.0
    params['decoder']['dense_out']['bias'] = bias
    _JAX_MODELS[case] = (model, params)
  return _JAX_MODELS[case]


def _port_model(case, params):
  model = build_model('ae', device='cpu', **CASES[case])
  load_jax_params(model, params)
  return model


def _torch_batch(batch):
  return {k: torch.from_numpy(v) for k, v in batch.items()}


def _cosine(a, b):
  a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
  return a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30)


# Features the encoder does not reach.
_BEFORE_Z = ('f0_hz', 'f0_scaled', 'ld_scaled', 'loudness_db')


def _compare(out_j, out_t, bf16):
  """tests/test_torch_model.py's tiers, but z and what follows from it at
  1e-3 in float32: the encoder's GRU is bf16 in both packages, and where
  the two float32 MFCC computations round one input element to
  neighbouring bf16 values (2^-8 apart) z moves by up to 2.0e-4 (the
  controls by 3.1e-4) for the forward's seed."""
  flat_j = {k: np.asarray(v) for k, v in flatten(out_j).items()}
  flat_t = {k: v.detach().float().numpy() for k, v in flatten(out_t).items()}
  assert sorted(flat_j) == sorted(flat_t)
  for key, a in flat_j.items():
    b = flat_t[key]
    assert b.shape == a.shape, key
    is_audio = 'signal' in key or 'audio' in key
    if is_audio and bf16:
      rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-12)
      assert rel <= 5e-2, (key, rel)
    else:
      before_z = key.split('/')[-1] in _BEFORE_Z
      atol = 4e-3 if is_audio else (
          5e-2 if bf16 else 1e-5 if before_z else 1e-3)
      np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=key)


def test_full_width_ae_builds_with_the_jax_tree():
  """build_model('ae') at the preset's defaults: the JAX tree's every
  key and shape (jax.eval_shape, nothing computed), the encoder's GRU bf16
  on the decoder's dtype float32 too."""
  model_j = j_presets.ae()
  feats = {'audio': jnp.zeros((1, 64000)), 'f0_hz': jnp.zeros((1, 1000, 1))}
  shapes = jax.eval_shape(lambda: model_j.init(
      jax.random.PRNGKey(0), feats, training=False))['params']
  shapes = {k: tuple(v.shape) for k, v in flatten(shapes).items()}
  model_t = build_model('ae', device='cpu')
  assert {n.replace('.', '/'): tuple(p.shape)
          for n, p in model_t.named_parameters()} == shapes
  assert shapes['encoder/rnn/FastGRU_0/wh'] == (512, 1536)
  assert shapes['decoder/dense_out/kernel'] == (512, 1 + 100 + 65)
  model_32 = build_model('ae', device='cpu', compute_dtype='float32')
  assert model_32.encoder.rnn.FastGRU_0.dtype == torch.bfloat16
  assert model_32.decoder.rnn.FastGRU_0.dtype == torch.float32
  with pytest.raises(ValueError, match='z_time_steps'):
    build_model('ae', device='cpu', z_time_steps=100)


@pytest.mark.parametrize('case', ['float32', 'bfloat16', 'ae_bf16_streams'])
def test_ae_forward_matches_jax(case, jax_gru_route):
  jax_gru_route(case)
  model_j, params = _jax_model_and_params(case)
  batch = _batch(seed=1)
  out_j = model_j.apply({'params': params},
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        training=False)
  model_t = _port_model(case, params)
  encoder_gru = model_t.encoder.rnn.FastGRU_0
  with torch.no_grad():
    xp_dtype = []
    hook = encoder_gru.register_forward_hook(
        lambda m, i, o: xp_dtype.append(m.dtype))
    out_t = model_t(_torch_batch(batch), training=False,
                    noise=torch.from_numpy(_jax_noise()))
    hook.remove()
  assert xp_dtype == [torch.bfloat16]
  assert out_t['z'].shape == (2, N_FRAMES, 4)
  _compare(out_j, out_t, bf16=CASES[case]['compute_dtype'] == 'bfloat16')


def _jax_loss_fn(model, batch):
  feats = {k: jnp.asarray(v) for k, v in batch.items()}

  def loss_fn(params):
    _, losses = model.apply({'params': params}, feats, training=True,
                            return_losses=True)
    return losses['total_loss']

  return loss_fn


@pytest.mark.parametrize('case', ['step_float32', 'step_bfloat16'])
def test_ae_step_loss_and_gradients_match_jax(case):
  """float32: loss rtol 1e-4, gradients relative L2 5e-3 and cosine
  0.9999, not the decoder-only 1e-5 and 1e-3 of test_torch_train.py: the
  encoder's GRU is bf16 in both packages, and where its inputs round to
  neighbouring bf16 values in the two frameworks the gradients move by up
  to 3.4e-3 (the encoder's wi) and the loss by up to 2.8e-5 (the Trainer
  step's batch). bf16: each gradient relative L2 0.2 and cosine 0.98 (the
  z stack's kernel, z's 4 channels correlated with its cotangent over 100
  frames, measured 0.151 and 0.9885; every other key within
  test_torch_train.py's 0.15 and 0.99), the decoder and the encoder as a
  whole cosine 0.995."""
  model_j, params = _jax_model_and_params(case)
  batch = _batch(seed=2, n_samples=STEP_SAMPLES)
  loss_j, grads_j = jax.jit(jax.value_and_grad(
      _jax_loss_fn(model_j, batch)))(params)
  grads_j = {k: np.asarray(v) for k, v in flatten(grads_j).items()}
  model_t = _port_model(case, params)
  _, losses_t = model_t(_torch_batch(batch), training=True,
                        return_losses=True,
                        noise=torch.from_numpy(_jax_noise(2, STEP_SAMPLES)))
  names = [k for k, _ in model_t.named_parameters()]
  grads_t = torch.autograd.grad(losses_t['total_loss'],
                                [p for _, p in model_t.named_parameters()])
  grads_t = {k.replace('.', '/'): g.numpy() for k, g in zip(names, grads_t)}
  assert sorted(grads_t) == sorted(grads_j)
  assert any(k.startswith('encoder/') for k in grads_t)
  bf16 = case == 'step_bfloat16'
  np.testing.assert_allclose(losses_t['total_loss'].item(), float(loss_j),
                             rtol=2e-3 if bf16 else 1e-4)
  for key, g_j in grads_j.items():
    g_t = grads_t[key]
    assert np.isfinite(g_t).all() and np.abs(g_t).max() > 0, key
    rel = np.linalg.norm(g_t - g_j) / np.linalg.norm(g_j)
    assert rel <= (0.2 if bf16 else 5e-3), (key, rel)
    assert _cosine(g_t, g_j) >= (0.98 if bf16 else 0.9999), key
  for part in ('decoder/', 'encoder/'):
    keys = sorted(k for k in grads_j if k.startswith(part))
    whole_t = np.concatenate([grads_t[k].ravel() for k in keys])
    whole_j = np.concatenate([grads_j[k].ravel() for k in keys])
    assert _cosine(whole_t, whole_j) >= (0.995 if bf16 else 0.99999), part


def test_ae_trainer_step_matches_the_jax_optimizer():
  """One Trainer.train_step against one jitted step of the JAX Trainer's
  optimizer: the loss (rtol 1e-4, as the step above) and the change of every parameter
  (cosine 0.98, relative L2 0.2: Adam's first update is -lr sign(g), and
  gradients near zero may differ in sign between the frameworks)."""
  model_j, params0 = _jax_model_and_params('step_float32')
  batch = _batch(seed=3, n_samples=STEP_SAMPLES)
  optimizer = JaxTrainer(model_j, learning_rate=1e-3).optimizer

  @jax.jit
  def jax_step(params, opt_state):
    loss, grads = jax.value_and_grad(_jax_loss_fn(model_j, batch))(params)
    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), loss

  params = jax.tree_util.tree_map(jnp.asarray, params0)
  params_j, loss_j = jax_step(params, optimizer.init(params))

  trainer = Trainer(_port_model('step_float32', params0), device='cpu',
                    learning_rate=1e-3)
  state = trainer.init(batch)
  state, losses = trainer.train_step(
      state, batch, noise=torch.from_numpy(_jax_noise(2, STEP_SAMPLES)))
  np.testing.assert_allclose(float(losses['total_loss']), float(loss_j),
                             rtol=1e-4)
  init = flatten(params0)
  final_j = flatten(jax.tree_util.tree_map(np.asarray, params_j))
  keys = sorted(init)
  assert any(k.startswith('encoder/') for k in keys)
  change_j = np.concatenate([(final_j[k] - init[k]).ravel() for k in keys])
  change_t = np.concatenate([
      (state.params[k.replace('/', '.')].detach().numpy() - init[k]).ravel()
      for k in keys])
  assert np.abs(change_j).max() > 1e-4
  assert _cosine(change_t, change_j) >= 0.98
  assert np.linalg.norm(change_t - change_j) / np.linalg.norm(
      change_j) <= 0.2


# --- the eleven encoders -------------------------------------------------

def _x(shape, seed=0, scale=1.0, offset=0.0):
  rng = np.random.RandomState(seed)
  return (offset + scale * rng.randn(*shape)).astype(np.float32)


def _audio(n=N_SAMPLES, seed=0):
  t = np.arange(n) / SR
  return (0.3 * np.sin(2 * np.pi * 330 * t)[None] +
          0.05 * _x((2, n), seed)).astype(np.float32)


def _fc_stacks(in_ch, ch=8):
  """A float32 FcStack net of both packages."""
  return (j_layers.FcStack(ch, 1, compute_dtype='float32'),
          t_layers.FcStack(in_ch, ch, 1, compute_dtype='float32'))


def _encoder_case(name):
  """(JAX encoder, port encoder, inputs by key, float32 atol)."""
  f0_scaled = _x((2, 50, 1), 1, 0.1, 0.5)
  ld_scaled = _x((2, 50, 1), 2, 0.1, 0.5)
  if name == 'MfccTimeDistributedRnnEncoder':
    return (j_enc.MfccTimeDistributedRnnEncoder(
        rnn_channels=16, z_dims=4, z_time_steps=125),
            t_enc.MfccTimeDistributedRnnEncoder(16, 'gru', 4, 125),
            {'audio': _audio(), 'f0_scaled': _x((2, N_FRAMES, 1), 1)}, 1e-5)
  if name == 'OneHotEncoder':
    return (j_enc.OneHotEncoder(vocab_size=5, z_dims=3),
            t_enc.OneHotEncoder(vocab_size=5, z_dims=3),
            {'instrument_id': np.array([4, 1], np.int32),
             'f0_scaled': f0_scaled}, 0.0)
  if name == 'AggregateFeaturesEncoder':
    return (j_enc.AggregateFeaturesEncoder(ch=6),
            t_enc.AggregateFeaturesEncoder(ch=6),
            {'f0_scaled': f0_scaled, 'ld_scaled': ld_scaled}, 1e-5)
  if name == 'MfccEncoder':
    kw = dict(fft_sizes=(1024, 512), mel_bins=(64, 32), mfcc_bins=(12, 6),
              time_steps=40)
    return (j_enc.MfccEncoder(**kw), t_enc.MfccEncoder(**kw),
            {'audio': _audio(), 'f0_scaled': f0_scaled}, 1e-4)
  if name.startswith('MfccRnnEncoder'):
    mean = name.endswith('mean')
    return (j_enc.MfccRnnEncoder(rnn_channels=16, z_dims=5,
                                 mean_aggregate=mean),
            t_enc.MfccRnnEncoder(16, 'gru', 5, mean_aggregate=mean),
            {'audio': _audio(), 'f0_scaled': f0_scaled}, 1e-5)
  if name in ('MidiEncoder', 'HarmonicToMidiEncoder'):
    feats = {'f0_midi': _x((2, 50, 1), 3, 5.0, 60.0)}
    if name == 'MidiEncoder':
      feats['loudness'] = _x((2, 50, 1), 4, 10.0, -40.0)
    else:
      feats.update(amps=_x((2, 50, 1), 4), hd=_x((2, 50, 5), 5),
                   noise=_x((2, 50, 4), 6))
    j_net, t_net = _fc_stacks(sum(v.shape[-1] for v in feats.values()))
    return (getattr(j_enc, name)(net=j_net), getattr(t_enc, name)(t_net),
            feats, 1e-4)
  if name.startswith('ExpressionEncoder'):
    keys = ('f0_scaled', 'ld_scaled')
    feats = {'f0_scaled': f0_scaled, 'ld_scaled': ld_scaled}
    in_ch = 2
    if name.endswith('audio'):
      keys += ('audio',)
      feats['audio'] = _audio()
      in_ch += 60
    j_net, t_net = _fc_stacks(in_ch)
    return (j_enc.ExpressionEncoder(net=j_net, z_dims=3, input_keys=keys),
            t_enc.ExpressionEncoder(t_net, z_dims=3, input_keys=keys),
            feats, 1e-5)
  if name == 'SinusoidalToHarmonicEncoder':
    j_net, t_net = _fc_stacks(12)
    feats = {'sin_freqs': np.abs(_x((2, 50, 6), 7, 300.0, 600.0)),
             'sin_amps': np.abs(_x((2, 50, 6), 8, 0.1))}
    return (j_enc.SinusoidalToHarmonicEncoder(net=j_net, n_harmonics=7,
                                              f0_depth=16),
            t_enc.SinusoidalToHarmonicEncoder(t_net, n_harmonics=7,
                                              f0_depth=16),
            feats, 1e-4)
  assert name == 'ResnetSinusoidalEncoder'
  splits = (('frequencies', 12), ('amplitudes', 3), ('noise_magnitudes', 4))
  return (j_enc.ResnetSinusoidalEncoder(output_splits=splits),
          t_enc.ResnetSinusoidalEncoder(splits),
          {'audio': _audio(2048)[:1]}, 1e-4)


ENCODERS = ['MfccTimeDistributedRnnEncoder', 'OneHotEncoder',
            'AggregateFeaturesEncoder', 'MfccEncoder', 'MfccRnnEncoder',
            'MfccRnnEncoder_mean', 'MidiEncoder', 'HarmonicToMidiEncoder',
            'ExpressionEncoder', 'ExpressionEncoder_audio',
            'SinusoidalToHarmonicEncoder', 'ResnetSinusoidalEncoder']


@pytest.mark.parametrize('name', ENCODERS)
def test_encoder_matches_jax(name):
  """Values at the float32 tier (relative to each output's largest element
  where a log mel or MFCC sums in another order), and the gradient of the
  parameters through a weighted sum of the outputs, relative L2 1e-3;
  2e-2 for ResnetSinusoidalEncoder: its log mel enters the ResNet with a
  common offset of about -8 over a spread of a few units, each layer norm
  subtracts a large mean in float32, and the frameworks' roundings there
  move the deep layers' gradients by up to 9.4e-3 even when both are fed
  the same log mel (on a zero-mean input the ResNet's gradients agree to
  1e-5, tests/test_torch_layers_rnn.py)."""
  j_mod, t_mod, feats, atol = _encoder_case(name)
  grad_rtol = 2e-2 if name == 'ResnetSinusoidalEncoder' else 1e-3
  j_feats = {k: jnp.asarray(v) for k, v in feats.items()}
  variables = jax.jit(j_mod.init)(jax.random.PRNGKey(0), j_feats)
  params = jax.tree_util.tree_map(np.array, variables['params'])
  flat = flatten(params)
  rng = np.random.RandomState(11)
  for k, v in flat.items():  # non-zero biases and shifts
    if k.endswith('bias') or k.endswith('shift'):
      flat[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
  load_jax_params(t_mod, flat)
  params = unflatten(flat)
  out_j = {k: np.asarray(v) for k, v in j_mod.apply(
      {'params': params}, j_feats).items()}
  out_t = t_mod({k: torch.from_numpy(v) for k, v in feats.items()})
  assert sorted(out_t) == sorted(out_j)
  weights = {k: _x(v.shape, 12) for k, v in out_j.items()}
  for k, v in out_j.items():
    assert tuple(out_t[k].shape) == v.shape, k
    np.testing.assert_allclose(out_t[k].detach().numpy(), v,
                               atol=atol * max(1.0, np.abs(v).max()),
                               err_msg=k)

  def jax_objective(p):
    out = j_mod.apply({'params': p}, j_feats)
    return sum(jnp.sum(out[k] * weights[k]) for k in out)

  grads_j = flatten(jax.jit(jax.grad(jax_objective))(params))
  objective = sum((out_t[k] * torch.from_numpy(weights[k])).sum()
                  for k in out_t)
  named = list(t_mod.named_parameters())
  grads_t = torch.autograd.grad(objective, [p for _, p in named],
                                allow_unused=True)
  for (n, _), g_t in zip(named, grads_t):
    g_j = np.asarray(grads_j[n.replace('.', '/')])
    g_t = np.zeros_like(g_j) if g_t is None else g_t.numpy()
    scale = max(np.linalg.norm(g_j), 1e-6)
    assert np.linalg.norm(g_t - g_j) / scale <= grad_rtol, n


def test_mfcc_encoder_refuses_other_z_time_steps():
  with pytest.raises(ValueError, match='z_time_steps'):
    t_enc.MfccTimeDistributedRnnEncoder(z_time_steps=100)


# --- serving refusal and the CLI -----------------------------------------

def _ae_train_dir(path):
  save_spec(str(path), 'ae', **AE_KW)
  trainer = Trainer(build_model('ae', device='cpu', seed=0, **AE_KW),
                    device='cpu')
  trainer.save(trainer.init(), str(path))
  return str(path)


def test_serving_refuses_an_ae_directory(tmp_path):
  """AutoencoderInference and export_model (both formats) raise a
  ValueError naming the encoder's audio input; the JAX package fails on
  such a directory with a KeyError for 'audio'."""
  save_dir = _ae_train_dir(tmp_path / 'train')
  match = "encodes audio.*'audio'"
  with pytest.raises(ValueError, match=match):
    AutoencoderInference(save_dir, device='cpu')
  for fmt in ('params', 'torch_export'):
    with pytest.raises(ValueError, match=match):
      export_model(save_dir, str(tmp_path / fmt), fmt=fmt, device='cpu')


def test_cli_trains_and_evaluates_ae(tmp_path):
  save_dir = str(tmp_path / 'run')
  common = ['--save_dir', save_dir, '--data', 'synthetic:4', '--batch_size',
            '2', '--device', 'cpu']
  state = run.main(['--mode', 'train', '--preset', 'ae', '--model_kwargs',
                    json.dumps(AE_KW), '--num_steps', '2',
                    '--steps_per_summary', '1', '--steps_per_save', '2'] +
                   common)
  assert state.step == 2
  assert any(k.startswith('encoder.') for k in state.params)
  scalars = run.main(['--mode', 'eval', '--num_eval_batches', '1',
                      '--run_once'] + common)
  assert np.isfinite(scalars['losses/total_loss'])
