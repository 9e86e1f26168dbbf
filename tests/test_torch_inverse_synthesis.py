"""InverseSynthesis of ddsp_torch against ddsp_tpu's, on the CPU.

The model at a small width (4000 samples: 16 frames of the encoder's log
mel; 8 sinusoids at frequency depth 4, 5 noise bands; the 'small' ResNet;
an RnnSandwich of FcStacks 8 and a GRU of 16; 8 harmonics) on its four
feeds: sinusoidal only (no harmonic encoder), hierarchical with the KDE
and TWM losses and the trainable reverb, self-supervised (ground-truth
controls, synthesized on the fly) and zipped (a (self-supervised, audio)
tuple through one forward of the concatenated rows). The JAX model runs
with a 'noise' stream; its draws (each processor-group call's
FilteredNoise, and the reverb's IR) are recorded and handed to the port's
`synthetic_noise`, `noise` and `harmonic_noise`. Every output leaf, every
loss key and value and every parameter's gradient of the total loss are
compared. Then one Trainer.train_step on a zipped tuple against the JAX
Trainer's, the batch of a ZippedProvider through Trainer.to_device,
TWMEvaluator against the JAX one, the full-width preset's tree, the
serving refusal and the CLI (train from synthetic_notes, eval).

The RnnSandwich's FcStacks run float32 on both sides (the JAX FcStack is
replaced by a float32 subclass of the same name while the JAX model is
built and run, as tests/test_torch_encoders.py swaps FastGRU), so the
comparison is held at the float32 tier; the preset keeps their bf16.

Parameters: the port's, drawn from torch.Generator(0), carried into the
JAX tree as they are (the same names and layouts). Three feeds run a light
sinusoidal encoder (JaxLogmelHeads: the ResNet encoder's log mel and its
Dense heads, no ResNet), which keeps the JAX compilations inside the
file's time; the zipped feed runs the preset's ResnetSinusoidalEncoder
('small'), whose parity alone tests/test_torch_encoders.py holds.

The reconstruction loss is the SpectralLoss's mag term (fft sizes 256
and 128). The logmag term's 1/|X| turns the frameworks' float32 phase
sums (up to 2e-3 of the sinusoidal level's audio) into departures of the
gradients of 2 % (the sinusoidal heads) to 25 % (the reverb's
magnitudes), measured here; tests/test_torch_losses.py holds that term's
gradient on given audio, and the preset test checks that the preset
carries it.

Tolerances:
- network outputs and the losses on them rtol 1e-5, atol 1e-5 (the same
  float32 arithmetic summed in another order); on the feeds whose encoder
  reads synthesized audio (self-supervised, zipped) rtol 2e-4, atol 1e-4:
  the synthetic audio itself departs by ~3e-5 (relative L2; the phase
  sums below) and the log mel passes that on (1e-4 measured);
- audio (every 'signal' and '*audio' leaf past the synthesizers) atol 2e-3
  (1e-3 measured): the JAX Sinusoidal sums its phase with a float32
  cumsum, the port in float64 (ops/oscillator.py phase_cumsum), and the
  sinusoids' phases reach ~1e3 rad in 4000 samples;
- the spectral losses, on that audio, rtol 1e-4;
- gradients, relative L2 per parameter: 2e-3 (1.3e-3 measured: the L1
  terms' sign() of the spectral loss and of the KDE loss's mean-amplitude
  term flips where a difference is within a rounding of zero); 2e-2 for
  the ResNet's convolutions and norms (7.6e-3 measured; its log mel enters
  with a common offset of ~-8 and its layer norms subtract large means:
  tests/test_torch_encoders.py holds the encoder alone to the same 2e-2)
  and for the reverb's magnitudes (the IR's gradient:
  tests/test_torch_midi_models.py).
"""

import contextlib
import json
import sys
from unittest import mock

import flax.linen as fnn

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn as tnn

from ddsp_tpu import losses as j_losses
from ddsp_tpu import models as j_models
from ddsp_tpu import nn as j_nn
from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.eval import evaluators as j_evaluators
from ddsp_tpu.nn import layers as j_layers
from ddsp_tpu.ops import spectral as j_spectral
from ddsp_tpu.parallel import create_mesh
from ddsp_tpu.train import Trainer as JaxTrainer
from ddsp_torch import losses as t_losses
from ddsp_torch import models as t_models
from ddsp_torch import nn as t_nn
from ddsp_torch import run
from ddsp_torch.data import ArrayDataProvider, ZippedProvider
from ddsp_torch.data.multi import SyntheticNotesProvider
from ddsp_torch.eval import TWMEvaluator
from ddsp_torch.eval.eval_util import default_evaluators
from ddsp_torch.infer import AutoencoderInference, export_model
from ddsp_torch.infer.export import unflatten
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.ops import spectral as t_spectral
from ddsp_torch.ops.core import flatten
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model, load_jax_params
from ddsp_torch.utils.registry import get_preset, init_parameters

torch.set_num_threads(1)

SR, N_SAMPLES, N_FRAMES = 16000, 4000, 16
N_SIN, DEPTH, N_NOISE = 8, 4, 5
SPLITS = (('frequencies', N_SIN * DEPTH), ('amplitudes', N_SIN),
          ('noise_magnitudes', N_NOISE))
RTOL = ATOL = 1e-5
AUDIO_ATOL = 2e-3
SPECTRAL_RTOL = 1e-4
SYNTH_INPUT_RTOL, SYNTH_INPUT_ATOL = 2e-4, 1e-4
GRAD_RTOL = 2e-3
RESNET_GRAD_RTOL = 2e-2


class FcStack(j_layers.FcStack):  # pylint: disable=function-redefined
  """The JAX FcStack in float32 (flax names it FcStack_<i>, as the
  original)."""
  compute_dtype: str = 'float32'


class Rnn(j_layers.Rnn):  # pylint: disable=function-redefined
  """The JAX Rnn with a float32 input projection (Rnn_<i>, as the
  original)."""
  compute_dtype: str = 'float32'


def _float32_sandwich():
  """The JAX RnnSandwich's FcStacks and Rnn in float32 while it is built
  and run (flax looks them up in ddsp_tpu.nn.layers at call time)."""
  stack = contextlib.ExitStack()
  stack.enter_context(mock.patch.object(j_layers, 'FcStack', FcStack))
  stack.enter_context(mock.patch.object(j_layers, 'Rnn', Rnn))
  return stack


class JaxLogmelHeads(fnn.Module):
  """A light sinusoidal encoder: the ResnetSinusoidalEncoder's log mel
  (64 bins here) and one Dense head per output, no ResNet."""

  @fnn.compact
  def __call__(self, features, training=True):
    del training
    mag = j_spectral.compute_logmel(features['audio'], lo_hz=0.0,
                                    hi_hz=8000.0, bins=64, fft_size=1024,
                                    overlap=0.75)
    return {k: fnn.Dense(n, name=f'dense_{k}')(mag) for k, n in SPLITS}


class TorchLogmelHeads(tnn.Module):
  """The port's twin of JaxLogmelHeads."""

  def __init__(self):
    super().__init__()
    for k, n in SPLITS:
      self.add_module(f'dense_{k}', t_layers.Dense(64, n))

  @staticmethod
  def n_frames(n_samples):
    return -(-n_samples // 256)

  def forward(self, features, training=True):
    del training
    mag = t_spectral.compute_logmel(features['audio'], lo_hz=0.0,
                                    hi_hz=8000.0, bins=64, fft_size=1024,
                                    overlap=0.75)
    return {k: getattr(self, f'dense_{k}')(mag) for k, _ in SPLITS}


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _audio(seed, batch=2):
  """Tones of 3 partials at 150-400 Hz under a slow envelope, plus noise."""
  rng = np.random.RandomState(seed)
  t = np.arange(N_SAMPLES) / SR
  f0 = 150.0 + 250.0 * rng.rand(batch, 1)
  audio = sum(0.3 / h * np.sin(2 * np.pi * h * f0 * t) for h in (1, 2, 3))
  audio = audio * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * t))
  return (audio + 0.02 * rng.randn(batch, N_SAMPLES)).astype(np.float32)


def _controls(seed, batch=2):
  """Self-supervised controls at the encoder's frames: a gliding f0 of
  100-200 Hz, its N_SIN harmonics (so the synthetic audio stays under
  1.6 kHz, where the two frameworks' phase sums agree to ~1e-5 of the
  audio), a random distribution and amplitude (two frames under the
  harmonic consistency loss's threshold), and noise bands loud enough
  that no bin of the encoder's log mel is near silence (the log of a
  near-silent bin turns the audio's float32 departures into large
  departures of the encoder's outputs)."""
  rng = np.random.RandomState(seed)
  t = np.arange(N_FRAMES) / N_FRAMES
  f0 = (100.0 + 100.0 * rng.rand(batch, 1, 1)) * (
      1.0 + 0.05 * np.sin(2 * np.pi * t))[None, :, None]
  harm_amp = 0.1 + 0.4 * rng.rand(batch, N_FRAMES, 1)
  harm_amp[0, :2] = 5e-5
  harm_dist = rng.dirichlet(np.ones(N_SIN), (batch, N_FRAMES))
  controls = {'f0_hz': f0, 'harm_amp': harm_amp, 'harm_dist': harm_dist,
              'sin_freqs': f0 * np.arange(1, N_SIN + 1),
              'sin_amps': harm_amp * harm_dist,
              'noise_magnitudes': 0.2 + 0.1 * rng.rand(batch, N_FRAMES,
                                                       N_NOISE)}
  return {k: v.astype(np.float32) for k, v in controls.items()}


def _models(harmonic=True, reverb=False, kde=True, twm=False,
            self_supervised=False, resnet=False):
  """(JAX model, port model) of one configuration; the port's parameters
  drawn from torch.Generator(0) are the JAX model's too (`_params`). The
  light sinusoidal encoder unless `resnet`."""
  common = dict(freq_depth=DEPTH, n_samples=N_SAMPLES, sample_rate=SR,
                reverb=reverb)
  kw_j, kw_t = dict(common), dict(common)
  kw_j['losses'] = (j_losses.SpectralLoss(fft_sizes=(256, 128),
                                          logmag_weight=0.0, name='recon'),)
  kw_t['losses'] = (t_losses.SpectralLoss(fft_sizes=(256, 128),
                                          logmag_weight=0.0, name='recon'),)
  if kde:
    kw_j['sinusoidal_consistency_losses'] = (j_losses.KDEConsistencyLoss(
        weight_mean_amp=0.5, name='kde'),)
    kw_t['sinusoidal_consistency_losses'] = (t_losses.KDEConsistencyLoss(
        weight_mean_amp=0.5, name='kde'),)
  if twm:
    kw_j['twm_loss'] = j_losses.TWMLoss(n_harmonic_gaussians=12, name='t')
    kw_t['twm_loss'] = t_losses.TWMLoss(n_harmonic_gaussians=12, name='t')
  if self_supervised:
    kw_j['filtered_noise_consistency_loss'] = (
        j_losses.FilteredNoiseConsistencyLoss(name='fn'))
    kw_t['filtered_noise_consistency_loss'] = (
        t_losses.FilteredNoiseConsistencyLoss(name='fn'))
    kw_j['harmonic_consistency_losses'] = (
        j_losses.HarmonicConsistencyLoss(f0_weight=0.5),)
    kw_t['harmonic_consistency_losses'] = (
        t_losses.HarmonicConsistencyLoss(f0_weight=0.5),)
  harm_j = harm_t = None
  if harmonic:
    harm_j = j_nn.SinusoidalToHarmonicEncoder(
        net=j_nn.RnnSandwich(fc_stack_ch=8, rnn_ch=16), n_harmonics=N_SIN,
        f0_depth=DEPTH)
    net = t_layers.RnnSandwich(2 * N_SIN, fc_stack_ch=8, rnn_ch=16)
    net.FcStack_0 = t_layers.FcStack(2 * N_SIN, 8, 2,
                                     compute_dtype='float32')
    net.Rnn_0 = t_layers.Rnn(8, 16, compute_dtype='float32')
    net.FcStack_1 = t_layers.FcStack(16, 8, 2, compute_dtype='float32')
    harm_t = t_nn.SinusoidalToHarmonicEncoder(net, n_harmonics=N_SIN,
                                              f0_depth=DEPTH)
  if resnet:
    sin_j = j_nn.ResnetSinusoidalEncoder(output_splits=SPLITS)
    sin_t = t_nn.ResnetSinusoidalEncoder(SPLITS)
  else:
    sin_j, sin_t = JaxLogmelHeads(), TorchLogmelHeads()
  model_j = j_models.InverseSynthesis(sinusoidal_encoder=sin_j,
                                      harmonic_encoder=harm_j, **kw_j)
  model_t = t_models.InverseSynthesis(sinusoidal_encoder=sin_t,
                                      harmonic_encoder=harm_t, **kw_t)
  init_parameters(model_t, seed=0)
  with torch.no_grad():
    # Soft frequency logits: sinusoids of some hundred hertz, away from
    # Nyquist (where remove_above_nyquist mutes a sinusoid on a rounding)
    # and from the kilohertz where the float32 phase sums part most.
    model_t.sinusoidal_encoder.dense_frequencies.kernel.mul_(0.1)
  return model_j, model_t


def _params(model_t):
  """The port model's parameters as a JAX tree (the same names and
  layouts: utils/convert.py)."""
  return unflatten({k.replace('.', '/'): jnp.asarray(p.detach().numpy())
                    for k, p in model_t.named_parameters()})


def _record_uniform():
  """A patch of jax.random.uniform that appends each draw to a list."""
  draws, uniform = [], jax.random.uniform

  def recording(*args, **kwargs):
    out = uniform(*args, **kwargs)
    draws.append(out)
    return out

  return draws, mock.patch.object(jax.random, 'uniform', recording)


def _jax_run(model, params, feats, rng):
  """(outputs, losses, gradients of the total loss, the noise draws) of
  the JAX model in training with the 'noise' stream `rng`."""
  draws, patch = _record_uniform()

  def loss_fn(p):
    draws.clear()
    out, losses = model.apply({'params': p}, feats, training=True,
                              return_losses=True, rngs={'noise': rng})
    return losses['total_loss'], (out, losses, list(draws))

  with patch, _float32_sandwich():
    (_, (out, losses, noise)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
  return out, losses, grads, [np.array(n) for n in noise]


def _noise_kwargs(draws, self_supervised, reverb):
  """The JAX draws as the port's noise arguments: the synthetic audio's
  group first where there is one, then the sinusoidal level's, then the
  harmonic level's; each group's FilteredNoise (and reverb IR)."""
  per_group = 2 if reverb else 1
  groups = [draws[i:i + per_group] for i in range(0, len(draws), per_group)]
  as_arg = lambda g: ({'filtered_noise': torch.from_numpy(g[0]),
                       'reverb': torch.from_numpy(g[1])} if reverb else
                      torch.from_numpy(g[0]))
  names = (['synthetic_noise'] if self_supervised else []) + [
      'noise', 'harmonic_noise']
  assert len(groups) <= len(names), len(groups)
  return {name: as_arg(g) for name, g in zip(names, groups)}


def _torch_feats(feats):
  if isinstance(feats, tuple):
    return tuple(_torch_feats(f) for f in feats)
  return {k: torch.from_numpy(np.array(v)) for k, v in feats.items()}


def _is_audio(key):
  return 'signal' in key or key.endswith('audio')


def _grad_rtol(key):
  if key.startswith('sinusoidal_encoder/resnet/'):
    return RESNET_GRAD_RTOL
  if key.endswith('reverb/magnitudes'):
    return RESNET_GRAD_RTOL
  return GRAD_RTOL


def _compare(out_j, losses_j, grads_j, out_t, losses_t, grads_t,
             synthesized_input=False):
  rtol, atol = ((SYNTH_INPUT_RTOL, SYNTH_INPUT_ATOL) if synthesized_input
                else (RTOL, ATOL))
  flat_j = {k: np.asarray(v) for k, v in flatten(dict(out_j)).items()}
  flat_t = {k: _np(v) for k, v in flatten(out_t).items()}
  assert sorted(flat_j) == sorted(flat_t)
  for key, want in flat_j.items():
    got = flat_t[key]
    assert got.shape == want.shape, key
    if _is_audio(key):
      np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL,
                                 err_msg=key)
    else:
      np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                 err_msg=key)
  assert sorted(losses_j) == sorted(losses_t)
  for key, want in losses_j.items():
    np.testing.assert_allclose(
        _np(losses_t[key]), np.asarray(want), atol=atol, err_msg=key,
        rtol=max(rtol, SPECTRAL_RTOL if 'spectral' in key or
                 key == 'total_loss' else 0.0))
  flat_gj = {k: np.asarray(v) for k, v in flatten(grads_j).items()}
  assert sorted(flat_gj) == sorted(grads_t)
  for key, want in flat_gj.items():
    got = grads_t[key]
    got = np.zeros_like(want) if got is None else _np(got)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-6)
    assert err <= _grad_rtol(key), (key, err)


SS_LOSSES = ['harm_spectral_loss', 'kde_consistency_loss',
             'sin_spectral_loss', 'ss_f0_hz_loss',
             'ss_filtered_noise_consistency_loss', 'ss_harm_amp_loss',
             'ss_harm_dist_loss', 'ss_kde_consistency_loss', 'total_loss']
FEEDS = {
    # name: (model options, feed, the loss keys)
    'sinusoidal_only': (dict(harmonic=False, kde=False), 'audio',
                        ['sin_spectral_loss', 'total_loss']),
    'hierarchical': (dict(reverb=True, twm=True), 'audio',
                     ['harm_spectral_loss', 'kde_consistency_loss',
                      'sin_spectral_loss', 'total_loss', 'twm_loss']),
    'self_supervised': (dict(self_supervised=True), 'controls', SS_LOSSES),
}


def _port_run(model_t, feats, noise):
  """(outputs, losses, {name: gradient of the total loss}) of the port."""
  out_t, losses_t = model_t(_torch_feats(feats), training=True,
                            return_losses=True, **noise)
  named = list(model_t.named_parameters())
  grads_t = torch.autograd.grad(losses_t['total_loss'],
                                [p for _, p in named], allow_unused=True)
  return out_t, losses_t, {n.replace('.', '/'): g
                           for (n, _), g in zip(named, grads_t)}


@pytest.mark.parametrize('feed', sorted(FEEDS))
def test_inverse_synthesis_matches_jax(feed):
  """The sinusoidal-only, hierarchical and self-supervised feeds, with the
  light encoder (JaxLogmelHeads). Loss keys: a tuple field's loss by its
  class's snake_case name, a field's own loss by the field's name,
  whatever name each was built with."""
  options, kind, loss_keys = FEEDS[feed]
  model_j, model_t = _models(**options)
  feats = {'audio': _audio(1)} if kind == 'audio' else _controls(2)
  out_j, losses_j, grads_j, draws = _jax_run(
      model_j, _params(model_t), jax.tree_util.tree_map(jnp.asarray, feats),
      jax.random.PRNGKey(7))
  noise = _noise_kwargs(draws, kind != 'audio', options.get('reverb'))
  out_t, losses_t, grads_t = _port_run(model_t, feats, noise)
  assert sorted(losses_t) == loss_keys
  _compare(out_j, losses_j, grads_j, out_t, losses_t, grads_t,
           synthesized_input=kind != 'audio')
  assert tuple(out_t['sinusoidal']['controls']['frequencies'].shape) == (
      2, N_FRAMES, N_SIN)


def test_zipped_feed_and_train_step_match_jax():
  """The zipped feed as the JAX Trainer's step runs it: a
  (self-supervised, audio) tuple (the order parse_zipped_features undoes),
  the noise stream fold_in(PRNGKey(2), 0) (the JAX Trainer's at step 0,
  seed 0), every output, loss and gradient; then Trainer.train_step on the
  tuple against the JAX Trainer's optimizer applied to the JAX gradients:
  the first clipped Adam update moves each parameter by about the learning
  rate, the sign of its gradient's; every element within 1e-3 of the
  learning rate (the difference of a LayerNorm scale near 1 before and
  after the step is exact to 4e-4 of it in float32)."""
  model_j, model_t = _models(self_supervised=True)
  feats = (_controls(3), {'audio': _audio(4)})
  params = _params(model_t)
  out_j, losses_j, grads_j, draws = _jax_run(
      model_j, params, jax.tree_util.tree_map(jnp.asarray, feats),
      jax.random.fold_in(jax.random.PRNGKey(2), 0))
  noise = _noise_kwargs(draws, True, False)
  out_t, losses_t, grads_t = _port_run(model_t, feats, noise)
  assert sorted(losses_t) == SS_LOSSES
  _compare(out_j, losses_j, grads_j, out_t, losses_t, grads_t,
           synthesized_input=True)
  # The real rows' outputs: the processor group's dicts are not sliced.
  assert tuple(out_t['harm_audio'].shape) == (2, N_SAMPLES)
  assert 'sinusoidal' not in out_t

  jax_trainer = JaxTrainer(model_j, mesh=create_mesh(
      n_data=1, devices=jax.devices()[:1]))
  optimizer = jax_trainer.optimizer
  updates, _ = jax.jit(optimizer.update)(grads_j, optimizer.init(params),
                                         params)
  update_j = flatten(jax.tree_util.tree_map(np.asarray, updates))
  before = {k: p.detach().clone() for k, p in model_t.named_parameters()}
  trainer = Trainer(model_t, device='cpu')
  state, losses = trainer.train_step(trainer.init(), feats, **noise)
  assert state.step == 1
  for key, want in losses_j.items():
    np.testing.assert_allclose(losses[key].item(), float(want),
                               rtol=SYNTH_INPUT_RTOL, atol=SYNTH_INPUT_ATOL,
                               err_msg=key)
  lr = float(jax_trainer.lr_schedule(0))
  for name, p in state.params.items():
    got = (p.detach() - before[name]).numpy()
    assert np.abs(got).max() > 0.5 * lr, name
    np.testing.assert_allclose(got, update_j[name.replace('.', '/')],
                               rtol=0, atol=1e-3 * lr, err_msg=name)


def test_trainer_takes_a_zipped_provider_batch():
  """A ZippedProvider batch (a tuple of an audio dict and a controls dict)
  goes through Trainer.to_device as a tuple of float32 tensors on the
  trainer's device and through train_step (a dict-only to_device failed on
  it with an AttributeError)."""
  audio = ArrayDataProvider({'audio': _audio(8, batch=4)})
  notes = SyntheticNotesProvider(N_FRAMES, N_SIN, N_NOISE, n_examples=4,
                                 device='cpu')
  batch = next(ZippedProvider([audio, notes]).get_batch(4))
  assert isinstance(batch, tuple) and len(batch) == 2
  _, model_t = _models(self_supervised=True)
  trainer = Trainer(model_t, device='cpu')
  moved = trainer.to_device(batch)
  assert isinstance(moved, tuple) and sorted(moved[0]) == ['audio']
  for part in moved:
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
               and v.device.type == 'cpu' for v in part.values())
  state, losses = trainer.train_step(trainer.init(), batch)
  assert state.step == 1 and np.isfinite(losses['total_loss'].item())
  assert 'ss_kde_consistency_loss' in losses


def test_twm_evaluator_matches_jax():
  """The TWM f0 of the sinusoids' controls and its F0 metrics, as the JAX
  evaluator gives them (its unit test's harmonic partials, and partials
  with a slow glide and two inharmonic ones)."""
  t, k = 30, 8
  n = np.arange(1, k + 1, dtype=np.float32)
  rng = np.random.RandomState(9)
  f0 = np.concatenate([np.full((1, t, 1), 220.0),
                       np.linspace(180, 260, t)[None, :, None]], axis=0)
  freqs = f0 * n
  freqs[1, :, -2:] = 500.0 + 2000.0 * rng.rand(t, 2)
  amps = np.broadcast_to(1.0 / n, freqs.shape).copy()
  outputs = {'sinusoidal': {'controls': {
      'frequencies': freqs.astype(np.float32),
      'amplitudes': amps.astype(np.float32)}}}
  batch = {'f0_hz': f0[..., 0].astype(np.float32),
           'f0_confidence': np.ones((2, t), np.float32)}
  ev_j = j_evaluators.TWMEvaluator(frame_rate=250)
  ev_t = TWMEvaluator(frame_rate=250, device='cpu')
  # pylint: disable=protected-access
  f0_j = ev_j._compute_twm_f0(outputs)
  np.testing.assert_array_equal(ev_t.compute_twm_f0(outputs), f0_j)
  # The JAX evaluate() on that f0 (one eager JAX TWM, not two).
  ev_j._f0_twm_metrics.update_state(batch, f0_j)
  ev_t.evaluate(batch, outputs, {})
  want, got = ev_j.flush(step=0), ev_t.flush(step=0)
  assert sorted(got) == sorted(want) and got
  for key, value in want.items():
    np.testing.assert_allclose(got[key], value, rtol=RTOL, err_msg=key)
  assert got['metrics/f0_twm/raw_pitch_accuracy'] > 0.9


def test_full_width_preset_loads_the_jax_tree():
  """build_model('inverse_synthesis') at the preset's widths, with the
  optional reverb, takes the JAX preset's tree (jax.eval_shape: nothing
  computed) strictly (names and shapes: the model is built on the meta
  device): the reverb's magnitudes at processor_group/reverb,
  60 583 882 parameters besides them; a missing leaf raises. The ResNet
  normalizes by layer: no batch_stats. The preset's reconstruction loss
  has the logmag term, and its control frames are the encoder's."""
  model_j = j_presets.inverse_synthesis(n_samples=N_SAMPLES, reverb=True)
  shapes = jax.eval_shape(lambda: model_j.init(
      {'params': jax.random.PRNGKey(0)},
      {'audio': jnp.zeros((1, N_SAMPLES))}, training=True))
  assert sorted(shapes) == ['params']
  zeros = {k: np.zeros(v.shape, np.float32)
           for k, v in flatten(shapes['params']).items()}
  assert len(zeros) == 191
  assert zeros['sinusoidal_encoder/dense_frequencies/kernel'].shape == (
      8192, 6400)
  assert zeros['harmonic_encoder/net/Rnn_0/FastGRU_0/wh'].shape == (512,
                                                                     1536)
  assert zeros['processor_group/reverb/magnitudes'].shape == (500, 16)
  # On the meta device: the names and shapes without drawing 60 M values.
  with torch.device('meta'):
    model_t = get_preset('inverse_synthesis')(n_samples=N_SAMPLES,
                                              reverb=True)
  load_jax_params(model_t, zeros)
  assert sum(v.size for v in zeros.values()) == 60583882 + 500 * 16
  assert model_t.n_frames == N_FRAMES
  (spectral,) = model_t.losses
  assert (spectral.mag_weight, spectral.logmag_weight) == (1.0, 1.0)
  del zeros['processor_group/reverb/magnitudes']
  with pytest.raises(ValueError, match='missing.*reverb/magnitudes'):
    load_jax_params(model_t, zeros)


def test_default_evaluators():
  """BasicEvaluator on harm_audio (sin_audio without a harmonic encoder),
  and TWMEvaluator where the batch's f0_hz has the model's frames."""
  _, model = _models()
  provider = ArrayDataProvider({'audio': _audio(10)})
  evs = default_evaluators(model, provider, 'cpu',
                           {'f0_hz': np.zeros((2, N_FRAMES, 1))})
  assert [type(e).__name__ for e in evs] == ['BasicEvaluator',
                                             'TWMEvaluator']
  assert evs[0]._audio_key == 'harm_audio'  # pylint: disable=protected-access
  evs = default_evaluators(model, provider, 'cpu',
                           {'f0_hz': np.zeros((2, 250, 1))})
  assert [type(e).__name__ for e in evs] == ['BasicEvaluator']
  _, model = _models(harmonic=False)
  evs = default_evaluators(model, provider, 'cpu', {})
  assert evs[0]._audio_key == 'sin_audio'  # pylint: disable=protected-access


def test_cli_trains_from_synthetic_notes_evaluates_and_serving_refuses(
    tmp_path, monkeypatch):
  """ddsp-torch-run --preset inverse_synthesis --data synthetic_notes: one
  step, an eval and a sample. The notes come at the encoder's frames (16
  at 4000 samples; the JAX CLI gives them 125 and its KDE loss fails on
  the shapes); the eval reports the losses and the TWM f0 metrics; the
  sample writes the audio synthesized from the notes as the original
  (the JAX evaluators fail on this model's outputs). Then
  AutoencoderInference and export_model (both formats) refuse the
  directory, naming the audio encoder (the JAX package fails on it with a
  KeyError for 'audio'). The metrics go to metrics.jsonl only
  (torch.utils.tensorboard made unimportable: it imports TensorFlow here,
  12 s; tests/test_torch_run.py covers the event files)."""
  monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
  kw = dict(n_samples=N_SAMPLES, n_sinusoids=N_SIN, n_harmonics=N_SIN)
  save_dir = str(tmp_path / 'run')
  common = ['--save_dir', save_dir, '--data', 'synthetic_notes',
            '--batch_size', '2', '--device', 'cpu']
  state = run.main(['--mode', 'train', '--preset', 'inverse_synthesis',
                    '--model_kwargs', json.dumps(kw), '--num_steps', '1',
                    '--steps_per_summary', '1', '--steps_per_save', '1'] +
                   common)
  assert state.step == 1
  scalars = run.main(['--mode', 'eval', '--num_eval_batches', '1',
                      '--run_once'] + common)
  assert 'losses/ss_kde_consistency_loss' in scalars
  assert 'metrics/f0_twm/raw_pitch_accuracy' in scalars
  assert all(np.isfinite(v) for v in scalars.values())
  # Sample: the notes' synthesized audio is the original beside harm_audio.
  run.main(['--mode', 'sample', '--num_eval_batches', '1', '--run_once'] +
           common)
  samples = tmp_path / 'run' / 'samples' / 'step_1'
  assert (samples / '0_original.wav').exists()
  assert (samples / '0_synth.wav').exists()
  match = r'encodes audio.*ResnetSinusoidalEncoder'
  with pytest.raises(ValueError, match=match):
    AutoencoderInference(save_dir, device='cpu')
  for fmt in ('params', 'torch_export'):
    with pytest.raises(ValueError, match=match):
      export_model(save_dir, str(tmp_path / fmt), fmt=fmt, device='cpu')
