"""The MIDI autoencoders of ddsp_torch against ddsp_tpu, on the CPU.

The midiae preset at a small width (ch 8, n_samples 3200, 50 frames, 8
harmonics, 9 noise bands, a 1000-tap trainable reverb) on the MIDI-encoder
path and on the ground-truth path (use_midi_encoder=False, the MIDI from
'note_active_velocities'), and a ZMidiAutoencoder with synth, global and
note latents, a conditional dilated-conv MIDI decoder and a prior. The JAX
model runs with a 'noise' stream; its four draws (each branch's
FilteredNoise and reverb IR, in call order) are recorded and handed to the
port, the synthcoder branch's as `noise` and the MIDI branch's as
`midi_noise`. Every output leaf and every loss key and value is compared,
and the gradients of the total loss. Then midi_to_audio (a MIDI request),
a strict load of the full-width midiae tree, the serving refusal and the
CLI on both paths.

Tolerances: float32 network outputs and losses rtol 1e-5 (atol 1e-5 on
O(1)-O(100) values; XLA's and oneDNN's convolutions round apart by ulps;
a loss of |z_pitch - q_pitch| keeps the ulps of pitches near 50, 4e-6);
audio (every 'signal', 'audio' leaf past the synthesizers) atol 1e-3: the
two frameworks' float32 phase sums (the JAX harmonic synthesis, its Pallas
kernel in interpret mode, against the port's float64 phase_cumsum) part by
~1e-4 rad over 3200 samples; the spectral loss, computed on that audio,
rtol 1e-4; gradients relative L2 1e-3 per parameter (the spectral loss's
logmag term divides by |bin|; the synthcoder's noise bias is raised so
every bin has an audible floor, as tests/test_torch_encoders.py does),
but the trainable reverb's magnitudes 1e-2: their gradient is the IR's,
correlations over the whole signal that cancel to a small part of their
bound, so the audio's 1e-4 moves them most (2.5e-3 here; the IR of
tests/test_torch_train.py is held to 0.1 for the same reason).
"""

import json
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
from ddsp_torch import losses as t_losses
from ddsp_torch import models as t_models
from ddsp_torch import nn as t_nn
from ddsp_torch import run
from ddsp_torch.data import tfrecord
from ddsp_torch.infer import AutoencoderInference, export_model
from ddsp_torch.ops.core import flatten
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model, load_jax_params, save_spec

torch.set_num_threads(1)

SR, N_SAMPLES, N_FRAMES = 16000, 3200, 50
MIDI_KW = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, ch=8,
               layers_per_stack=2, stacks=1, n_harmonics=8,
               n_noise_magnitudes=9, reverb_length=1000)
RTOL = ATOL = 1e-5
AUDIO_ATOL = 1e-3
SPECTRAL_RTOL = 1e-4
GRAD_RTOL = 1e-3
REVERB_GRAD_RTOL = 1e-2


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _torch(tree):
  return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _batch(seed=0, batch=2):
  """Harmonic tones at a low f0 with steps between notes, plus noise, their
  f0 frames, and a piano roll of the nearest MIDI note (velocity 100)."""
  rng = np.random.RandomState(seed)
  notes = rng.randint(45, 52, size=(batch, 3)).astype(np.float64)
  midi = np.repeat(notes, [17, 17, 16], axis=1)
  f0 = 440.0 * 2.0**((midi - 69.0 + 0.2 * rng.rand(batch, 1)) / 12.0)
  phase = 2 * np.pi * np.cumsum(np.repeat(f0, N_SAMPLES // N_FRAMES, 1),
                                1) / SR
  audio = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
  audio = audio + 0.02 * rng.randn(batch, N_SAMPLES)
  roll = np.zeros((batch, N_FRAMES, 128), np.float32)
  np.put_along_axis(roll, midi.astype(int)[..., None], 100.0, axis=-1)
  return {'audio': audio.astype(np.float32),
          'f0_hz': f0.astype(np.float32)[..., None],
          'note_active_velocities': roll}


def _record_uniform():
  """A patch of jax.random.uniform that appends each draw to a list."""
  draws, uniform = [], jax.random.uniform

  def recording(*args, **kwargs):
    out = uniform(*args, **kwargs)
    draws.append(out)
    return out

  return draws, mock.patch.object(jax.random, 'uniform', recording)


def _raise_noise_floor(params, key, n_noise):
  params = jax.tree_util.tree_map(np.array, params)
  bias = params[key]['dense_out']['bias']
  bias[-n_noise:] = 4.0
  return params


def _jax_run(model, params, feats, **kwargs):
  """(outputs, losses, gradients of the total loss, the four noise draws)
  of the JAX model in training, with a 'noise' stream."""
  draws, patch = _record_uniform()

  def loss_fn(p):
    draws.clear()
    out, losses = model.apply({'params': p}, feats, training=True,
                              return_losses=True,
                              rngs={'noise': jax.random.PRNGKey(3)},
                              **kwargs)
    return losses['total_loss'], (out, losses, list(draws))

  with patch:
    (_, (out, losses, noise)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
  assert len(noise) == 4, len(noise)
  return out, losses, grads, [np.array(n) for n in noise]


def _port_run(model, params, feats, noise):
  load_jax_params(model, params)
  out, losses = model(_torch(feats), training=True, return_losses=True,
                      noise={'filtered_noise': torch.from_numpy(noise[0]),
                             'reverb': torch.from_numpy(noise[1])},
                      midi_noise={'filtered_noise': torch.from_numpy(
                          noise[2]), 'reverb': torch.from_numpy(noise[3])})
  named = list(model.named_parameters())
  grads = torch.autograd.grad(losses['total_loss'], [p for _, p in named],
                              allow_unused=True)
  return out, losses, {n.replace('.', '/'): g for (n, _), g in zip(named,
                                                                   grads)}


def _is_audio(key):
  return 'signal' in key or key.endswith('_audio') or key.endswith(
      'controls/audio')


def _compare(out_j, losses_j, grads_j, out_t, losses_t, grads_t):
  flat_j = {k: np.asarray(v) for k, v in flatten(out_j).items()}
  flat_t = {k: _np(v) for k, v in flatten(out_t).items()}
  assert sorted(flat_j) == sorted(flat_t)
  for key, want in flat_j.items():
    got = flat_t[key]
    assert got.shape == want.shape, key
    if _is_audio(key):
      np.testing.assert_allclose(got, want, rtol=0, atol=AUDIO_ATOL,
                                 err_msg=key)
    else:
      np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                 err_msg=key)
  assert sorted(losses_j) == sorted(losses_t)
  for key, want in losses_j.items():
    rtol = RTOL if key not in ('synth_spectral_loss', 'total_loss') else (
        SPECTRAL_RTOL)
    np.testing.assert_allclose(_np(losses_t[key]), np.asarray(want),
                               rtol=rtol, atol=ATOL, err_msg=key)
  flat_gj = {k: np.asarray(v) for k, v in flatten(grads_j).items()}
  assert sorted(flat_gj) == sorted(grads_t)
  for key, want in flat_gj.items():
    got = grads_t[key]
    got = np.zeros_like(want) if got is None else _np(got)
    err = np.linalg.norm(got - want)
    rtol = REVERB_GRAD_RTOL if key.endswith('reverb/magnitudes') else (
        GRAD_RTOL)
    assert err <= rtol * max(np.linalg.norm(want), 1e-6), key


@pytest.mark.parametrize('use_midi_encoder', [True, False])
def test_midiae_matches_jax(use_midi_encoder):
  kw = dict(MIDI_KW, use_midi_encoder=use_midi_encoder)
  model_j = j_presets.midiae(**kw)
  feats = _batch(seed=int(use_midi_encoder))
  jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
  params = jax.jit(lambda f: model_j.init(
      {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}, f,
      training=True, return_losses=True))(jfeats)['params']
  params = _raise_noise_floor(params, 'synthcoder', 9)
  out_j, losses_j, grads_j, noise = _jax_run(model_j, params, jfeats)
  model_t = build_model('midiae', device='cpu', **kw)
  out_t, losses_t, grads_t = _port_run(model_t, params, feats, noise)
  assert sorted(losses_t) == ['amps_loss', 'f0_loss', 'hd_loss',
                              'noise_loss', 'qpitch_f0rec_loss',
                              'synth_spectral_loss', 'total_loss']
  assert ('z_pitch' in out_t) == use_midi_encoder
  if not use_midi_encoder:
    np.testing.assert_array_equal(
        _np(out_t['q_pitch'])[..., 0],
        np.argmax(feats['note_active_velocities'], -1))
  _compare(out_j, losses_j, grads_j, out_t, losses_t, grads_t)

  # A MIDI request: midi_to_audio of the quantized pitch, both packages
  # with their fixed-key noise (uniform of PRNGKey(0); the port's
  # generator-less draw is the same key's, handed over).
  q_pitch = np.asarray(out_j['q_pitch'])
  audio_j = model_j.apply({'params': params}, jnp.asarray(q_pitch),
                          jnp.zeros_like(q_pitch),
                          method=j_models.MidiAutoencoder.midi_to_audio)
  fixed = {'filtered_noise': np.asarray(jax.random.uniform(
      jax.random.PRNGKey(0), (2, N_SAMPLES), minval=-1.0, maxval=1.0)),
           'reverb': np.asarray(jax.random.uniform(
               jax.random.PRNGKey(0), (1, 1000), minval=-1.0, maxval=1.0))}
  with torch.no_grad():
    audio_t = model_t.midi_to_audio(torch.from_numpy(q_pitch),
                                    torch.zeros(q_pitch.shape),
                                    noise=_torch(fixed))
  np.testing.assert_allclose(_np(audio_t), np.asarray(audio_j), rtol=0,
                             atol=AUDIO_ATOL)


class _JaxPrior(fnn.Module):
  """A prior with a loss and a pass-through scale (both packages)."""

  @fnn.compact
  def __call__(self, z):
    return 0.5 * z

  def get_losses_dict(self, z):
    return {'prior_loss': jnp.mean(z**2)}


class _TorchPrior(tnn.Module):

  def forward(self, z):
    return 0.5 * z

  def get_losses_dict(self, z):
    return {'prior_loss': torch.mean(z**2)}


def _z_models():
  """The JAX test's ZMidiAutoencoder (tests/test_models_extended.py) with
  a note prior, in both packages; 1 + 1 + 8 + 9 controls into the
  latents' encoders. Every FcStack is float32 (the JAX FcStackOut has no
  dtype and runs bf16, so a float32 FcStack preconditions z here)."""
  splits = (('f0_midi', 1), ('amplitudes', 1), ('harmonic_distribution', 8),
            ('magnitudes', 9))
  synth_splits = splits[1:]
  scaled = ('f0_scaled', 'amps_scaled', 'hd_scaled', 'noise_scaled')
  recon_j = j_losses.LossGroup(dag=[
      (j_losses.SpectralLoss(fft_sizes=(256, 128), name='synth_spectral_loss'),
       ['audio', 'synth_audio']),
      (j_losses.ParamLoss(weight=50.0, loss_type='L2', name='f0_loss'),
       ['f0_midi', 'f0_midi_pred', 'f0_loss_weights'])])
  model_j = j_models.ZMidiAutoencoder(
      synthcoder=j_nn.RnnFcDecoder(
          rnn_channels=16, ch=16, layers_per_stack=1,
          input_keys=('ld_scaled', 'f0_scaled', 'z'),
          output_splits=synth_splits, compute_dtype='float32'),
      midi_encoder=j_nn.HarmonicToMidiEncoder(
          net=j_nn.FcStack(ch=16, layers=1, compute_dtype='float32')),
      midi_decoder=j_nn.MidiToHarmonicDecoder(
          net=j_nn.DilatedConvStack(ch=8, layers_per_stack=2, stacks=1,
                                    norm_type='layer', conditional=True),
          output_splits=splits),
      preprocessor=j_nn.F0LoudnessPreprocessor(time_steps=N_FRAMES),
      reconstruction_losses=recon_j,
      qpitch_f0rec_loss=j_models.MarginLoss(weight=50.0, margin=0.5,
                                            name='q_pitch_f0_rec'),
      pitch_qpitch_loss=j_losses.ParamLoss(name='pitch_qpitch'),
      midi_slowness_loss=j_models.SlownessLoss(weight=1.0, name='slowness'),
      z_synth_encoders=(j_nn.OneHotEncoder(vocab_size=4, z_dims=8),),
      z_global_encoders=(j_nn.ExpressionEncoder(
          net=j_nn.FcStack(ch=16, layers=1, compute_dtype='float32'),
          z_dims=8, input_keys=scaled, pool_time=True),),
      z_note_encoder=j_nn.ExpressionEncoder(
          net=j_nn.FcStack(ch=16, layers=1, compute_dtype='float32'),
          z_dims=8, input_keys=scaled, pool_time=False),
      z_preconditioning_stack=j_nn.FcStack(ch=8, layers=1,
                                           compute_dtype='float32'),
      z_note_prior=_JaxPrior(),
      n_samples=N_SAMPLES, reverb_length=1000, reverb=True)
  recon_t = t_losses.LossGroup(dag=[
      (t_losses.SpectralLoss(fft_sizes=(256, 128), name='synth_spectral_loss'),
       ['audio', 'synth_audio']),
      (t_losses.ParamLoss(weight=50.0, loss_type='L2', name='f0_loss'),
       ['f0_midi', 'f0_midi_pred', 'f0_loss_weights'])])
  model_t = t_models.ZMidiAutoencoder(
      synthcoder=t_nn.RnnFcDecoder(
          rnn_channels=16, ch=16, layers_per_stack=1,
          input_keys=('ld_scaled', 'f0_scaled', 'z'), input_dims=(1, 1, 8),
          output_splits=synth_splits, compute_dtype='float32'),
      midi_encoder=t_nn.HarmonicToMidiEncoder(
          net=t_nn.FcStack(19, 16, 1, compute_dtype='float32')),
      midi_decoder=t_nn.MidiToHarmonicDecoder(
          net=t_nn.DilatedConvStack(1, ch=8, layers_per_stack=2, stacks=1,
                                    norm_type='layer', conditional=True,
                                    z_ch=8),
          output_splits=splits),
      preprocessor=t_nn.F0LoudnessPreprocessor(time_steps=N_FRAMES),
      reconstruction_losses=recon_t,
      qpitch_f0rec_loss=t_models.MarginLoss(weight=50.0, margin=0.5,
                                            name='q_pitch_f0_rec'),
      pitch_qpitch_loss=t_losses.ParamLoss(name='pitch_qpitch'),
      midi_slowness_loss=t_models.SlownessLoss(weight=1.0, name='slowness'),
      z_synth_encoders=(t_nn.OneHotEncoder(vocab_size=4, z_dims=8),),
      z_global_encoders=(t_nn.ExpressionEncoder(
          net=t_nn.FcStack(19, 16, 1,
                           compute_dtype='float32'),
          z_dims=8, input_keys=scaled, pool_time=True),),
      z_note_encoder=t_nn.ExpressionEncoder(
          net=t_nn.FcStack(19, 16, 1,
                           compute_dtype='float32'),
          z_dims=8, input_keys=scaled, pool_time=False),
      z_preconditioning_stack=t_nn.FcStack(16, 8, 1,
                                           compute_dtype='float32'),
      z_note_prior=_TorchPrior(),
      n_samples=N_SAMPLES, reverb_length=1000, reverb=True)
  return model_j, model_t


def test_z_midi_autoencoder_matches_jax():
  model_j, model_t = _z_models()
  feats = dict(_batch(seed=2), instrument_id=np.array([1, 3], np.int32))
  feats = {k: v for k, v in feats.items() if k != 'note_active_velocities'}
  jfeats = {k: jnp.asarray(v) for k, v in feats.items()}
  params = jax.jit(lambda f: model_j.init(
      {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}, f,
      training=True, return_losses=True))(jfeats)['params']
  params = _raise_noise_floor(params, 'synthcoder', 9)
  out_j, losses_j, grads_j, noise = _jax_run(model_j, params, jfeats)
  out_t, losses_t, grads_t = _port_run(model_t, params, feats, noise)
  for key in ('qpitch_f0rec_loss', 'pitch_qpitch_loss', 'midi_slowness_loss',
              'prior_loss'):
    assert key in losses_t, sorted(losses_t)
  for key in ('z_global', 'z_notes', 'z_pitch'):
    assert key in out_t
  _compare(out_j, losses_j, grads_j, out_t, losses_t, grads_t)


def test_full_width_midiae_loads_the_jax_tree():
  """build_model('midiae') at the preset's widths loads the JAX tree
  (jax.eval_shape: nothing computed) strictly: 249 leaves, 2 972 799
  parameters; a missing leaf raises."""
  model_j = j_presets.midiae(n_samples=N_SAMPLES, time_steps=N_FRAMES)
  feats = {'audio': jnp.zeros((1, N_SAMPLES)),
           'f0_hz': jnp.zeros((1, N_FRAMES, 1))}
  shapes = jax.eval_shape(lambda: model_j.init(
      {'params': jax.random.PRNGKey(0)}, feats, training=True)['params'])
  zeros = {k: np.zeros(v.shape, np.float32)
           for k, v in flatten(shapes).items()}
  assert len(zeros) == 249
  assert sum(v.size for v in zeros.values()) == 2972799
  assert zeros['synthcoder/dilated_conv_stack/Conv_0/kernel'].shape == (
      3, 1, 2, 128)
  model_t = build_model('midiae', device='cpu', n_samples=N_SAMPLES,
                        time_steps=N_FRAMES)
  load_jax_params(model_t, zeros)
  assert all(not p.detach().any() for p in model_t.parameters())
  del zeros['default_pg/reverb/magnitudes']
  with pytest.raises(ValueError, match='missing.*reverb/magnitudes'):
    load_jax_params(model_t, zeros)


def test_serving_refuses_a_midiae_directory(tmp_path):
  """AutoencoderInference and export_model (both formats) raise a
  ValueError naming the model's forward and midi_to_audio; the JAX package
  fails on such a directory with a KeyError for 'audio' (the preset's
  preprocessor computes loudness from it, and drops the mutation that
  would not)."""
  save_dir = str(tmp_path / 'train')
  save_spec(save_dir, 'midiae', **MIDI_KW)
  trainer = Trainer(build_model('midiae', device='cpu', seed=0, **MIDI_KW),
                    device='cpu')
  trainer.save(trainer.init(), save_dir)
  match = r"MidiAutoencoder.*forward.*midi_to_audio"
  with pytest.raises(ValueError, match=match):
    AutoencoderInference(save_dir, device='cpu')
  for fmt in ('params', 'torch_export'):
    with pytest.raises(ValueError, match=match):
      export_model(save_dir, str(tmp_path / fmt), fmt=fmt, device='cpu')


def _write_urmp_midi(path, n_examples=4):
  """URMP-style MIDI records (UrmpMidi 'train', tpt): the batch's tones,
  N_FRAMES frames of N_SAMPLES samples each."""
  examples = []
  for i in range(n_examples):
    b = _batch(seed=10 + i, batch=1)
    examples.append({
        'audio': b['audio'][0], 'f0_hz': b['f0_hz'][0, :, 0],
        'f0_confidence': np.ones(N_FRAMES, np.float32),
        'loudness_db': np.full(N_FRAMES, -30.0, np.float32),
        'note_active_velocities': b['note_active_velocities'][0].ravel(),
        'note_active_frame_indices': (
            b['note_active_velocities'][0] > 0).astype(np.float32).ravel(),
        'instrument_id': [b'tpt']})
  tfrecord.write_examples(
      str(path / 'urmp_tpt_solo_ddsp_conditioning_train.tfrecord-00000-of-'
          '00001'), examples)


@pytest.mark.parametrize('use_midi_encoder', [True, False])
def test_cli_trains_evaluates_and_samples_midiae(tmp_path, use_midi_encoder):
  """ddsp-torch-run --preset midiae: 2 steps, eval and sample. The
  ground-truth path reads 'note_active_velocities' from URMP-style records
  and reports the MIDI metrics (both MIDI evaluators)."""
  kw = dict(MIDI_KW, use_midi_encoder=use_midi_encoder)
  if use_midi_encoder:
    data = 'synthetic:4'
  else:
    (tmp_path / 'urmp').mkdir()
    _write_urmp_midi(tmp_path / 'urmp')
    data = f'urmp:{tmp_path / "urmp"}:tpt'
  save_dir = str(tmp_path / 'run')
  common = ['--save_dir', save_dir, '--data', data, '--batch_size', '2',
            '--device', 'cpu']
  state = run.main(['--mode', 'train', '--preset', 'midiae',
                    '--model_kwargs', json.dumps(kw), '--num_steps', '2',
                    '--steps_per_summary', '1', '--steps_per_save', '2'] +
                   common)
  assert state.step == 2
  assert any(k.startswith('synthcoder.') for k in state.params)
  scalars = run.main(['--mode', 'eval', '--num_eval_batches', '1',
                      '--run_once'] + common)
  assert np.isfinite(scalars['losses/total_loss'])
  midi_keys = [k for k in scalars if k.startswith('metrics/midi/')]
  if use_midi_encoder:
    assert not midi_keys
  else:
    assert {k.split('/')[2] for k in midi_keys} == {'learned', 'heuristic'}
    assert all(np.isfinite(scalars[k]) for k in midi_keys)
  run.main(['--mode', 'sample', '--num_eval_batches', '1', '--run_once'] +
           common)
  samples = tmp_path / 'run' / 'samples' / 'step_2'
  assert (samples / '0_synth.wav').exists()
  if not use_midi_encoder:
    assert (samples / '0_midi_audio.wav').exists()
