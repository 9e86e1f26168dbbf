"""The VST streaming path of ddsp_torch against ddsp_tpu, on the CPU.

One JAX vst checkpoint (Trainer.init + save, no training step, biases
perturbed so none is zero) at the narrow sizes of tests/test_inference.py
serves the JAX VST classes, and the same parameters, written as a
params-format artifact, serve the port's. Each class is held against its
JAX counterpart hop by hop, in float32 and bf16 decoders (the JAX vst preset
always builds a bf16 decoder; its float32 twin is registered here while the
JAX classes are built). The port's VSTSynthesize is handed the JAX class's
noise buffer, and the whole-clip forward the JAX processors' noise draws.

Tolerances sit beside their constants below, each with why.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu import infer as j_infer
from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.nn import layers as j_layers
from ddsp_tpu.nn import preprocessing as j_pre
from ddsp_tpu.ops import oscillator as j_osc
from ddsp_tpu.ops import spectral as j_spectral
from ddsp_tpu.proc import processors as j_processors
from ddsp_tpu.train import Trainer
from ddsp_tpu.utils import registry as j_registry
from ddsp_torch import infer as t_infer
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.nn import preprocessing as t_pre
from ddsp_torch.ops import oscillator as t_osc
from ddsp_torch.ops import spectral as t_spectral
from ddsp_torch.ops.core import flatten
from ddsp_torch.proc import Crop
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

SR = 16000
FRAME_RATE = 50
HOP = SR // FRAME_RATE  # 320
SECONDS = 0.2  # 3200 samples, 3520 synthesized
N_HARMONICS = 8
N_NOISE = 5
STATE = 16
VST_KW = dict(seconds=SECONDS, frame_rate=FRAME_RATE, n_harmonics=N_HARMONICS,
              n_noise_magnitudes=N_NOISE, rnn_channels=STATE, ch=16,
              reverb=False)
N_HOPS = 8
DTYPES = ('float32', 'bfloat16')
# The float32 twin of the JAX vst preset, registered while the JAX classes
# are built from its spec.
JAX_F32_PRESET = 'vst_float32_decoder'

# Controls and state, float32 decoders: the same float32 operations in
# another summation order (the stateless GRU is float32 on both sides).
CONTROLS_ATOL_F32 = 1e-5
# bf16 decoders: the FC stacks round their products to bf16 on both sides,
# and a sum that lands on a rounding boundary rounds the other way in one
# of them (an ulp of bf16 is 2^-8 relative): the JAX package's own bf16
# tier for controls (tests/test_torch_model.py).
CONTROLS_ATOL_BF16 = 5e-2
# FastGRU at T = 1 with an initial state against the JAX scan: both float32
# recurrences (also in bf16 mode, below MIN_BF16_STEPS), summed in another
# order.
GRU_ATOL = 1e-5
# One hop of streamed audio and its phase: float32 sin of the same phases;
# the within-hop phase sums (torch accumulates float32 in float64, JAX in
# float32) differ by ~1e-6 rad after 320 samples, times the harmonic number.
SYNTH_ATOL = 1e-4
# Streamed hops against one synthesis of the whole span: the carried phase
# is the hop's wrapped phase plus the carry, rounded once per hop, and the
# amplitude envelopes are interpolated per hop instead of over the span;
# the JAX package's own test holds two hops to 1e-3.
CONTINUITY_ATOL = 1e-3
# Whole clip, float32: controls as above; audio as tests/test_torch_model.py
# holds the serving slice (the phase cumsum's float32 against float64 sums,
# ~1e-4 rad over 3520 samples times the harmonic number).
CLIP_AUDIO_ATOL_F32 = 4e-3
# Whole clip, bf16: the port's GRU runs bf16 streams over T = 12 frames (the
# JAX package's Pallas numerics), the JAX reference its float32 scan off the
# TPU: relative L2 of the audio, the serving slice's tier.
CLIP_AUDIO_REL_L2_BF16 = 5e-2
# Power in dB of one frame: the same mean of squares in another order.
POWER_ATOL_DB = 1e-4
# Oscillator bank over 4 hops with an initial phase near 1e2 rad: float32
# sines of h * phase (h <= 8) on phases that agree to a float32 rounding.
BANK_ATOL = 1e-4


def _jax_vst_float32(**kwargs):
  model = j_presets.vst(**kwargs)
  return model.clone(decoder=model.decoder.clone(compute_dtype='float32'))


def _perturbed(params, seed=0):
  """Every bias-like leaf moved off zero, so each term of the sums is seen."""
  rng = np.random.RandomState(seed)
  flat = flatten(jax.tree_util.tree_map(np.array, params))
  for key, value in flat.items():
    if key.rsplit('/', 1)[-1] in ('bias', 'bi', 'bn'):
      flat[key] = (value + 0.1 * rng.randn(*value.shape)).astype(np.float32)
  tree = {}
  for key, value in flat.items():
    node = tree
    *parents, leaf = key.split('/')
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = value
  return tree


def _write_artifact(path, params, **kwargs):
  """The port's params-format artifact: operative_spec.json + params.npz."""
  path.mkdir(parents=True, exist_ok=True)
  (path / 'operative_spec.json').write_text(json.dumps(
      {'preset': 'vst', 'kwargs': dict(VST_KW, **kwargs)}))
  np.savez(path / 'params.npz', **flatten(params))
  return str(path)


def _jax_batch():
  n_samples = int(SECONDS * SR)
  n_frames = n_samples // HOP + 1
  rng = np.random.RandomState(0)
  t = np.arange(n_samples) / SR
  audio = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.01 * rng.randn(n_samples)
  return {'audio': np.tile(audio.astype(np.float32), (2, 1)),
          'f0_hz': np.full((2, n_frames), 220.0, np.float32),
          'f0_confidence': np.ones((2, n_frames), np.float32)}


@pytest.fixture(scope='module')
def vst(tmp_path_factory):
  """JAX and port VST classes on one checkpoint's parameters, per dtype."""
  root = tmp_path_factory.mktemp('vst')
  jax_dir = root / 'jax'
  trainer = Trainer(j_presets.vst(**VST_KW))
  # Jitted: the same parameters as an eager init, in a tenth of the time.
  state = jax.jit(trainer.init)(_jax_batch())
  params = _perturbed(state.params)
  state = state.replace(params=params)
  j_registry.save_spec(str(jax_dir), 'vst', **VST_KW)
  trainer.save(state, str(jax_dir))
  jax_f32_dir = root / 'jax_f32'
  shutil.copytree(jax_dir, jax_f32_dir)
  j_registry.save_spec(str(jax_f32_dir), JAX_F32_PRESET, **VST_KW)

  out = {'params': params, 'jax_dir': str(jax_dir)}
  j_registry.register_preset(JAX_F32_PRESET)(_jax_vst_float32)
  try:
    for dtype, jdir in (('bfloat16', jax_dir), ('float32', jax_f32_dir)):
      port_dir = _write_artifact(root / f'port_{dtype}', params,
                                 compute_dtype=dtype)
      out[dtype] = {
          'port_dir': port_dir,
          'jax': j_infer.VSTStatelessPredictControls(str(jdir)),
          'port': t_infer.VSTStatelessPredictControls(port_dir,
                                                      device='cpu'),
          'stateful': t_infer.VSTPredictControls(port_dir, device='cpu')}
  finally:
    j_registry._PRESETS.pop(JAX_F32_PRESET)
  return out


def _np(x):
  return x.detach().float().numpy() if isinstance(x, torch.Tensor) else (
      np.asarray(x))


def _hop_inputs(i):
  return (np.array([0.45 + 0.02 * i], np.float32),
          np.array([0.5 + 0.05 * np.sin(i)], np.float32))


@pytest.mark.parametrize('padding', ['valid', 'center'])
def test_compute_power_matches_jax(padding):
  rng = np.random.RandomState(1)
  audio = (0.1 * rng.randn(2, 3200)).astype(np.float32)
  for frame in (audio, audio[:, :1024]):
    want = jax.jit(j_spectral.compute_power, static_argnums=range(1, 7))(
        jnp.asarray(frame), SR, FRAME_RATE, 1024, 0.0, 80.0, padding)
    got = t_spectral.compute_power(torch.from_numpy(frame), sample_rate=SR,
                                   frame_rate=FRAME_RATE, frame_size=1024,
                                   padding=padding)
    n_frames, _ = t_spectral.get_framed_lengths(frame.shape[1], 1024, HOP,
                                                padding)
    assert tuple(got.shape) == (2, n_frames) == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               atol=POWER_ATOL_DB, rtol=0)


@pytest.mark.parametrize('kind', ['noise', 'sine', 'silence'])
def test_extract_features_matches_jax(vst, kind):
  rng = np.random.RandomState(2)
  audio = {'noise': 0.1 * rng.randn(1024),
           'sine': 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(1024) / SR),
           'silence': np.zeros(1024)}[kind].astype(np.float32)
  want = j_infer.VSTExtractFeatures(vst['jax_dir'], compute_f0=False)(audio)
  got = t_infer.VSTExtractFeatures(vst['float32']['port_dir'],
                                   compute_f0=False, device='cpu')(
                                       torch.from_numpy(audio))
  for g, w in zip(got, want):
    assert tuple(g.shape) == (1,) == w.shape
    np.testing.assert_allclose(_np(g), np.asarray(w), atol=POWER_ATOL_DB,
                               rtol=0)


def test_compute_f0_raises(vst):
  with pytest.raises(NotImplementedError, match='queue 1 item 5'):
    t_infer.VSTExtractFeatures(vst['float32']['port_dir'], device='cpu')
  with pytest.raises(NotImplementedError, match='CREPE'):
    t_pre.OnlineF0PowerPreprocessor(compute_f0=True)


def test_online_preprocessor_checks_the_frame_count():
  pre = t_pre.OnlineF0PowerPreprocessor(frame_rate=FRAME_RATE,
                                        frame_size=1024, compute_f0=False)
  features = {'audio': torch.zeros(1, 3200), 'f0_hz': torch.zeros(1, 11),
              'f0_confidence': torch.ones(1, 11)}
  assert pre(features)['pw_db'].shape == (1, 11, 1)
  features['f0_hz'] = torch.zeros(1, 10)
  with pytest.raises(ValueError, match='does not have 11 timesteps'):
    pre(features)


@pytest.mark.parametrize('given', ['power_db', 'audio'])
def test_f0_power_preprocessor_matches_jax(given):
  rng = np.random.RandomState(3)
  features = {'f0_hz': (200 + 100 * rng.rand(2, 50)).astype(np.float32)}
  if given == 'audio':
    features['audio'] = (0.1 * rng.randn(2, 3200)).astype(np.float32)
  else:
    features['power_db'] = (-60 + 40 * rng.rand(2, 50)).astype(np.float32)
  j_module = j_pre.F0PowerPreprocessor(time_steps=100, frame_rate=250,
                                       frame_size=64)
  want = jax.jit(j_module.apply)({}, {k: jnp.asarray(v)
                                     for k, v in features.items()})
  got = t_pre.F0PowerPreprocessor(time_steps=100, frame_rate=250,
                                  frame_size=64)(
                                      {k: torch.from_numpy(v)
                                       for k, v in features.items()})
  assert sorted(got) == sorted(want)
  for key in want:
    np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]),
                               atol=POWER_ATOL_DB, rtol=1e-6, err_msg=key)
  np.testing.assert_allclose(_np(t_pre.inv_scale_f0_hz(got['f0_scaled'])),
                             _np(got['f0_hz']), rtol=1e-5)
  np.testing.assert_allclose(_np(t_pre.inv_scale_db(got['pw_scaled'])),
                             _np(got['pw_db']), atol=1e-4)


@pytest.mark.parametrize('dtype', DTYPES)
def test_stateless_controls_and_state_match_jax(vst, dtype):
  atol = CONTROLS_ATOL_F32 if dtype == 'float32' else CONTROLS_ATOL_BF16
  j_predict, t_predict = vst[dtype]['jax'], vst[dtype]['port']
  j_state, t_state = j_predict.initial_state(), t_predict.initial_state()
  states = []
  for i in range(N_HOPS):
    f0, pw = _hop_inputs(i)
    want = j_predict(f0, pw, j_state)
    got = t_predict(torch.from_numpy(f0), torch.from_numpy(pw), t_state)
    for name, g, w in zip(('amps', 'hd', 'noise', 'state'), got, want):
      assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
      np.testing.assert_allclose(_np(g), np.asarray(w), atol=atol, rtol=0,
                                 err_msg=f'hop {i} {name}')
    j_state, t_state = want[3], got[3]
    states.append(_np(t_state))
  assert t_state.shape == (STATE,)
  assert not np.allclose(states[0], states[-1])


@pytest.mark.parametrize('dtype', DTYPES)
def test_stateful_controls_repeat_the_stateless_ones(vst, dtype):
  stateless, stateful = vst[dtype]['port'], vst[dtype]['stateful']
  stateful.reset()
  state = stateless.initial_state()
  runs = {'stateless': [], 'stateful': [], 'carried': [], 'reset': []}
  for i in range(N_HOPS):
    amps, hd, noise, state = stateless(*_hop_inputs(i), state)
    runs['stateless'].append((amps, hd, noise))
    runs['stateful'].append(stateful(*_hop_inputs(i)))
  for i in range(N_HOPS):
    runs['carried'].append(stateful(*_hop_inputs(i)))
  stateful.reset()
  for i in range(N_HOPS):
    runs['reset'].append(stateful(*_hop_inputs(i)))
  for name in ('stateful', 'reset'):
    for a, b in zip(runs[name], runs['stateless']):
      assert all(torch.equal(x, y) for x, y in zip(a, b)), name
  assert not torch.equal(runs['carried'][0][1], runs['stateless'][0][1])


def _controls(i, rng):
  f0 = np.array([220.0 + 30.0 * i], np.float32)
  amps = np.array([0.3 + 0.05 * i], np.float32)
  hd = rng.rand(N_HARMONICS).astype(np.float32)
  hd /= hd.sum()
  noise = (0.01 * rng.rand(N_NOISE)).astype(np.float32)
  return amps, hd, f0, noise


@pytest.mark.parametrize('variant', ['VSTSynthesize', 'VSTSynthesizeHarmonic',
                                     'VSTSynthesizeNoise'])
def test_synthesize_matches_jax(vst, variant):
  j_synth = getattr(j_infer, variant)(vst['jax_dir'])
  t_synth = getattr(t_infer, variant)(vst['float32']['port_dir'],
                                      device='cpu')
  assert tuple(t_synth.noise_signal.shape) == (1, HOP)
  # The JAX class's buffer: threefry cannot be drawn in torch.
  t_synth.noise_signal = torch.from_numpy(np.asarray(jax.random.uniform(
      jax.random.PRNGKey(0), (1, HOP), minval=-1.0, maxval=1.0)))
  rng = np.random.RandomState(4)
  prev = _controls(0, rng)
  j_phase, t_phase = j_synth.initial_phase(), t_synth.initial_phase()
  for i in range(4):
    cur = _controls(i, rng)
    if variant == 'VSTSynthesizeNoise':
      want, got = j_synth(cur[3]), t_synth(torch.from_numpy(cur[3]))
    else:
      args = [cur[0], prev[0], cur[1], prev[1], cur[2], prev[2]]
      if variant == 'VSTSynthesize':
        args.append(cur[3])
      want, j_phase = j_synth(*args, j_phase)
      got, t_phase = t_synth(*(torch.from_numpy(a) for a in args), t_phase)
      assert tuple(t_phase.shape) == (1,)
      np.testing.assert_allclose(_np(t_phase), np.asarray(j_phase),
                                 atol=SYNTH_ATOL, rtol=0)
    assert tuple(got.shape) == (HOP,) and np.abs(_np(got)).max() > 0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=SYNTH_ATOL,
                               rtol=0, err_msg=f'hop {i}')
    prev = cur


def test_phase_carry_continuity(vst):
  """N_HOPS streamed hops of constant controls == one synthesis of the
  whole span, the port's and the JAX package's."""
  synth = t_infer.VSTSynthesizeHarmonic(vst['float32']['port_dir'],
                                        device='cpu')
  amps = torch.tensor([0.5])
  hd = torch.full((N_HARMONICS,), 1.0 / N_HARMONICS)
  f0 = torch.tensor([440.0])
  phase = synth.initial_phase()
  hops = []
  for _ in range(N_HOPS):
    audio, phase = synth(amps, amps, hd, hd, f0, f0, phase)
    hops.append(audio)
  streamed = torch.cat(hops).numpy()
  span = N_HOPS * HOP
  long_t, final_t = t_osc.streaming_harmonic_synthesis(
      torch.full((1, 2, 1), 440.0), torch.full((1, 2, 1), 0.5),
      torch.full((1, 2, N_HARMONICS), 1.0 / N_HARMONICS),
      torch.zeros((1, 1, 1)), n_samples=span, sample_rate=SR)
  long_j, _ = jax.jit(j_osc.streaming_harmonic_synthesis,
                      static_argnums=(4, 5))(
      jnp.full((1, 2, 1), 440.0), jnp.full((1, 2, 1), 0.5),
      jnp.full((1, 2, N_HARMONICS), 1.0 / N_HARMONICS),
      jnp.zeros((1, 1, 1)), span, SR)
  np.testing.assert_allclose(streamed, long_t[0].numpy(),
                             atol=CONTINUITY_ATOL, rtol=0)
  np.testing.assert_allclose(streamed, np.asarray(long_j)[0],
                             atol=CONTINUITY_ATOL, rtol=0)
  # No jump at a hop edge: the step across it is a step within a hop.
  steps = np.abs(np.diff(streamed))
  assert steps[HOP - 1::HOP].max() <= 1.5 * steps.max(initial=0.0)
  # The carry is the same phase, modulo 2 pi.
  assert abs(np.sin(float(phase) - float(final_t))) < 1e-3


@pytest.mark.parametrize('angular', [True, False])
def test_harmonic_oscillator_bank_matches_jax(angular):
  rng = np.random.RandomState(5)
  f0 = (300 + 200 * rng.rand(2, 4 * HOP, 1)).astype(np.float32)
  amps = (0.1 * rng.rand(2, 4 * HOP, N_HARMONICS)).astype(np.float32)
  phase0 = np.array([[[1.0]], [[123.4]]], np.float32)
  want = jax.jit(j_osc.harmonic_oscillator_bank, static_argnums=(3, 4))(
      jnp.asarray(f0), jnp.asarray(amps), jnp.asarray(phase0), SR, angular)
  got = t_osc.harmonic_oscillator_bank(
      torch.from_numpy(f0), torch.from_numpy(amps), torch.from_numpy(phase0),
      SR, angular)
  for g, w in zip(got, want):
    assert tuple(g.shape) == w.shape
    np.testing.assert_allclose(_np(g), np.asarray(w), atol=BANK_ATOL, rtol=0)


@pytest.mark.parametrize('location', ['front', 'center', 'back'])
def test_crop_matches_jax(location):
  audio = np.arange(2 * 3520, dtype=np.float32).reshape(2, 3520)
  want = j_processors.Crop(frame_size=HOP, crop_location=location).apply(
      {}, jnp.asarray(audio))
  got = Crop(frame_size=HOP, crop_location=location)(torch.from_numpy(audio))
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


REVERB_LENGTH = 2000


def _clip_model_and_params(params, reverb, dtype):
  """The JAX vst model of the clip tests and its parameters: the
  checkpoint's, plus reverb magnitudes drawn as its initializer does."""
  kwargs = dict(VST_KW, reverb=reverb, reverb_length=REVERB_LENGTH)
  model = (j_presets.vst if dtype == 'bfloat16' else _jax_vst_float32)(
      **kwargs)
  if reverb:
    rng = np.random.RandomState(1)
    params = dict(params, processor_group={'reverb': {'magnitudes': (
        1e-2 * rng.randn(500, 32)).astype(np.float32)}})
  return model, params, kwargs


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('reverb', [False, True])
def test_whole_clip_matches_jax(vst, reverb, dtype):
  """The vst model over a clip (from audio and f0), Crop included, with the
  JAX processors' noise handed to the port's by name."""
  model_j, params, kwargs = _clip_model_and_params(vst['params'], reverb,
                                                   dtype)
  n_in = int(SECONDS * SR) + HOP
  n_frames = n_in // HOP + 1
  rng = np.random.RandomState(6)
  t = np.arange(n_in) / SR
  features = {
      'audio': (0.3 * np.sin(2 * np.pi * 330.0 * t) * np.linspace(0.2, 1, n_in)
                + 0.01 * rng.randn(n_in)).astype(np.float32)[None],
      'f0_hz': np.linspace(300, 360, n_frames, dtype=np.float32)[None],
      'f0_confidence': np.ones((1, n_frames), np.float32)}
  out_j = jax.jit(model_j.apply, static_argnames='training')(
      {'params': params}, {k: jnp.asarray(v) for k, v in features.items()},
      training=False)
  model_t = build_model('vst', device='cpu', compute_dtype=dtype, **kwargs)
  load_jax_params(model_t, params)
  n_synth = n_in
  noise = {'filtered_noise': np.asarray(jax.random.uniform(
      jax.random.PRNGKey(0), (1, n_synth), minval=-1.0, maxval=1.0))}
  if reverb:
    noise['reverb'] = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (1, REVERB_LENGTH), minval=-1.0, maxval=1.0))
  with torch.no_grad():
    out_t = model_t({k: torch.from_numpy(v) for k, v in features.items()},
                    training=False,
                    noise={k: torch.from_numpy(v) for k, v in noise.items()})
  audio_j, audio_t = np.asarray(out_j['audio_synth']), _np(out_t['audio_synth'])
  assert audio_t.shape == audio_j.shape == (1, n_in - HOP)
  if reverb:
    assert np.abs(np.asarray(out_j['reverb']['signal'][:, :n_in - HOP]) -
                  np.asarray(out_j['add']['signal'][:, :n_in - HOP])).max() > 1e-4
  atol = CONTROLS_ATOL_F32 if dtype == 'float32' else CONTROLS_ATOL_BF16
  for key in ('amps', 'harmonic_distribution', 'noise_magnitudes', 'pw_db',
              'f0_scaled', 'pw_scaled'):
    np.testing.assert_allclose(_np(out_t[key]), np.asarray(out_j[key]),
                               atol=max(atol, POWER_ATOL_DB), rtol=0,
                               err_msg=key)
  if dtype == 'float32':
    np.testing.assert_allclose(audio_t, audio_j, atol=CLIP_AUDIO_ATOL_F32,
                               rtol=0)
  else:
    rel = np.linalg.norm(audio_t - audio_j) / np.linalg.norm(audio_j)
    assert rel <= CLIP_AUDIO_REL_L2_BF16, rel


@pytest.mark.parametrize('dtype', DTYPES)
def test_fast_gru_initial_state_at_one_step_matches_jax_scan(dtype):
  rng = np.random.RandomState(7)
  x = rng.randn(3, 1, 12).astype(np.float32)
  h0 = (0.5 * rng.randn(3, 24)).astype(np.float32)
  j_gru = j_layers.FastGRU(dims=24, compute_dtype=dtype, use_pallas=False)
  variables = jax.jit(j_gru.init)(jax.random.PRNGKey(3), jnp.asarray(x))
  params = _perturbed(variables['params'], seed=2)
  want_y, want_h = jax.jit(
      lambda p, x, h: j_gru.apply({'params': p}, x, initial_state=h,
                                  return_state=True))(
          params, jnp.asarray(x), jnp.asarray(h0))
  t_gru = t_layers.FastGRU(12, 24, compute_dtype=dtype)
  load_jax_params(t_gru, params)
  got_y, got_h = t_gru(torch.from_numpy(x), initial_state=torch.from_numpy(h0),
                       return_state=True)
  for g, w in ((got_y, want_y), (got_h, want_h)):
    assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    np.testing.assert_allclose(_np(g), np.asarray(w), atol=GRU_ATOL, rtol=0)


_H = t_layers.FastGRU.BF16_HIDDEN_MULTIPLE


@pytest.mark.parametrize('hidden,seq_len,stream', [
    pytest.param(_H, 1, torch.float32, id='1-stream0'),
    pytest.param(_H, 7, torch.float32, id='7-stream1'),
    pytest.param(_H, 8, torch.bfloat16, id='8-stream2'),
    pytest.param(64, 24, torch.float32, id='h64-24'),
    pytest.param(96, 24, torch.float32, id='h96-24'),
    pytest.param(_H, 24, torch.bfloat16, id='h128-24'),
    pytest.param(512, 8, torch.bfloat16, id='h512-8')])
def test_short_sequences_stream_float32(monkeypatch, hidden, seq_len,
                                        stream):
  """In bf16 mode xp reaches the recurrence as float32 below
  MIN_BF16_STEPS (where the JAX package runs its float32 scan) and off the
  multiples of BF16_HIDDEN_MULTIPLE units (where `gru_kernel_supported`
  fails), and as bf16 otherwise (its Pallas kernel)."""
  seen = []
  real = t_layers.gru_sequence

  def spy(xp, wh, bn, h0):
    seen.append((xp.dtype, wh.dtype))
    return real(xp, wh, bn, h0)

  monkeypatch.setattr(t_layers, 'gru_sequence', spy)
  gru = t_layers.FastGRU(4, hidden, compute_dtype='bfloat16')
  ys = gru(torch.randn(2, seq_len, 4))
  assert t_layers.FastGRU.MIN_BF16_STEPS == 8
  assert seen == [(stream, torch.float32)] and ys.dtype == torch.float32


def test_load_jax_params_is_strict_on_the_vst_tree(vst):
  _, params, kwargs = _clip_model_and_params(vst['params'], True, 'bfloat16')
  flat = flatten(params)
  assert flat['processor_group/reverb/magnitudes'].shape == (500, 32)
  model = build_model('vst', device='cpu', **kwargs)
  load_jax_params(model, flat)
  torch.testing.assert_close(
      model.processor_group.reverb.magnitudes,
      torch.from_numpy(flat['processor_group/reverb/magnitudes']))
  missing = dict(flat)
  missing.pop('processor_group/reverb/magnitudes')
  with pytest.raises(ValueError, match='missing'):
    load_jax_params(model, missing)
  with pytest.raises(ValueError, match='extra'):
    load_jax_params(build_model('vst', device='cpu',
                                **dict(kwargs, reverb=False)), flat)
  bad = dict(flat, **{'decoder/rnn/FastGRU_0/bn': np.zeros(3, np.float32)})
  with pytest.raises(ValueError, match='shape'):
    load_jax_params(model, bad)


def test_vst_entry_points_refuse_the_cpu_by_default(vst, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  port_dir = vst['float32']['port_dir']
  for cls in (t_infer.VSTStatelessPredictControls, t_infer.VSTPredictControls,
              t_infer.VSTSynthesize, t_infer.VSTSynthesizeHarmonic,
              t_infer.VSTSynthesizeNoise):
    with pytest.raises(RuntimeError, match='CUDA'):
      cls(port_dir)
  with pytest.raises(RuntimeError, match='CUDA'):
    t_infer.VSTExtractFeatures(port_dir, compute_f0=False)
