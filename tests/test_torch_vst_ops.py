"""The VST path's ops and layers that need no VST checkpoint, against
ddsp_tpu's, on the CPU: the power and f0 preprocessing, the oscillator
bank, Crop, the FastGRU state at one step and the short float32 streams;
tests/test_torch_vst.py's cases without its module fixture, with its
tolerances (its docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import layers as j_layers
from ddsp_tpu.nn import preprocessing as j_pre
from ddsp_tpu.ops import oscillator as j_osc
from ddsp_tpu.ops import spectral as j_spectral
from ddsp_tpu.proc import processors as j_processors
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.nn import preprocessing as t_pre
from ddsp_torch.ops import oscillator as t_osc
from ddsp_torch.ops import spectral as t_spectral
from ddsp_torch.proc import Crop
from ddsp_torch.utils import load_jax_params
from test_torch_vst import (  # pylint: disable=g-bad-import-order
    BANK_ATOL, DTYPES, FRAME_RATE, GRU_ATOL, HOP, N_HARMONICS,
    POWER_ATOL_DB, SR, _H, _np, _perturbed)

torch.set_num_threads(1)


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
