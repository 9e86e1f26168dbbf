"""The rest of ops/core.py, the wavetable and sinc ops, and the processors
without a TPU kernel (TensorToAudio, Wavetable, Sinusoidal, ExpDecayReverb,
FIRFilter, ModDelay, Mix) against ddsp_tpu, on the CPU.

Each takes the same seeded numpy inputs on both sides; values, and the
gradient of a weighted sum of the output with respect to every input (and
to ExpDecayReverb's parameters). ExpDecayReverb's noise is handed over:
the JAX processor applied without rngs draws uniform(PRNGKey(0)).

Tolerances: 1e-5 for values of order one (the same float32 arithmetic),
relative to the largest element where a sum runs over thousands of terms
(FFT convolutions, oscillator banks): 1e-4; gradients relative L2 1e-4.
Audio from a running phase (Wavetable, Sinusoidal) 2e-3 relative to its
largest sample and gradients 5e-3 (the frequencies' gradient collects the
phase's difference over time; measured 2.6e-3): JAX sums the phase in
float32, the port in float64 (ops/oscillator.py phase_cumsum), 0.3 s at
most here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import core as j_core
from ddsp_tpu.ops import fftconv as j_fftconv
from ddsp_tpu.ops.resample import center_crop as j_center_crop
from ddsp_tpu.ops import wavetable as j_wavetable
from ddsp_tpu.proc import effects as j_effects
from ddsp_tpu.proc import processors as j_processors
from ddsp_tpu.proc import synths as j_synths
from ddsp_torch.ops import core as t_core
from ddsp_torch.ops import fftconv as t_fftconv
from ddsp_torch.ops.resample import center_crop as t_center_crop
from ddsp_torch.ops import wavetable as t_wavetable
from ddsp_torch.proc import effects as t_effects
from ddsp_torch.proc import processors as t_processors
from ddsp_torch.proc import synths as t_synths

torch.set_num_threads(1)


def _x(shape, seed=0, scale=1.0, offset=0.0):
  rng = np.random.RandomState(seed)
  return (offset + scale * rng.randn(*shape)).astype(np.float32)


def _check(fn_j, fn_t, args, rtol=1e-5, grad_rtol=1e-4, relative=False,
           grads=True):
  """fn_j(*jnp args) against fn_t(*torch args): values within rtol
  (absolute, or relative to the largest element with `relative`) and the
  gradients of sum(out * w) with respect to every float argument."""
  out_j = np.asarray(fn_j(*map(jnp.asarray, args)))
  t_args = [torch.from_numpy(np.asarray(a)).requires_grad_(
      np.asarray(a).dtype == np.float32) for a in args]
  out_t = fn_t(*t_args)
  assert tuple(out_t.shape) == out_j.shape
  atol = rtol * (max(np.abs(out_j).max(), 1e-30) if relative else 1.0)
  np.testing.assert_allclose(out_t.detach().numpy(), out_j, atol=atol)
  if not grads:
    return
  w = _x(out_j.shape, 99)
  float_idx = [i for i, a in enumerate(args)
               if np.asarray(a).dtype == np.float32]
  grads_j = jax.grad(lambda *a: jnp.sum(fn_j(*a) * w), argnums=float_idx)(
      *map(jnp.asarray, args))
  grads_t = torch.autograd.grad((out_t * torch.from_numpy(w)).sum(),
                                [t_args[i] for i in float_idx])
  for g_j, g_t in zip(grads_j, grads_t):
    g_j = np.asarray(g_j)
    rel = np.linalg.norm(g_t.numpy() - g_j) / max(np.linalg.norm(g_j), 1e-30)
    assert rel <= grad_rtol, rel


# --- ops/core.py ---------------------------------------------------------

UNARY = {
    'nan_to_num': (lambda m: lambda x: m.nan_to_num(x, 2.5), None),
    'log_scale': (lambda m: lambda x: m.log_scale(x, 20.0, 8000.0),
                  (0.0, 0.5)),
    'soft_limit': (lambda m: lambda x: m.soft_limit(x, -1.0, 2.0),
                   (0.5, 2.0)),
    'db_to_amplitude': (lambda m: m.db_to_amplitude, (-30.0, 10.0)),
    'db_to_power': (lambda m: m.db_to_power, (-30.0, 10.0)),
    'unit_to_midi': (lambda m: lambda x: m.unit_to_midi(x, 10.0, 100.0),
                     (0.5, 0.3)),
    'unit_to_midi_clip': (lambda m: lambda x: m.unit_to_midi(
        x, clip=True), (0.5, 0.8)),
    'midi_to_unit': (lambda m: lambda x: m.midi_to_unit(x, clip=True),
                     (60.0, 20.0)),
    'unit_to_hz': (lambda m: lambda x: m.unit_to_hz(x, 20.0, 8000.0),
                   (0.5, 0.3)),
    'hz_to_unit': (lambda m: lambda x: m.hz_to_unit(x, 20.0, 8000.0),
                   (800.0, 300.0)),
    'hz_to_bark': (lambda m: m.hz_to_bark, (2000.0, 500.0)),
    'bark_to_hz': (lambda m: m.bark_to_hz, (10.0, 3.0)),
    'hz_to_mel': (lambda m: m.hz_to_mel, (2000.0, 500.0)),
    'mel_to_hz': (lambda m: m.mel_to_hz, (1000.0, 300.0)),
    'hz_to_erb': (lambda m: m.hz_to_erb, (2000.0, 500.0)),
    'sym_exp_sigmoid': (lambda m: m.sym_exp_sigmoid, (0.0, 3.0)),
    'get_deviation_hz': (lambda m: lambda x: m.get_deviation_hz(0.5, x),
                         (800.0, 200.0)),
}


# --- wavetable, sinc and crop ops ----------------------------------------

def test_linear_lookup_matches_jax():
  phase = np.random.RandomState(5).rand(2, 300, 1).astype(np.float32)
  tables = _x((2, 300, 16), 6)
  for wrap in (True, False):
    _check(lambda p, w: j_wavetable.linear_lookup(p, w, wrap=wrap),
           lambda p, w: t_wavetable.linear_lookup(p, w, wrap=wrap),
           [phase, tables])
  _check(j_wavetable.linear_lookup, t_wavetable.linear_lookup,
         [phase[..., 0], tables[:, 0]])


def test_harmonic_distribution_to_wavetable_matches_jax():
  hd = np.abs(_x((2, 5, 12), 7))
  hd /= hd.sum(-1, keepdims=True)
  _check(lambda h: j_wavetable.harmonic_distribution_to_wavetable(h, 64),
         lambda h: t_wavetable.harmonic_distribution_to_wavetable(h, 64),
         [hd], rtol=1e-5, relative=True)


def test_wavetable_synthesis_matches_jax():
  n = 4000
  f0 = _x((2, 25, 1), 8, 20.0, 220.0)
  amps = np.abs(_x((2, 25, 1), 9, 0.2, 0.5))
  tables = _x((2, 25, 32), 10, 0.5)
  _check(lambda f, a, w: j_wavetable.wavetable_synthesis(f, a, w, n),
         lambda f, a, w: t_wavetable.wavetable_synthesis(f, a, w, n),
         [f0, amps, tables], rtol=2e-3, grad_rtol=5e-3, relative=True)


def test_variable_length_delay_matches_jax():
  audio = _x((2, 1000), 11)
  phase = np.random.RandomState(12).rand(2, 1000, 1).astype(np.float32)
  _check(lambda p, a: j_wavetable.variable_length_delay(p, a, 40),
         lambda p, a: t_wavetable.variable_length_delay(p, a, 40),
         [phase, audio])


@pytest.mark.parametrize('high_pass', [False, True])
def test_sinc_filter_matches_jax(high_pass):
  audio = _x((2, 2000), 13)
  cutoff = np.abs(_x((2, 10, 1), 14, 1000.0, 3000.0))
  _check(lambda c: j_fftconv.sinc_impulse_response(
      c, 64, sample_rate=16000, high_pass=high_pass),
         lambda c: t_fftconv.sinc_impulse_response(
             c, 64, sample_rate=16000, high_pass=high_pass), [cutoff])
  _check(lambda a, c: j_fftconv.sinc_filter(a, c, 64, 16000,
                                            high_pass=high_pass),
         lambda a, c: t_fftconv.sinc_filter(a, c, 64, 16000,
                                            high_pass=high_pass),
         [audio, cutoff], rtol=1e-4, relative=True)
  x = _x((3, 5), 15)
  _check(j_fftconv.sinc, t_fftconv.sinc, [x])


@pytest.mark.parametrize('frame_size', [0, 1, 7, 64])
def test_center_crop_matches_jax(frame_size):
  audio = _x((2, 200, 3), 16)
  np.testing.assert_array_equal(
      t_center_crop(torch.from_numpy(audio), frame_size).numpy(),
      np.asarray(j_center_crop(jnp.asarray(audio), frame_size)))


# --- processors ----------------------------------------------------------

def _processor(j_proc, t_proc, args, rtol=1e-5, grad_rtol=1e-4,
               relative=False, t_kwargs=None, variables=None):
  """A processor's signal (and controls through it) against JAX."""
  variables = variables or {}

  def fn_j(*a):
    return j_proc.apply(variables, *a)

  def fn_t(*a):
    return t_proc(*a, **(t_kwargs or {}))

  _check(fn_j, fn_t, args, rtol=rtol, grad_rtol=grad_rtol,
         relative=relative)


def test_tensor_to_audio_matches_jax():
  _processor(j_synths.TensorToAudio(), t_synths.TensorToAudio(),
             [_x((2, 300, 1), 17)])


def test_wavetable_processor_matches_jax():
  n = 4800
  _processor(j_synths.Wavetable(n_samples=n), t_synths.Wavetable(n_samples=n),
             [_x((2, 30, 1), 18), _x((2, 30, 24), 19),
              np.abs(_x((2, 30, 1), 20, 20.0, 200.0))],
             rtol=2e-3, grad_rtol=5e-3, relative=True)


def test_sinusoidal_processor_matches_jax():
  n = 4800
  depth = 16
  _processor(j_synths.Sinusoidal(n_samples=n, freq_scale_fn=functools.partial(
      j_core.frequencies_softmax, depth=depth, hz_max=4000.0)),
             t_synths.Sinusoidal(n_samples=n, freq_scale_fn=functools.partial(
                 t_core.frequencies_softmax, depth=depth, hz_max=4000.0)),
             [_x((2, 30, 4), 21), _x((2, 30, 4 * depth), 22)],
             rtol=2e-3, grad_rtol=5e-3, relative=True)


@pytest.mark.parametrize('trainable', [False, True])
def test_exp_decay_reverb_matches_jax(trainable):
  n, length = 2000, 400
  j_rev = j_effects.ExpDecayReverb(trainable=trainable, reverb_length=length)
  t_rev = t_effects.ExpDecayReverb(trainable=trainable, reverb_length=length)
  noise = np.array(jax.random.uniform(jax.random.PRNGKey(0), (1, length),
                                      minval=-1.0, maxval=1.0))
  audio = _x((2, n), 23)
  noise_t = torch.from_numpy(noise)
  if not trainable:
    _processor(j_rev, t_rev, [audio, _x((2, 1), 24), _x((2, 1), 25, 0.5, 1.0)],
               rtol=1e-4, relative=True, t_kwargs={'noise': noise_t})
    return
  variables = jax.jit(j_rev.init)(jax.random.PRNGKey(0), jnp.asarray(audio))
  assert jax.tree_util.tree_map(np.shape, variables['params']) == {
      'gain': (1,), 'decay': (1,)}
  np.testing.assert_array_equal(t_rev.gain.detach().numpy(), [2.0])
  np.testing.assert_array_equal(t_rev.decay.detach().numpy(), [4.0])
  _processor(j_rev, t_rev, [audio], rtol=1e-4, relative=True,
             t_kwargs={'noise': noise_t}, variables=variables)
  # The parameters' gradients.
  w = _x((2, n), 26)

  def loss_j(params):
    return jnp.sum(j_rev.apply({'params': params}, jnp.asarray(audio)) * w)

  grads_j = jax.grad(loss_j)(variables['params'])
  out = t_rev(torch.from_numpy(audio), noise=noise_t)
  g_gain, g_decay = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                        [t_rev.gain, t_rev.decay])
  np.testing.assert_allclose(g_gain.numpy(), np.asarray(grads_j['gain']),
                             rtol=1e-4)
  np.testing.assert_allclose(g_decay.numpy(), np.asarray(grads_j['decay']),
                             rtol=1e-4)
  # Without noise the draw is seeded: the same on every call.
  torch.testing.assert_close(t_rev(torch.from_numpy(audio)),
                             t_rev(torch.from_numpy(audio)), rtol=0, atol=0)


def test_fir_filter_matches_jax():
  _processor(j_effects.FIRFilter(window_size=33),
             t_effects.FIRFilter(window_size=33),
             [_x((2, 2000), 27), _x((2, 20, 17), 28)], rtol=1e-4,
             relative=True)


def test_mod_delay_matches_jax():
  _processor(j_effects.ModDelay(center_ms=2.0, depth_ms=1.0),
             t_effects.ModDelay(center_ms=2.0, depth_ms=1.0),
             [_x((2, 1000), 29), _x((2, 1000, 1), 30), _x((2, 1000, 1), 31)],
             relative=True)


def test_mix_matches_jax():
  _processor(j_processors.Mix(), t_processors.Mix(),
             [_x((2, 1000), 32), _x((2, 1000), 33), _x((2, 10, 1), 34)])
  with pytest.raises(ValueError, match='equal-length'):
    t_processors.Mix()(torch.zeros(1, 10), torch.zeros(1, 11),
                       torch.zeros(1, 2, 1))
