"""The arguments and classes that the surface test (test_torch_surface.py)
found missing, held against the JAX package on the CPU.

Inputs come from one numpy seed and go through both packages. frame and
get_fft_size are exact; apply_window_to_impulse_response(causal=True),
oscillator_bank(sum_sinusoids=False) and both invert_scaling agree at
float32 atol 1e-6; OutputSplitsModule, get_norm and an encoder built with
non-default keys take the JAX parameters through load_jax_params and agree
at 1e-5 (values) and 1e-4 (gradients, relative L2), the tiers of
tests/test_torch_layers_rnn.py.
"""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import encoders as j_encoders
from ddsp_tpu.nn import layers as j_layers
from ddsp_tpu.nn import preprocessing as j_pre
from ddsp_tpu.nn import resnet as j_resnet
from ddsp_tpu.ops import fftconv as j_fftconv
from ddsp_tpu.ops import oscillator as j_osc
from ddsp_torch import ops as t_ops
from ddsp_torch.infer import inference as t_inference
from ddsp_torch.infer.export import unflatten
from ddsp_torch.nn import encoders as t_encoders
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.nn import preprocessing as t_pre
from ddsp_torch.nn import resnet as t_resnet
from ddsp_torch.proc import ProcessorGroup
from ddsp_torch.proc.processors import Add
from ddsp_torch.train import MetricsWriter
from test_torch_layers_rnn import (  # pylint: disable=g-bad-import-order
    _apply, _assert_grads, _grads, _init, _port, _x)

torch.set_num_threads(1)


def _t(x):
  return torch.from_numpy(np.asarray(x))


# --- ops ---------------------------------------------------------------------


def test_frame_defaults_to_no_padding():
  """The JAX default pad_end=False: 10 samples in frames of 4 every 2 are
  4 frames (the port padded the end by default, giving 5)."""
  x = np.arange(10, dtype=np.float32)[None]
  y_t = t_ops.frame(_t(x), 4, 2)
  y_j = np.asarray(j_fftconv.frame(jnp.asarray(x), 4, 2))
  assert tuple(y_t.shape) == y_j.shape == (1, 4, 4)
  np.testing.assert_array_equal(y_t.numpy(), y_j)


@pytest.mark.parametrize('axis', [0, 1, -1])
def test_frame_matches_jax(axis):
  """Every pad_end, pad_value and frame/hop pair (a signal shorter than a
  frame among them) along each axis of a [7, 9, 11] signal."""
  x = _x((7, 9, 11), seed=3)
  for pad_end in (False, True):
    for pad_value in (0.0, -1.5):
      for length, step in ((4, 2), (3, 1), (5, 3), (12, 4), (2, 5)):
        y_t = t_ops.frame(_t(x), length, step, pad_end=pad_end,
                          pad_value=pad_value, axis=axis)
        y_j = np.asarray(j_fftconv.frame(jnp.asarray(x), length, step,
                                         pad_end, pad_value, axis))
        where = (pad_end, pad_value, length, step)
        assert tuple(y_t.shape) == y_j.shape, where
        np.testing.assert_array_equal(y_t.numpy(), y_j, err_msg=str(where))


def test_get_fft_size_matches_jax():
  for frame_size in (1, 7, 64, 100, 333, 1000, 4001):
    for ir_size in (1, 17, 256, 1001):
      for power_of_2 in (True, False):
        assert t_ops.get_fft_size(frame_size, ir_size, power_of_2) == (
            j_fftconv.get_fft_size(frame_size, ir_size, power_of_2)), (
                frame_size, ir_size, power_of_2)


def test_apply_window_causal_matches_jax():
  ir = _x((2, 3, 64), seed=4)
  for causal in (False, True):
    for window_size in (0, 33, 64, 100):
      y_t = t_ops.apply_window_to_impulse_response(_t(ir), window_size,
                                                   causal)
      y_j = np.asarray(j_fftconv.apply_window_to_impulse_response(
          jnp.asarray(ir), window_size, causal))
      np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-6, rtol=0,
                                 err_msg=str((causal, window_size)))


def test_oscillator_bank_unsummed_matches_jax():
  """[batch, n, n_sinusoids], and its sum is the summed bank. Low
  frequencies over 32 samples keep both packages' float32 phase sums
  within the tolerance (their cumsums round in different orders)."""
  rng = np.random.RandomState(5)
  freqs = (20.0 + 200.0 * rng.rand(2, 32, 6)).astype(np.float32)
  freqs[..., -1] = 9000.0  # above Nyquist: muted in both
  amps = rng.rand(2, 32, 6).astype(np.float32)
  y_t = t_ops.oscillator_bank(_t(freqs), _t(amps), 16000,
                              sum_sinusoids=False)
  y_j = np.asarray(j_osc.oscillator_bank(jnp.asarray(freqs),
                                         jnp.asarray(amps), 16000,
                                         sum_sinusoids=False))
  assert y_t.shape == (2, 32, 6)
  np.testing.assert_allclose(y_t.numpy(), y_j, atol=1e-6, rtol=0)
  np.testing.assert_allclose(
      t_ops.oscillator_bank(_t(freqs), _t(amps), 16000).numpy(),
      y_t.sum(-1).numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize('name', ['F0LoudnessPreprocessor',
                                  'F0PowerPreprocessor'])
def test_invert_scaling_matches_jax(name):
  rng = np.random.RandomState(6)
  f0_scaled = rng.rand(2, 10, 1).astype(np.float32)
  db_scaled = rng.rand(2, 10, 1).astype(np.float32)
  got = getattr(t_pre, name).invert_scaling(_t(f0_scaled), _t(db_scaled))
  want = getattr(j_pre, name).invert_scaling(jnp.asarray(f0_scaled),
                                             jnp.asarray(db_scaled))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


# --- nn ----------------------------------------------------------------------

SPLITS = (('amps', 1), ('harmonic_distribution', 5), ('noise', 3))


class JaxHead(j_layers.OutputSplitsModule):
  """A user's head on the JAX base class: one Dense of both inputs."""

  def setup(self):
    self.dense = fnn.Dense(self.n_out)

  def compute_output(self, a, b):
    return self.dense(jnp.concatenate([a, b], axis=-1))


class PortHead(t_layers.OutputSplitsModule):
  """The same head on the port's base class."""

  def __init__(self, in_features, **kwargs):
    super().__init__(**kwargs)
    self.dense = t_layers.Dense(in_features, self.n_out)

  def compute_output(self, a, b):
    return self.dense(torch.cat([a, b], dim=-1))


def _dict_grads(module, outputs):
  """Gradients of sum(concat(outputs) * w), w from a fixed seed."""
  out = torch.cat(list(outputs.values()), dim=-1)
  return _grads(module, out)


def _jax_dict_grads(module, params, *args):
  def f(p):
    out = module.apply({'params': p}, *args)
    out = jnp.concatenate(list(out.values()), axis=-1)
    return jnp.sum(out * jnp.asarray(_x(tuple(out.shape), seed=99)))
  grads = jax.grad(f)(jax.tree_util.tree_map(jnp.asarray,
                                             unflatten(params)))
  return {k: np.asarray(v) for k, v in t_ops.flatten(grads).items()}


def _init_dict(module, features):
  """_init for a module called on a features dict."""
  variables = jax.jit(module.init)(jax.random.PRNGKey(0), _jnp(features))
  flat = t_ops.flatten(jax.tree_util.tree_map(np.array,
                                              variables['params']))
  rng = np.random.RandomState(1)
  return {k: (0.1 * rng.randn(*v.shape)).astype(np.float32)
          if k.endswith('bias') else v for k, v in flat.items()}


def _jnp(features):
  return {k: jnp.asarray(v) for k, v in features.items()}


def test_output_splits_module_matches_jax():
  a, b = _x((2, 7, 3), seed=7), _x((2, 7, 2), seed=8)
  features = {'a': a, 'b': b}
  keys = dict(input_keys=('a', 'b'), output_splits=SPLITS)
  j_head = JaxHead(**keys)
  params = _init_dict(j_head, features)
  t_head = _port(PortHead(5, **keys), params)
  assert t_head.n_out == j_head.n_out == 9
  out_t = t_head({k: _t(v) for k, v in features.items()})
  out_j = j_head.apply({'params': unflatten(params)}, _jnp(features))
  assert list(out_t) == list(out_j) == [k for k, _ in SPLITS]
  for k in out_j:
    np.testing.assert_allclose(out_t[k].detach().numpy(),
                               np.asarray(out_j[k]), atol=1e-5)
  _assert_grads(_dict_grads(t_head, out_t),
                _jax_dict_grads(j_head, params, _jnp(features)))


@pytest.mark.parametrize('conditional', [False, True])
def test_get_norm_matches_jax(conditional):
  """Normalize ('layer') or ConditionalNorm ('instance', FiLM of z)."""
  x = 2.0 * _x((2, 6, 3, 4), seed=9) + 0.5
  z = _x((2, 6, 1, 5), seed=10)
  norm_type = 'instance' if conditional else 'layer'
  j_norm = j_resnet.get_norm(norm_type, conditional, False)
  args = (x, z) if conditional else (x,)
  params = _init(j_norm, *args)
  t_norm = _port(t_resnet.get_norm(norm_type, conditional, False, ch=4,
                                   z_ch=5 if conditional else None), params)
  assert type(t_norm).__name__ == type(j_norm).__name__
  y_t = t_norm(*map(_t, args))
  np.testing.assert_allclose(y_t.detach().numpy(),
                             np.asarray(_apply(j_norm, params, *args)),
                             atol=1e-5)

  def loss(p):
    out = j_norm.apply({'params': p}, *map(jnp.asarray, args))
    return jnp.sum(out * jnp.asarray(_x(tuple(out.shape), seed=99)))
  grads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray,
                                                unflatten(params)))
  _assert_grads(_grads(t_norm, y_t),
                {k: np.asarray(v) for k, v in t_ops.flatten(grads).items()})


def test_encoder_with_its_own_keys_matches_jax():
  """AggregateFeaturesEncoder reading ('pitch', 'level') and writing
  'latent', built the same way in both packages."""
  keys = dict(input_keys=('pitch', 'level'), output_keys=('latent',))
  features = {'pitch': _x((2, 9, 1), seed=11), 'level': _x((2, 9, 1),
                                                           seed=12)}
  j_enc = j_encoders.AggregateFeaturesEncoder(ch=6, **keys)
  params = _init_dict(j_enc, features)
  t_enc = _port(t_encoders.AggregateFeaturesEncoder(ch=6, **keys), params)
  out_t = t_enc({k: _t(v) for k, v in features.items()})
  out_j = j_enc.apply({'params': unflatten(params)}, _jnp(features))
  assert list(out_t) == list(out_j) == ['latent']
  np.testing.assert_allclose(out_t['latent'].detach().numpy(),
                             np.asarray(out_j['latent']), atol=1e-5)
  _assert_grads(_dict_grads(t_enc, out_t),
                _jax_dict_grads(j_enc, params, _jnp(features)))


# --- infer, proc, train ------------------------------------------------------


def test_load_params_checks_its_target(tmp_path):
  """A target's keys and shapes hold the artifact: a wrong shape or a
  missing key raises; a match returns the target's keys."""
  module = t_layers.Dense(3, 2)
  arrays = {'kernel': np.ones((3, 2), np.float32),
            'bias': np.zeros(2, np.float32), 'other/x': np.ones(1)}
  np.savez(os.path.join(tmp_path, t_inference.PARAMS_FILENAME), **arrays)
  got = t_inference.load_params(str(tmp_path),
                                target_params=module.state_dict())
  assert sorted(got) == ['bias', 'kernel']
  assert sorted(t_inference.load_params(str(tmp_path))) == sorted(arrays)
  with pytest.raises(ValueError, match=r'shapes differ \[.kernel'):
    t_inference.load_params(str(tmp_path),
                            target_params=t_layers.Dense(4, 2).state_dict())
  with pytest.raises(ValueError, match=r"missing \['scale'\]"):
    t_inference.load_params(str(tmp_path),
                            target_params={'kernel': np.ones((3, 2)),
                                           'scale': np.ones(1)})


def test_dag_properties_and_metrics_writer(tmp_path):
  group = ProcessorGroup([(Add(name='add'), ['a', 'b']),
                          (Add(name='twice'), ['add/signal', 'b'])])
  assert group.module_names == ['add', 'twice']
  assert [type(m) for m in group.dag_modules] == [Add, Add]
  writer = MetricsWriter(str(tmp_path), use_tensorboard=False)
  writer.scalars(1, {'loss': 0.5})
  writer.close()
  assert os.listdir(tmp_path) == ['metrics.jsonl']
