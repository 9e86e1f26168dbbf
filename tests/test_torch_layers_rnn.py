"""ddsp_torch.nn's layers against ddsp_tpu.nn's, on the CPU.

The RNN cells flax runs as a lax.scan (OptimizedLSTMCell, GRUCell, both
directions of a bidirectional layer), with and without return_sequences;
StatelessRnn's state carried across a split sequence; the wrappers RnnFc,
RnnSandwich, SingleGru and FcStackOut; Normalize and normalize_op; Identity
and Embedding; the ResNet (plain and FiLM-conditioned). Each JAX module is
initialised once (jitted), its parameters carried by load_jax_params.

Tolerances (tests/test_torch_model.py's tiers): float32 values 1e-5 and
gradients relative L2 1e-4 (the same float32 arithmetic summed in another
order); bf16 (flax cells with dtype bfloat16: bf16 products and gates)
values 5e-2 absolute; the ResNet, whose layer norms over 1024 channels sum
in another order, 1e-4 relative to the output's largest element (its
gradients at the float32 tier).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import layers as j_layers
from ddsp_tpu.nn import resnet as j_resnet
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.nn import resnet as t_resnet
from ddsp_torch.infer.export import unflatten
from ddsp_torch.ops.core import flatten
from ddsp_torch.utils import load_jax_params

torch.set_num_threads(1)

B, T, CH, H = 2, 12, 5, 8


def _x(shape, seed=0):
  return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _init(module, *args, seed=0):
  variables = jax.jit(module.init)(jax.random.PRNGKey(seed),
                                   *map(jnp.asarray, args))
  params = jax.tree_util.tree_map(np.array, variables['params'])
  # Non-zero biases, so a bias in the wrong place shows.
  rng = np.random.RandomState(seed + 1)
  flat = flatten(params)
  for k, v in flat.items():
    if k.endswith('bias') or k.endswith('shift'):
      flat[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
  return flat


def _apply(module, params, *args):
  return jax.jit(module.apply)({'params': unflatten(params)},
                               *map(jnp.asarray, args))


def _port(module, params):
  load_jax_params(module, params)
  return module


def _grads(module, out):
  """d sum(out * w) with respect to the module's parameters (flat keys)."""
  w = torch.from_numpy(_x(tuple(out.shape), seed=99))
  names = [n for n, _ in module.named_parameters()]
  grads = torch.autograd.grad((out * w).sum(),
                              [p for _, p in module.named_parameters()])
  return {n.replace('.', '/'): g.numpy() for n, g in zip(names, grads)}


def _jax_grads(module, params, x):
  out = jax.eval_shape(module.apply, {'params': unflatten(params)},
                       jnp.asarray(x))
  w = jnp.asarray(_x(tuple(out.shape), seed=99))

  def f(p):
    return jnp.sum(module.apply({'params': p}, jnp.asarray(x)) * w)

  grads = jax.jit(jax.grad(f))(
      jax.tree_util.tree_map(jnp.asarray, unflatten(params)))
  return {k: np.asarray(v) for k, v in flatten(grads).items()}


def _assert_grads(grads_t, grads_j, rtol=1e-4):
  assert sorted(grads_t) == sorted(grads_j)
  for k, g in grads_j.items():
    if not np.abs(g).max():
      # e.g. the reverse LSTM's forget gate when only its first step (from
      # a zero cell state) is read.
      np.testing.assert_array_equal(grads_t[k], g, err_msg=k)
      continue
    rel = np.linalg.norm(grads_t[k] - g) / np.linalg.norm(g)
    assert rel <= rtol, (k, rel)


RNN_CASES = [
    # (rnn_type, bidir, use_fast_gru, return_sequences)
    ('lstm', False, True, True),
    ('lstm', False, True, False),
    ('gru', False, False, True),
    ('gru', False, False, False),
    ('gru', True, True, True),
    ('lstm', True, True, False),
]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rnn_type,bidir,use_fast_gru,return_sequences',
                         RNN_CASES)
def test_rnn_cells_match_flax(rnn_type, bidir, use_fast_gru,
                              return_sequences, dtype):
  x = _x((B, T, CH))
  j_rnn = j_layers.Rnn(H, rnn_type, return_sequences=return_sequences,
                       bidir=bidir, use_fast_gru=use_fast_gru,
                       compute_dtype=dtype)
  params = _init(j_rnn, x)
  t_rnn = _port(t_layers.Rnn(CH, H, rnn_type, compute_dtype=dtype,
                             return_sequences=return_sequences, bidir=bidir,
                             use_fast_gru=use_fast_gru), params)
  y_j = np.asarray(_apply(j_rnn, params, x))
  y_t = t_rnn(torch.from_numpy(x))
  assert y_t.dtype == torch.float32 and tuple(y_t.shape) == y_j.shape
  assert y_j.shape[-1] == t_rnn.out_features
  np.testing.assert_allclose(y_t.detach().numpy(), y_j,
                             atol=1e-5 if dtype == 'float32' else 5e-2)
  if dtype == 'float32':
    _assert_grads(_grads(t_rnn, y_t), _jax_grads(j_rnn, params, x))


def test_rnn_refuses_an_unknown_cell():
  with pytest.raises(ValueError, match='rnn_type'):
    t_layers.Rnn(CH, H, 'rnn', use_fast_gru=False)


@pytest.mark.parametrize('rnn_type,state_dims', [('lstm', 2 * H),
                                                 ('gru', H)])
def test_stateless_rnn_state_round_trip(rnn_type, state_dims):
  """The state out of the first half, fed back, continues the sequence
  exactly where the whole-sequence run goes; both runs match flax."""
  x = _x((B, T, CH))
  state0 = 0.3 * _x((B, state_dims), seed=3)
  j_rnn = j_layers.StatelessRnn(H, rnn_type, compute_dtype='float32')
  params = _init(j_rnn, x, state0)
  t_rnn = _port(t_layers.StatelessRnn(CH, H, rnn_type,
                                      compute_dtype='float32'), params)
  y_j, s_j = _apply(j_rnn, params, x, state0)
  with torch.no_grad():
    y_t, s_t = t_rnn(torch.from_numpy(x), torch.from_numpy(state0))
    y_a, s_a = t_rnn(torch.from_numpy(x[:, :5]), torch.from_numpy(state0))
    y_b, s_b = t_rnn(torch.from_numpy(x[:, 5:]), s_a)
  assert tuple(s_t.shape) == (B, state_dims)
  np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=1e-5)
  np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
  np.testing.assert_allclose(torch.cat([y_a, y_b], 1).numpy(), y_t.numpy(),
                             atol=1e-6)
  np.testing.assert_allclose(s_b.numpy(), s_t.numpy(), atol=1e-6)


def test_stateless_flax_gru_cell_is_refused_as_jax_fails():
  x = _x((B, T, CH))
  with pytest.raises(AttributeError):
    _init(j_layers.StatelessRnn(H, 'gru', use_fast_gru=False), x,
          np.zeros((B, H), np.float32))
  with pytest.raises(ValueError, match='fails on its own state'):
    t_layers.StatelessRnn(CH, H, 'gru', use_fast_gru=False)


@pytest.mark.parametrize('name', ['RnnFc', 'RnnFc_bidir', 'RnnSandwich',
                                  'SingleGru', 'FcStackOut'])
def test_rnn_wrappers_match_jax(name):
  """Fixed to bf16 compute in the JAX package (FcStack, Fc, Rnn defaults)."""
  x = _x((B, T, CH))
  j_mod, t_mod = {
      'RnnFc': (j_layers.RnnFc(H, 6, n_rnn=2),
                t_layers.RnnFc(CH, H, 6, n_rnn=2)),
      'RnnFc_bidir': (j_layers.RnnFc(H, 6, 'gru', bidir=True),
                      t_layers.RnnFc(CH, H, 6, 'gru', bidir=True)),
      'RnnSandwich': (j_layers.RnnSandwich(6, 1, H),
                      t_layers.RnnSandwich(CH, 6, 1, H)),
      'SingleGru': (j_layers.SingleGru(H), t_layers.SingleGru(CH, H)),
      'FcStackOut': (j_layers.FcStackOut(6, 2, 3),
                     t_layers.FcStackOut(CH, 6, 2, 3)),
  }[name]
  params = _init(j_mod, x)
  _port(t_mod, params)
  y_j = np.asarray(_apply(j_mod, params, x), np.float32)
  with torch.no_grad():
    y_t = t_mod(torch.from_numpy(x)).float().numpy()
  assert y_t.shape == y_j.shape and y_j.shape[-1] == t_mod.out_features
  np.testing.assert_allclose(y_t, y_j, atol=5e-2)


@pytest.mark.parametrize('conditional,norm_type', [(False, 'layer'),
                                                   (True, 'instance')])
def test_resnet_matches_jax(conditional, norm_type):
  """ResNet 'small' on [1, 6, 37, 1] (SAME padding of odd widths at every
  stride), NHWC, flax's kernel layout carried as it is."""
  x = _x((1, 6, 37, 1), seed=2)
  z = _x((1, 3), seed=4)
  j_net = j_resnet.ResNet(size='small', norm_type=norm_type,
                          conditional=conditional)
  args = (x, z) if conditional else (x,)
  params = _init(j_net, *args)
  t_net = _port(t_resnet.ResNet('small', norm_type, conditional,
                                z_ch=3 if conditional else 0), params)
  y_j = np.asarray(_apply(j_net, params, *args))
  y = t_net(*map(torch.from_numpy, args))
  y_t = y.detach().numpy()
  assert y_t.shape == y_j.shape == (1, 6, 2, t_net.out_features)
  np.testing.assert_allclose(y_t, y_j, atol=1e-4 * np.abs(y_j).max())
  if not conditional:
    _assert_grads(_grads(t_net, y), _jax_grads(j_net, params, x))

