"""The rest of ops/core.py against ddsp_tpu's, on the CPU: the unary
functions, the frequency scalings, the gradient reversal and the leaf
helpers; tests/test_torch_processors.py's cases of ops/core.py, with its
check and tolerances (its docstring)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import core as j_core
from ddsp_torch.ops import core as t_core
from test_torch_processors import (  # pylint: disable=g-bad-import-order
    UNARY, _check, _x)

torch.set_num_threads(1)


@pytest.mark.parametrize('name', sorted(UNARY))
def test_core_unary_functions_match_jax(name):
  make, (offset, scale) = UNARY[name][0], UNARY[name][1] or (0.0, 1.0)
  x = _x((3, 7, 4), 1, scale, offset)
  if name == 'nan_to_num':
    x[0, 0, 0] = x[2, 3, 1] = np.nan
  relative = name in ('db_to_power', 'db_to_amplitude', 'log_scale',
                      'unit_to_hz', 'bark_to_hz', 'mel_to_hz',
                      'get_deviation_hz', 'hz_to_mel')
  _check(make(j_core), make(t_core), [x], rtol=2e-6 if relative else 1e-5,
         relative=relative, grads=name != 'nan_to_num')


@pytest.mark.parametrize('name,depth', [('frequencies_softmax', 8),
                                        ('frequencies_sigmoid', 3),
                                        ('frequencies_critical_bands', 2),
                                        ('frequencies_critical_bands_mel',
                                         1)])
def test_frequency_scalings_match_jax(name, depth):
  kwargs = {'scale': 'mel'} if name.endswith('_mel') else {}
  fn = name.replace('_mel', '')
  x = _x((2, 5, 6 * depth), 2)
  _check(lambda a: getattr(j_core, fn)(a, depth=depth, **kwargs),
         lambda a: getattr(t_core, fn)(a, depth=depth, **kwargs), [x],
         rtol=1e-5, relative=True)
  x4 = x.reshape(2, 5, 6, depth)  # [batch, time, sinusoids, depth] as is
  _check(lambda a: getattr(j_core, fn)(a, **kwargs),
         lambda a: getattr(t_core, fn)(a, **kwargs), [x4], rtol=1e-5,
         relative=True, grads=False)


def test_gradient_reversal_negates_the_gradient():
  x = _x((3, 4), 3)
  w = _x((3, 4), 4)
  g_j = jax.grad(lambda a: jnp.sum(j_core.gradient_reversal(a) * w))(
      jnp.asarray(x))
  xt = torch.from_numpy(x).requires_grad_()
  yt = t_core.gradient_reversal(xt)
  np.testing.assert_array_equal(yt.detach().numpy(), x)
  (yt * torch.from_numpy(w)).sum().backward()
  np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_j))
  np.testing.assert_array_equal(xt.grad.numpy(), -w)


def test_leaf_key_and_map_shape():
  tree = {'a': {'b': np.zeros((2, 3))}, 'c': [np.zeros(4), np.zeros((1,))]}
  t_tree = {'a': {'b': torch.zeros(2, 3)},
            'c': [torch.zeros(4), torch.zeros(1)]}
  assert t_core.leaf_key('a/b/c') == j_core.leaf_key('a/b/c') == 'c'
  assert t_core.map_shape(t_tree) == j_core.map_shape(tree)
