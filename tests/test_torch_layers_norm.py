"""Normalize, Identity, Embedding and the SAME-padded Conv of ddsp_torch.nn
against ddsp_tpu.nn's, on the CPU: the cases of tests/test_torch_layers_rnn.py
that need no RNN, with its helpers and tolerances (its docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import layers as j_layers
from ddsp_torch.nn import layers as t_layers
from ddsp_torch.nn import resnet as t_resnet
from test_torch_layers_rnn import (  # pylint: disable=g-bad-import-order
    B, CH, T, _apply, _assert_grads, _grads, _init, _jax_grads, _port, _x)

torch.set_num_threads(1)


@pytest.mark.parametrize('norm_type', ['instance', 'layer', 'group', None])
@pytest.mark.parametrize('ndim', [2, 3, 4])
def test_normalize_matches_jax(norm_type, ndim):
  shape = {2: (B, 64), 3: (B, T, 64), 4: (B, T, 3, 64)}[ndim]
  x = 3.0 * _x(shape) + 1.0
  j_norm = j_layers.Normalize(norm_type)
  params = _init(j_norm, x)
  params['scale'] = 1.0 + 0.1 * _x(params['scale'].shape, seed=5)
  t_norm = _port(t_layers.Normalize(64, norm_type), params)
  y_t = t_norm(torch.from_numpy(x))
  np.testing.assert_allclose(y_t.detach().numpy(),
                             np.asarray(_apply(j_norm, params, x)),
                             atol=1e-5)
  if norm_type is not None:
    _assert_grads(_grads(t_norm, y_t), _jax_grads(j_norm, params, x))
  x4 = t_layers.ensure_4d(torch.from_numpy(x))
  assert x4.ndim == 4
  assert torch.equal(t_layers.inv_ensure_4d(x4, ndim), torch.from_numpy(x))


def test_identity_and_embedding_match_jax():
  x = _x((B, T, CH))
  np.testing.assert_array_equal(
      t_layers.Identity()(torch.from_numpy(x)).numpy(),
      np.asarray(j_layers.Identity().apply({}, jnp.asarray(x))))
  idx = np.array([[0, 3, 9], [4, 4, 1]], np.int32)
  j_emb = j_layers.Embedding(10, 6)
  params = _init(j_emb, idx)
  t_emb = _port(t_layers.Embedding(10, 6), params)
  np.testing.assert_array_equal(t_emb(torch.from_numpy(idx)).detach().numpy(),
                                np.asarray(_apply(j_emb, params, idx)))


@pytest.mark.parametrize('size,k,s', [(37, 7, 2), (16, 3, 2), (9, 1, 2),
                                      (10, 3, 1)])
def test_conv_same_padding_matches_flax(size, k, s):
  import flax.linen as fnn
  x = _x((2, 3, size, 4), seed=size)
  j_conv = fnn.Conv(5, (k, k), strides=(1, s), padding='SAME')
  params = _init(j_conv, x)
  t_conv = _port(t_resnet.Conv(4, 5, (k, k), (1, s)), params)
  y_t = t_conv(torch.from_numpy(x))
  np.testing.assert_allclose(y_t.detach().numpy(),
                             np.asarray(_apply(j_conv, params, x)),
                             atol=1e-5)
  _assert_grads(_grads(t_conv, y_t), _jax_grads(j_conv, params, x))
