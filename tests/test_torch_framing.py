"""The framing and padding of ops/spectral.py against the JAX package's, on
the CPU: tests/test_torch_spectral.py's cases of frame counts and pads,
with its tolerances (its docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import spectral as j_spectral
from ddsp_torch.ops import spectral as t_spectral
from test_torch_spectral import (  # pylint: disable=g-bad-import-order
    _audio)

torch.set_num_threads(1)


@pytest.mark.parametrize('padding', ['center', 'same', 'valid'])
@pytest.mark.parametrize('frame_size,hop_size', [(512, 64), (300, 100)])
def test_get_framed_lengths_and_pad(padding, frame_size, hop_size):
  n = 4000
  assert (t_spectral.get_framed_lengths(n, frame_size, hop_size, padding) ==
          j_spectral.get_framed_lengths(n, frame_size, hop_size, padding))
  x = _audio(n=n)
  out_t = t_spectral.pad(torch.from_numpy(x), frame_size, hop_size, padding)
  out_j = j_spectral.pad(jnp.asarray(x), frame_size, hop_size, padding)
  np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


@pytest.mark.parametrize('mode', ['constant', 'reflect', 'edge'])
def test_pad_modes_and_axes(mode):
  x = _audio(batch=3, n=200)[:, :, None].repeat(2, axis=2)  # [3, 200, 2]
  out_t = t_spectral.pad(torch.from_numpy(x), 64, 16, 'center', axis=1,
                         mode=mode, constant_values=0.5)
  out_j = j_spectral.pad(jnp.asarray(x), 64, 16, 'center', axis=1, mode=mode,
                         constant_values=0.5)
  np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
  with pytest.raises(ValueError, match='frame_size'):
    t_spectral.pad(torch.from_numpy(x), 16, 64)
  with pytest.raises(ValueError, match='padding'):
    t_spectral.get_framed_lengths(100, 16, 4, 'full')
