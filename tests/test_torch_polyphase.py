"""nn/dilated_conv.py's polyphase resampling against the JAX package's, on
the CPU: the cases of tests/test_torch_dilated_conv.py that need no stack,
with its tolerances (its docstring)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import dilated_conv as j_dc
from ddsp_torch.nn import dilated_conv as t_dc
from test_torch_dilated_conv import (  # pylint: disable=g-bad-import-order
    _np, _t)

torch.set_num_threads(1)


@pytest.mark.parametrize('resample_type', ['down', 'up'])
@pytest.mark.parametrize('trim_or_pad', ['pad', 'trim'])
@pytest.mark.parametrize('stride', [2, 3])
@pytest.mark.parametrize('four_d', [False, True])
def test_polyphase_resample(resample_type, trim_or_pad, stride, four_d):
  x = np.random.RandomState(stride).randn(2, 11, 7).astype(np.float32)
  if four_d:
    x = x[:, :, None, :]
  y_j = j_dc.polyphase_resample(jnp.asarray(x), stride, resample_type,
                                trim_or_pad)
  y_t = t_dc.PolyphaseResample(stride, resample_type, trim_or_pad)(_t(x))
  assert y_t.shape == y_j.shape
  np.testing.assert_array_equal(_np(y_t), _np(y_j))
