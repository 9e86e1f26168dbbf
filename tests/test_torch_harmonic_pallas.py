"""K1's plain versions against the Pallas kernels in interpret mode (forward,
dphase and dham) at B in {1, 3}, H in {13, 60}, hops 64 and 320, both
amplitude resamplings: the cases of tests/test_torch_harmonic_tiles.py
against the Pallas VJP, with its inputs and tolerances (its docstring)."""

import numpy as np
import pytest
import torch

from test_torch_harmonic_tiles import (  # pylint: disable=g-bad-import-order
    BWD_RTOL, FWD_ATOL, SR, _cotangent, _inputs, _pallas, _port,
    _scaled_close)

torch.set_num_threads(1)


@pytest.mark.parametrize('method', ['window', 'linear'])
@pytest.mark.parametrize('hop,n_frames', [(64, 6), (320, 3)])
@pytest.mark.parametrize('batch,n_harmonics', [(1, 13), (3, 60), (1, 60),
                                               (3, 13)])
def test_plain_matches_pallas(method, hop, n_frames, batch, n_harmonics):
  phase0, f0_env, ham = _inputs(batch, n_frames, hop, n_harmonics,
                                seed=hop + n_harmonics + batch)
  assert (f0_env * n_harmonics >= SR / 2).any()  # the mask is exercised
  g = _cotangent(phase0)
  out_t, dphase_t, dham_t = _port(phase0, f0_env, ham, g, method)
  out_p, dphase_p, dham_p = _pallas(phase0, f0_env, ham, g, method)
  np.testing.assert_allclose(out_t, out_p, atol=FWD_ATOL)
  _scaled_close(dham_t, dham_p, BWD_RTOL, 'dham')
  _scaled_close(dphase_t, dphase_p, BWD_RTOL, 'dphase')
