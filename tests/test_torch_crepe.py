"""CREPE, the HMM, mel/MFCC and compute_f0 of ddsp_torch against ddsp_tpu,
on the CPU.

The committed tiny weights (assets/crepe) run through both packages: the
JAX flax tree (ddsp_tpu load_weights_from_h5) is carried into the port's
CrepeModel, and the port's default .npz is held against the .h5. The same
numpy tones, a glide and noise go through the JAX functions and the port's.

Tolerances sit beside their constants below, each with why.
"""

import jax
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import crepe as j_crepe
from ddsp_tpu.ops import spectral as j_spectral
from ddsp_torch.ops import crepe as t_crepe

torch.set_num_threads(1)

SR = 16000
H5 = t_crepe.default_weights_path('tiny').replace('.npz', '.h5')
# CREPE's sigmoid activations: the same float32 convolutions and dense
# product summed in another order by XLA and oneDNN (6.8e-8 measured).
ACTIVATION_ATOL = 1e-5
# Intermediate layers (BatchNorm outputs up to ~7 in size): the same sums,
# held relative to the layer's largest magnitude (2.5e-6 measured).
LAYER_RTOL_OF_PEAK = 1e-5
# HMM log-likelihoods: float32 logsumexp / gaussian terms of the same
# inputs, in another order.
HMM_ATOL = 1e-5
# compute_f0: the weighted average of cents of activations that agree to
# ~1e-7 (2.3e-3 cents measured), and the confidence (their max).
F0_CENTS = 1.0
CONFIDENCE_ATOL = 1e-5
# Mel and MFCC: float32 products of magnitudes that agree to ~1e-6
# relative (the two FFTs), held relative to each spectrogram's peak. The
# signals are broadband: a near-silent mel bin's log (and every MFCC
# through the DCT) would read the FFTs' rounding at 1/|X|.
MEL_RTOL_OF_PEAK = 1e-5


def _signal(kind, seconds=2.0):
  t = np.arange(int(seconds * SR)) / SR
  if kind == 'tone':
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t)
  elif kind == 'glide':  # 200 Hz -> 800 Hz, exponential
    phase = 2 * np.pi * 200.0 * seconds / np.log(4) * (
        4**(t / seconds) - 1)
    x = 0.4 * np.sin(phase) + 0.1 * np.sin(2 * phase)
  elif kind == 'noise':
    x = 0.1 * np.random.RandomState(0).randn(len(t))
  return x.astype(np.float32)


@pytest.fixture(scope='module')
def variables():
  """The JAX CREPE variables (flax tree) of the committed .h5, as numpy."""
  return jax.tree_util.tree_map(
      np.asarray, j_crepe.load_weights_from_h5(H5, 'tiny'))


@pytest.fixture(scope='module')
def frames():
  rng = np.random.RandomState(3)
  t = np.arange(1024) / SR
  raw = np.concatenate([
      0.3 * np.sin(2 * np.pi * f * t)[None] for f in
      (110.0, 220.0, 440.0, 880.0, 1500.0, 3000.0, 65.0, 330.0)] +
                       [0.1 * rng.randn(56, 1024)]).astype(np.float32)
  return np.array(j_crepe.PretrainedCrepe.normalize_frames(raw))


def _port_model(variables, activation_layer=None):
  model = t_crepe.CrepeModel(activation_layer=activation_layer)
  t_crepe.load_variables(model, variables)
  return model.eval()


def test_activations_match_flax(variables, frames):
  want = np.asarray(j_crepe.CrepeModel().apply(variables, frames))
  with torch.no_grad():
    got = _port_model(variables)(torch.from_numpy(frames)).numpy()
  assert got.shape == want.shape == (64, 360)
  np.testing.assert_allclose(got, want, atol=ACTIVATION_ATOL, rtol=0)


@pytest.mark.parametrize('layer', [f'conv{i}-{kind}' for i in range(1, 7)
                                   for kind in ('BN', 'maxpool')])
def test_activation_layers_match_flax(variables, frames, layer):
  want = np.asarray(j_crepe.CrepeModel(activation_layer=layer).apply(
      variables, frames))
  with torch.no_grad():
    got = _port_model(variables, layer)(torch.from_numpy(frames)).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(
      got, want, atol=LAYER_RTOL_OF_PEAK * np.abs(want).max(), rtol=0)


def test_npz_weights_equal_the_h5_bit_for_bit(variables, tmp_path):
  default = t_crepe.default_weights_path('tiny')
  assert default.endswith('model-tiny.npz')
  from_npz = t_crepe.load_weights(default)
  from_h5 = t_crepe.load_weights(H5)
  converted = t_crepe.load_weights(
      t_crepe.convert_h5_to_npz(H5, str(tmp_path / 'model-tiny.npz')))
  for tree in (from_npz, from_h5, converted):
    flat = jax.tree_util.tree_leaves_with_path(tree)
    want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(flat) == len(want) == 38
    for path, value in flat:
      assert value.dtype == want[path].dtype
      np.testing.assert_array_equal(value, want[path])


def _obs_ll(kind):
  """CREPE's Viterbi observation log-likelihoods of 0.5 s of a signal, by
  the JAX package: [1, 126, 360]."""
  acts = j_crepe.PretrainedCrepe(weights_path=H5, hop_size=64).activations(
      j_spectral.pad(_signal(kind, 0.5)[None], 1024, 64))
  _, _, log_emission = t_crepe._viterbi_tables()  # pylint: disable=protected-access
  return np.asarray(acts), np.einsum('bto,os->bts', np.asarray(acts),
                                     log_emission)


def _cents(a, b):
  return np.abs(1200.0 * np.log2(np.asarray(a, np.float64) /
                                 np.asarray(b, np.float64)))

