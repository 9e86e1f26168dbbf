"""Pitch and the spectral features around CREPE against ddsp_tpu's, on
the CPU: the Viterbi decode, the HMM, compute_f0, mel and MFCC, the
online preprocessor and the weights' files; tests/test_torch_crepe.py's
cases without its module fixtures, with its tolerances (its docstring)."""

import json
import numpy as np
import pytest
import torch

from ddsp_tpu import infer as j_infer
from ddsp_tpu.nn import preprocessing as j_pre
from ddsp_tpu.ops import crepe as j_crepe
from ddsp_tpu.ops import hmm as j_hmm
from ddsp_tpu.ops import spectral as j_spectral
from ddsp_torch import infer as t_infer
from ddsp_torch.nn import preprocessing as t_pre
from ddsp_torch.ops import crepe as t_crepe
from ddsp_torch.ops import hmm as t_hmm
from ddsp_torch.ops import spectral as t_spectral
from test_torch_crepe import (  # pylint: disable=g-bad-import-order
    CONFIDENCE_ATOL, F0_CENTS, HMM_ATOL, MEL_RTOL_OF_PEAK, _cents, _obs_ll,
    _signal)

torch.set_num_threads(1)


def test_weights_of_another_capacity_are_refused():
  with pytest.raises(ValueError, match='conv1 filters'):
    t_crepe.load_weights(t_crepe.default_weights_path('tiny'), 'small')


def test_npz_is_read_without_h5py(monkeypatch):
  monkeypatch.setitem(__import__('sys').modules, 'h5py', None)
  crepe = t_crepe.PretrainedCrepe(device='cpu')
  assert crepe.pretrained and crepe.device == torch.device('cpu')


@pytest.mark.parametrize('kind', ['tone', 'glide', 'noise'])
def test_viterbi_states_equal_jax(kind):
  acts, obs = _obs_ll(kind)
  log_initial, log_transition, _ = t_crepe._viterbi_tables()  # pylint: disable=protected-access
  want = np.asarray(j_hmm.viterbi_decode(log_initial, log_transition, obs))
  got = t_hmm.viterbi_decode(*map(torch.from_numpy,
                                  (log_initial, log_transition, obs)))
  assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
  np.testing.assert_array_equal(got.numpy(), want)
  # And the whole decoder from the same activations.
  np.testing.assert_array_equal(
      t_crepe.crepe_viterbi_centers(torch.from_numpy(acts)).numpy(),
      np.asarray(j_crepe.crepe_viterbi_centers(acts)))


def test_viterbi_ties_take_the_first_state():
  """Uniform observations: every score ties, and both packages take the
  first maximal state at every step."""
  log_initial = np.zeros(4, np.float32)
  log_transition = np.zeros((4, 4), np.float32)
  obs = np.zeros((2, 5, 4), np.float32)
  want = np.asarray(j_hmm.viterbi_decode(log_initial, log_transition, obs))
  got = t_hmm.viterbi_decode(*map(torch.from_numpy,
                                  (log_initial, log_transition, obs)))
  np.testing.assert_array_equal(got.numpy(), want)
  assert not want.any()


def test_forward_log_prob_and_gaussian_obs_match_jax():
  rng = np.random.RandomState(4)
  n_states, obs_dim = 6, 3
  observations = rng.randn(2, 40, obs_dim).astype(np.float32)
  locs = rng.randn(n_states, obs_dim).astype(np.float32)
  scales = (0.5 + rng.rand(n_states, obs_dim)).astype(np.float32)
  want_ll = np.asarray(j_hmm.gaussian_obs_log_prob(observations, locs,
                                                   scales))
  got_ll = t_hmm.gaussian_obs_log_prob(*map(torch.from_numpy,
                                            (observations, locs, scales)))
  np.testing.assert_allclose(got_ll.numpy(), want_ll, atol=HMM_ATOL, rtol=0)
  transition = rng.rand(n_states, n_states) + 0.1
  log_transition = np.log(transition / transition.sum(1, keepdims=True))
  log_initial = np.log(np.full(n_states, 1.0 / n_states))
  args = [a.astype(np.float32) for a in (log_initial, log_transition,
                                         want_ll)]
  want = np.asarray(j_hmm.forward_log_prob(*args))
  got = t_hmm.forward_log_prob(*map(torch.from_numpy, args))
  assert tuple(got.shape) == want.shape == (2,)
  np.testing.assert_allclose(got.numpy(), want, atol=HMM_ATOL * 40, rtol=0)


@pytest.mark.parametrize('viterbi', [False, True])
@pytest.mark.parametrize('kind', ['tone', 'glide'])
def test_compute_f0_matches_jax(kind, viterbi):
  audio = _signal(kind)
  want_f0, want_conf = j_spectral.compute_f0(audio, 250, viterbi=viterbi)
  got_f0, got_conf = t_spectral.compute_f0(audio, 250, viterbi=viterbi,
                                           device='cpu')
  assert got_f0.dtype == got_conf.dtype == np.float32
  assert got_f0.shape == want_f0.shape == (501,)
  assert _cents(got_f0, want_f0).max() <= F0_CENTS
  np.testing.assert_allclose(got_conf, want_conf, atol=CONFIDENCE_ATOL,
                             rtol=0)
  if kind == 'tone':
    assert abs(np.median(got_f0) - 440.0) < 1.0


def test_compute_f0_of_a_batch_and_its_padding():
  audio = np.stack([_signal('tone', 0.25), _signal('glide', 0.25)])
  want_f0, want_conf = j_spectral.compute_f0(audio, 100, viterbi=False,
                                             padding='same')
  got_f0, got_conf = t_spectral.compute_f0(audio, 100, viterbi=False,
                                           padding='same', device='cpu')
  assert got_f0.shape == want_f0.shape == (2, 25)
  assert _cents(got_f0, want_f0).max() <= F0_CENTS
  np.testing.assert_allclose(got_conf, want_conf, atol=CONFIDENCE_ATOL,
                             rtol=0)


def test_compute_f0_caches_per_device_and_resets():
  t_spectral.reset_crepe()
  t_spectral.compute_f0(_signal('tone', 0.1), 250, device='cpu')
  cached = dict(t_spectral._CREPE_CACHE)  # pylint: disable=protected-access
  assert list(cached) == [('tiny', torch.device('cpu'))]
  t_spectral.compute_f0(_signal('tone', 0.1), 100, device='cpu')
  assert t_spectral._CREPE_CACHE == cached  # pylint: disable=protected-access
  assert cached['tiny', torch.device('cpu')].hop_size == 160
  t_spectral.reset_crepe()
  assert not t_spectral._CREPE_CACHE  # pylint: disable=protected-access


def test_compute_f0_runs_on_cuda_by_default(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    t_spectral.compute_f0(_signal('tone', 0.1), 250)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    t_crepe.PretrainedCrepe()


def test_full_float32_restores_the_process_settings():
  cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
  saved = (cudnn.allow_tf32, matmul.allow_tf32)
  try:
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    with t_crepe.full_float32():
      assert not cudnn.allow_tf32 and not matmul.allow_tf32
    assert cudnn.allow_tf32 and matmul.allow_tf32
  finally:
    cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.parametrize('fn', ['compute_mel', 'compute_logmel',
                                'compute_mfcc'])
def test_mel_and_mfcc_match_jax(fn):
  audio = np.stack([_signal('glide', 0.5) + 0.1 * _signal('noise', 0.5),
                    _signal('noise', 0.5)])
  want = np.asarray(getattr(j_spectral, fn)(audio))
  got = getattr(t_spectral, fn)(torch.from_numpy(audio)).numpy()
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want,
                             atol=MEL_RTOL_OF_PEAK * np.abs(want).max(),
                             rtol=0)


def test_numpy_helpers_match_jax():
  audio = _signal('glide', 0.3)
  np.testing.assert_array_equal(t_spectral.stft_np(audio, 512, 0.5),
                                j_spectral.stft_np(audio, 512, 0.5))
  np.testing.assert_array_equal(t_spectral._dct_ii_matrix_np(40),  # pylint: disable=protected-access
                                j_spectral._dct_ii_matrix_np(40))  # pylint: disable=protected-access
  np.testing.assert_array_equal(
      t_spectral.linear_to_mel_matrix_np(64, 513, 16000, 80.0, 7600.0),
      j_spectral.linear_to_mel_matrix_np(64, 513, 16000, 80.0, 7600.0))
  vector = np.arange(12, dtype=np.float32).reshape(2, 6)
  for n in (3, 6, 9):
    np.testing.assert_array_equal(
        t_spectral.pad_or_trim_to_expected_length(vector, n, 7.0).numpy(),
        np.asarray(j_spectral.pad_or_trim_to_expected_length(vector, n,
                                                             7.0)))
  with pytest.raises(ValueError, match='beyond tolerance'):
    t_spectral.pad_or_trim_to_expected_length(vector, 30)


def test_online_preprocessor_with_crepe_matches_jax():
  """With Viterbi (tests/test_torch_vst.py holds it without, as the VST
  path runs it)."""
  audio = np.stack([_signal('tone', 0.2), _signal('glide', 0.2)])
  kwargs = dict(frame_rate=50, padding='center', viterbi=True)
  want = j_pre.OnlineF0PowerPreprocessor(**kwargs).apply({}, {'audio':
                                                              audio})
  pre = t_pre.OnlineF0PowerPreprocessor(**kwargs)
  assert not list(pre.parameters()) and not pre.state_dict()
  audio_t = torch.from_numpy(audio).requires_grad_()
  got = pre({'audio': audio_t})
  assert not got['f0_hz'].requires_grad
  assert set(got) == set(want)
  assert _cents(got['f0_hz'].numpy(), want['f0_hz']).max() <= F0_CENTS
  np.testing.assert_allclose(got['f0_confidence'].numpy(),
                             want['f0_confidence'], atol=CONFIDENCE_ATOL,
                             rtol=0)
  np.testing.assert_allclose(got['pw_db'].detach().numpy(), want['pw_db'],
                             atol=1e-4, rtol=0)
  np.testing.assert_allclose(got['f0_scaled'].numpy(), want['f0_scaled'],
                             atol=1e-6, rtol=0)


@pytest.mark.parametrize('kind', ['tone', 'silence'])
def test_vst_extract_features_with_crepe_matches_jax(tmp_path, kind):
  (tmp_path / 'operative_spec.json').write_text(json.dumps(
      {'preset': 'vst', 'kwargs': {}}))
  frame = (np.zeros(1024, np.float32) if kind == 'silence' else
           _signal(kind, 0.1)[:1024])
  want = j_infer.VSTExtractFeatures(str(tmp_path))(frame)
  got = t_infer.VSTExtractFeatures(str(tmp_path), device='cpu')(
      torch.from_numpy(frame))
  assert _cents(got[0].numpy(), want[0]).max() <= F0_CENTS
  for g, w, atol in zip(got[1:], want[1:], (1e-6, 1e-4, 1e-6)):
    assert tuple(g.shape) == (1,) == w.shape
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=0)


def test_h5py_is_imported_only_to_read_an_h5():
  import ast  # pylint: disable=g-import-not-at-top
  import inspect  # pylint: disable=g-import-not-at-top
  tree = ast.parse(inspect.getsource(t_crepe))
  where = [fn.name for fn in ast.walk(tree)
           if isinstance(fn, ast.FunctionDef)
           for node in ast.walk(fn) if isinstance(node, ast.Import)
           and any(a.name == 'h5py' for a in node.names)]
  top = [node for node in tree.body if isinstance(node, ast.Import) and
         any(a.name == 'h5py' for a in node.names)]
  assert where == ['read_h5'] and not top
