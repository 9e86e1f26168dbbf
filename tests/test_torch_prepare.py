"""The port's dataset preparation (ddsp_torch.data.prepare) against the JAX
package's, on the CPU.

One short wav of harmonic glides goes through both packages'
prepare_records; the records are read back with the JAX reader and held
feature by feature. Without frame features the files are byte-identical;
without CREPE every feature is bit for bit the JAX one's but the loudness
(the two FFTs round apart); with CREPE f0 and its confidence agree within
CREPE's tolerance (tests/test_torch_crepe.py).

Tolerances sit beside their constants below, each with why.
"""

import glob
import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from ddsp_tpu.data import prepare as j_prepare
from ddsp_tpu.data import tfrecord as j_tfrecord
from ddsp_torch.data import prepare as t_prepare

torch.set_num_threads(1)

SR = 16000
SECONDS = 2.0
# A-weighted loudness in dB from jnp.fft and torch.fft of the same frames:
# powers that agree to float32 rounding (3.8e-6 dB measured on 3 s).
LOUDNESS_ATOL_DB = 1e-4
# CREPE: activations within ~1e-7 of the JAX ones, decoded to cents, and
# the confidence (their max); the Viterbi path of the same observations is
# the JAX one (tests/test_torch_crepe.py).
F0_CENTS = 1.0
CONFIDENCE_ATOL = 1e-5
KWARGS = dict(frame_rate=250, example_secs=0.5, hop_secs=0.25,
              chunk_secs=1.0, num_shards=2)


@pytest.fixture(scope='module')
def wav(tmp_path_factory):
  """2 s of two harmonic glides (the second louder), 16-bit at 16 kHz."""
  t = np.arange(int(SECONDS * SR)) / SR
  f0 = np.where(t < 1.0, 220.0 * 2**t, 330.0 * 2**(-0.5 * (t - 1.0)))
  phase = 2 * np.pi * np.cumsum(f0) / SR
  amp = np.where(t < 1.0, 0.2, 0.4)
  audio = amp * (np.sin(phase) + 0.5 * np.sin(2 * phase) +
                 0.25 * np.sin(3 * phase))
  path = str(tmp_path_factory.mktemp('wav') / 'glides.wav')
  wavfile.write(path, SR, (audio * 32767 / 1.75).astype(np.int16))
  return path


def _records(paths):
  return [list(j_tfrecord.read_examples(p)) for p in paths]


def _names(paths, root):
  return [os.path.relpath(p, root) for p in paths]


def _dirs(tmp_path, *names):
  for name in names:
    (tmp_path / name).mkdir()


def _prepare_both(wav, tmp_path, **kwargs):
  _dirs(tmp_path, 'jax', 'port')
  want = j_prepare.prepare_records([wav], str(tmp_path / 'jax' / 'ds'),
                                   **kwargs)
  got = t_prepare.prepare_records([wav], str(tmp_path / 'port' / 'ds'),
                                  device='cpu', **kwargs)
  assert _names(got, tmp_path / 'port') == _names(want, tmp_path / 'jax')
  return want, got


@pytest.mark.parametrize('sample_rate,eval_fraction', [(16000, 0.0),
                                                       (8000, 0.5)])
def test_files_without_frame_features_are_byte_identical(
    wav, tmp_path, sample_rate, eval_fraction):
  want, got = _prepare_both(wav, tmp_path, frame_rate=None,
                            sample_rate=sample_rate,
                            eval_split_fraction=eval_fraction,
                            chunk_secs=1.0, num_shards=2)
  for w, g in zip(want, got):
    with open(w, 'rb') as fw, open(g, 'rb') as fg:
      assert fw.read() == fg.read()


def test_records_without_crepe_equal_jax_but_for_the_loudness(wav, tmp_path):
  want, got = _prepare_both(wav, tmp_path, compute_f0=False, **KWARGS)
  n = 0
  for want_shard, got_shard in zip(_records(want), _records(got)):
    assert len(got_shard) == len(want_shard)
    for w, g in zip(want_shard, got_shard):
      assert set(g) == set(w)
      for k in w:
        if k == 'loudness_db':
          np.testing.assert_allclose(g[k], w[k], atol=LOUDNESS_ATOL_DB,
                                     rtol=0)
        else:
          np.testing.assert_array_equal(g[k], w[k])
      n += 1
  assert n == 2 * 3  # two chunks of 1 s, three 0.5 s windows each


def test_records_with_crepe_match_jax(wav, tmp_path):
  want, got = _prepare_both(wav, tmp_path, **KWARGS)
  for want_shard, got_shard in zip(_records(want), _records(got)):
    assert len(got_shard) == len(want_shard) > 0
    for w, g in zip(want_shard, got_shard):
      assert set(g) == set(w)
      for k in ('audio', 'audio_16k'):
        np.testing.assert_array_equal(g[k], w[k])
      np.testing.assert_allclose(g['loudness_db'], w['loudness_db'],
                                 atol=LOUDNESS_ATOL_DB, rtol=0)
      cents = 1200 * np.log2(g['f0_hz'].astype(np.float64) / w['f0_hz'])
      assert np.abs(cents).max() <= F0_CENTS
      np.testing.assert_allclose(g['f0_confidence'], w['f0_confidence'],
                                 atol=CONFIDENCE_ATOL, rtol=0)
      assert g['f0_hz'].shape == (125,)  # 0.5 s at 250 Hz, not centered


def test_cli_writes_what_prepare_records_writes(wav, tmp_path):
  args = ['--input_audio_filepatterns', wav, '--frame_rate', '250',
          '--example_secs', '0.5', '--hop_secs', '0.25', '--chunk_secs',
          '1.0', '--num_shards', '2', '--no_viterbi', '--device', 'cpu']
  _dirs(tmp_path, 'cli', 'direct')
  written = t_prepare.main(args + ['--output_tfrecord_path',
                                   str(tmp_path / 'cli' / 'ds')])
  direct = t_prepare.prepare_records(
      [wav], str(tmp_path / 'direct' / 'ds'), viterbi=False, device='cpu',
      **KWARGS)
  assert sorted(glob.glob(str(tmp_path / 'cli' / '*'))) == written
  for a, b in zip(written, direct):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
      assert fa.read() == fb.read()
  with pytest.raises(FileNotFoundError, match='No audio files'):
    t_prepare.main(['--input_audio_filepatterns', str(tmp_path / 'none*'),
                    '--output_tfrecord_path', str(tmp_path / 'x')])


def test_prepare_runs_on_cuda_by_default(wav, tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    t_prepare.prepare_records([wav], str(tmp_path / 'ds'))


def test_pcm_to_float_mono_matches_jax():
  from ddsp_tpu.utils.audio_io import pcm_to_float_mono as j_pcm  # pylint: disable=g-import-not-at-top
  from ddsp_torch.utils.audio_io import pcm_to_float_mono as t_pcm  # pylint: disable=g-import-not-at-top
  rng = np.random.RandomState(0)
  for data in (rng.randint(-32768, 32767, (50, 2)).astype(np.int16),
               rng.randint(0, 255, 50).astype(np.uint8),
               rng.randn(50).astype(np.float64)):
    np.testing.assert_array_equal(t_pcm(data), j_pcm(data))
