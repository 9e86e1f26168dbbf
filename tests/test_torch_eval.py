"""The port's eval package (ddsp_torch.eval) against the JAX package's, on
the CPU.

The metrics and evaluators of both packages are fed the same numpy batches
and model outputs and must report the same keys and values; the eval loop
runs end to end on the tiny preset from a port train directory, in both
modes; postprocessing is held against the JAX functions on the same data.

Tolerances sit beside their constants below, each with why.
"""

import json
import os

import numpy as np
import pytest
import torch

from ddsp_tpu.data import providers as j_providers
from ddsp_tpu.eval import evaluators as j_evaluators
from ddsp_tpu.eval import metrics as j_metrics
from ddsp_tpu.eval import postprocessing as j_post
from ddsp_tpu.eval import summaries as j_summaries
from ddsp_torch import eval as t_eval
from ddsp_torch.data import ArrayDataProvider
from ddsp_torch.eval import eval_util
from ddsp_torch.eval import evaluators as t_evaluators
from ddsp_torch.eval import metrics as t_metrics
from ddsp_torch.eval import postprocessing as t_post
from ddsp_torch.eval import summaries as t_summaries
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model, checkpoints, save_spec

torch.set_num_threads(1)

SR = 16000
FRAME_RATE = 250
SECONDS = 0.5
N_SAMPLES = int(SECONDS * SR)
N_FRAMES = int(SECONDS * FRAME_RATE) + 1  # centered framing: 126
# Numpy metrics (YIN, distances, RPA/RCA) on the same inputs: the only
# difference is MIDI from jnp's and torch's float32 log2.
NUMPY_ATOL = 1e-6
# Loudness in dB from jnp.fft and torch.fft: float32 rounding of the same
# powers (~4e-6 dB), averaged.
LOUDNESS_ATOL_DB = 1e-4
# CREPE's f0 within 1 cent of JAX's (tests/test_torch_crepe.py): the mean
# MIDI distance within 0.01; RPA/RCA count frames within 50 cents and do
# not move unless a frame sits within a cent of that edge.
CREPE_MIDI_ATOL = 1e-2
CREPE_FRACTION_ATOL = 1e-6


def _batch(seed=0, batch=2):
  """Harmonic audio at a known f0 and the generated audio of a 'model' a
  little off it, with the dataset features of both packages' batches."""
  rng = np.random.RandomState(seed)
  t = np.arange(N_SAMPLES) / SR
  f0 = 220.0 * 2**(np.arange(batch) / 12.0)
  audio = np.stack([0.3 * np.sin(2 * np.pi * f * t) +
                    0.1 * np.sin(4 * np.pi * f * t) for f in f0])
  audio_gen = np.stack([0.25 * np.sin(2 * np.pi * f * 1.01 * t)
                        for f in f0]) + 0.01 * rng.randn(batch, N_SAMPLES)
  f0_hz = np.repeat(f0[:, None], N_FRAMES, axis=1)
  f0_hz[:, :5] = 0.0  # unvoiced frames
  conf = np.clip(0.9 + 0.1 * rng.randn(batch, N_FRAMES), 0, 1)
  batch_dict = {
      'audio': audio.astype(np.float32),
      'f0_hz': f0_hz[..., None].astype(np.float32),
      'f0_confidence': conf.astype(np.float32),
      'loudness_db': (-30.0 + rng.randn(batch, N_FRAMES)).astype(np.float32),
  }
  outputs = {'audio_synth': audio_gen.astype(np.float32),
             'harmonic': {'controls': {'f0_hz': (f0_hz * 1.003)[..., None]
                                       .astype(np.float32)}}}
  return batch_dict, outputs


def _assert_scalars(got, want, atol):
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=atol(k), rtol=0,
                               err_msg=k)


def test_distance_and_pitch_accuracy_functions_match_jax():
  batch, outputs = _batch()
  ref = batch['f0_hz'][0, :, 0]
  est = outputs['harmonic']['controls']['f0_hz'][0, :, 0] * np.linspace(
      0.95, 1.05, N_FRAMES)
  voicing = ref > 0
  for name in ('raw_pitch_accuracy', 'raw_chroma_accuracy'):
    assert getattr(t_metrics, name)(ref, est, voicing) == getattr(
        j_metrics, name)(ref, est, voicing)
  for conf in (None, batch['f0_confidence'][0], np.zeros(N_FRAMES)):
    want = j_metrics.f0_dist_conf_thresh(ref, est, conf)
    got = t_metrics.f0_dist_conf_thresh(ref, est, conf)
    assert (got is None) == (want is None)
    if want is not None:
      np.testing.assert_allclose(got, want, atol=NUMPY_ATOL, rtol=0)
  np.testing.assert_array_equal(t_metrics.l1_distance(ref[:50], est),
                                j_metrics.l1_distance(ref[:50], est))
  want = j_metrics.compute_audio_features(batch['audio'])
  got = t_metrics.compute_audio_features(batch['audio'], device='cpu')
  np.testing.assert_allclose(got['loudness_db'], want['loudness_db'],
                             atol=LOUDNESS_ATOL_DB, rtol=0)


def test_yin_matches_jax():
  batch, outputs = _batch()
  for audio in (batch['audio'], outputs['audio_synth'][0]):
    want = j_metrics.compute_f0_yin(audio)
    got = t_metrics.compute_f0_yin(audio)
    for g, w in zip(got, want):
      np.testing.assert_array_equal(g, w)


def test_loudness_and_f0_metrics_match_jax():
  batch, outputs = _batch()
  pairs = [(j_metrics.LoudnessMetrics(),
            t_metrics.LoudnessMetrics(device='cpu'), 'audio'),
           (j_metrics.F0Metrics(), t_metrics.F0Metrics(), 'f0')]
  for want_m, got_m, kind in pairs:
    for b in (batch, {k: v for k, v in batch.items() if k != 'loudness_db'}):
      arg = (outputs['audio_synth'] if kind == 'audio' else
             outputs['harmonic']['controls']['f0_hz'])
      want_m.update_state(b, arg)
      got_m.update_state(b, arg)
    _assert_scalars(got_m.flush(3), want_m.flush(3),
                    lambda k: LOUDNESS_ATOL_DB if 'loudness' in k else
                    NUMPY_ATOL)


@pytest.mark.parametrize('estimator', ['yin', 'crepe'])
def test_f0_gen_metrics_match_jax(estimator):
  batch, outputs = _batch(seed=1)
  want_m = j_metrics.F0GenMetrics(estimator=estimator)
  got_m = t_metrics.F0GenMetrics(estimator=estimator, device='cpu')
  for b in (batch, {'audio': batch['audio']}):
    want_m.update_state(b, outputs['audio_synth'])
    got_m.update_state(b, outputs['audio_synth'])
  want, got = want_m.flush(1), got_m.flush(1)
  assert len(want) == 4
  if estimator == 'yin':
    _assert_scalars(got, want, lambda k: NUMPY_ATOL)
  else:
    _assert_scalars(got, want, lambda k: CREPE_MIDI_ATOL if 'f0_dist' in k
                    else CREPE_FRACTION_ATOL)


def test_crepe_metrics_class_and_weights():
  assert t_metrics.crepe_weights_available() == (
      j_metrics.crepe_weights_available())
  assert t_metrics.crepe_weights_available()
  assert not t_metrics.crepe_weights_available('full')
  metrics = t_metrics.F0CrepeMetrics(device='cpu')
  assert metrics._name == 'f0_crepe' and metrics._estimator == 'crepe'  # pylint: disable=protected-access


def test_evaluators_match_jax(tmp_path):
  """BasicEvaluator and F0LdEvaluator ('auto' resolves to CREPE with the
  committed weights) over two batches: the same keys and values, and the
  same sample wavs."""
  batches = [_batch(seed=s) for s in (2, 3)]
  losses = [{'spectral_loss': 1.5 + s, 'total_loss': 1.5 + s}
            for s in range(2)]
  pairs = [(j_evaluators.BasicEvaluator(), t_evaluators.BasicEvaluator()),
           (j_evaluators.F0LdEvaluator(),
            t_evaluators.F0LdEvaluator(device='cpu'))]
  assert pairs[1][1]._f0_gen_metrics._estimator == 'crepe'  # pylint: disable=protected-access
  for want_e, got_e in pairs:
    for (b, o), l in zip(batches, losses):
      want_e.evaluate(b, o, l)
      got_e.evaluate(b, o, l)
    _assert_scalars(
        got_e.flush(7), want_e.flush(7),
        lambda k: (LOUDNESS_ATOL_DB if 'loudness' in k else CREPE_MIDI_ATOL
                   if 'crepe/f0_dist' in k else CREPE_FRACTION_ATOL
                   if 'crepe' in k else NUMPY_ATOL))
  for pkg, evaluator in (('jax', pairs[0][0]), ('port', pairs[0][1])):
    for b, o in batches:
      evaluator.sample(b, o, str(tmp_path / pkg), 7)
  names = sorted(os.listdir(tmp_path / 'port' / 'samples' / 'step_7'))
  assert names == sorted(os.listdir(tmp_path / 'jax' / 'samples' /
                                    'step_7'))
  assert '3_synth.wav' in names and '3_synth_spectrogram.png' in names
  for name in names:
    if name.endswith('.wav'):
      with open(tmp_path / 'port' / 'samples' / 'step_7' / name, 'rb') as a:
        with open(tmp_path / 'jax' / 'samples' / 'step_7' / name, 'rb') as b:
          assert a.read() == b.read(), name


def test_summaries_write_wavs_without_matplotlib(tmp_path, monkeypatch):
  batch, outputs = _batch()
  monkeypatch.setitem(__import__('sys').modules, 'matplotlib', None)
  out_dir = t_summaries.sample_batch(str(tmp_path), 2, batch,
                                     outputs['audio_synth'])
  assert sorted(os.listdir(out_dir)) == ['0_original.wav', '0_synth.wav',
                                         '1_original.wav', '1_synth.wav']
  t_summaries.f0_summary(str(tmp_path / 'f0.png'), batch['f0_hz'][0],
                         batch['f0_hz'][0])
  assert not (tmp_path / 'f0.png').exists()


def test_f0_summary_draws_the_jax_figure(tmp_path):
  batch, outputs = _batch()
  f0_pred = outputs['harmonic']['controls']['f0_hz'][0]
  for pkg, summaries in (('jax', j_summaries), ('port', t_summaries)):
    summaries.f0_summary(str(tmp_path / pkg / 'f0.png'), batch['f0_hz'][0],
                         f0_pred)
    assert (tmp_path / pkg / 'f0.png').stat().st_size > 0
  # The figure's magnitudes (the dB of near-silent bins reads the FFTs'
  # rounding), relative to the peak as tests/test_torch_crepe.py holds mel.
  got, want = (10**(m._spectrogram_db(batch['audio'][0]) / 20)  # pylint: disable=protected-access
               for m in (t_summaries, j_summaries))
  np.testing.assert_allclose(got, want, atol=1e-5 * want.max(), rtol=0)


def test_checkpoints_iterator_over_port_checkpoints(tmp_path):
  assert not list(eval_util.checkpoints_iterator(str(tmp_path),
                                                 run_once=True))
  for step in (3, 12):
    open(checkpoints.checkpoint_path(str(tmp_path), step), 'w').close()
  open(tmp_path / 'ckpt-7.pt.123.tmp', 'w').close()
  assert list(eval_util.checkpoints_iterator(str(tmp_path),
                                             run_once=True)) == [12]
  seen = eval_util.checkpoints_iterator(str(tmp_path), delay_secs=0.01,
                                        timeout_secs=0.05)
  assert next(seen) == 12
  open(checkpoints.checkpoint_path(str(tmp_path), 20), 'w').close()
  assert list(seen) == [20]


def _tiny_provider():
  rng = np.random.RandomState(5)
  t = np.arange(16000) / SR
  f0 = np.array([196.0, 262.0, 330.0, 392.0])
  return ArrayDataProvider({
      'audio': np.stack([0.3 * np.sin(2 * np.pi * f * t) for f in f0]
                        ).astype(np.float32),
      'f0_hz': np.repeat(f0[:, None], 250, axis=1).astype(np.float32),
      'f0_confidence': np.ones((4, 250), np.float32),
      'loudness_db': (-25.0 + rng.randn(4, 250)).astype(np.float32)})


@pytest.fixture(scope='module')
def train_dir(tmp_path_factory):
  """A port train directory of the tiny preset: spec and ckpt-2."""
  path = str(tmp_path_factory.mktemp('train'))
  save_spec(path, 'tiny')
  trainer = Trainer(build_model('tiny', device='cpu', seed=0), device='cpu')
  state = trainer.init()
  batch = next(_tiny_provider().get_batch(2, shuffle=False))
  for _ in range(2):
    state, _ = trainer.train_step(state, batch)
  trainer.save(state, path)
  return path


def test_evaluate_or_sample_end_to_end(train_dir, tmp_path):
  provider = _tiny_provider()
  trainer = Trainer(build_model('tiny', device='cpu', seed=1), device='cpu')
  save_dir = str(tmp_path / 'eval')
  scalars = t_eval.evaluate_or_sample(provider, trainer, save_dir,
                                      restore_dir=train_dir, batch_size=2,
                                      num_batches=2)
  assert trainer.checkpoint_steps(train_dir) == [2]
  assert {'losses/spectral_loss', 'losses/total_loss',
          'metrics/loudness/loudness_db_l1',
          'metrics/f0/raw_pitch_accuracy', 'metrics/f0/f0_dist_midi_l1',
          'metrics/f0_crepe/raw_pitch_accuracy',
          'metrics/f0_crepe/outlier_ratio'} <= set(scalars)
  assert all(np.isfinite(v) for v in scalars.values())
  with open(os.path.join(save_dir, 'eval', 'metrics.jsonl')) as f:
    record = json.loads(f.read().splitlines()[-1])
  assert record == dict(scalars, step=2)

  # The same checkpoint's forward by hand, fed to fresh evaluators.
  model = build_model('tiny', device='cpu')
  model.load_state_dict(torch.load(
      checkpoints.checkpoint_path(train_dir, 2), weights_only=True)['params'])
  evaluators = [t_evaluators.BasicEvaluator(),
                t_evaluators.F0LdEvaluator(device='cpu')]
  batches = provider.get_batch(2, shuffle=False)
  for _ in range(2):
    batch = next(batches)
    with torch.no_grad():
      outputs, losses = model(
          {k: torch.from_numpy(v) for k, v in batch.items()},
          training=False, return_losses=True,
          generator=torch.Generator().manual_seed(0))
    for evaluator in evaluators:
      evaluator.evaluate(batch, eval_util.to_host(outputs),
                         {k: float(v) for k, v in losses.items()})
  by_hand = {}
  for evaluator in evaluators:
    by_hand.update(evaluator.flush(2))
  assert by_hand == scalars

  assert t_eval.evaluate_or_sample(provider, trainer, save_dir,
                                   restore_dir=train_dir, mode='sample',
                                   batch_size=2, num_batches=2) == {}
  names = os.listdir(os.path.join(save_dir, 'samples', 'step_2'))
  assert {f'{i}_{kind}.wav' for i in range(4)
          for kind in ('original', 'synth')} <= set(names)


def test_default_evaluators_run_on_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    t_evaluators.F0LdEvaluator()


# ---------------------------------------------------------------------------
# postprocessing
# ---------------------------------------------------------------------------
def _notes(seed=0, n=3, frames=300):
  rng = np.random.RandomState(seed)
  loudness = np.full((n, frames), -70.0)
  conf = 0.2 * rng.rand(n, frames)
  f0 = 220.0 * (1 + 0.01 * rng.randn(n, frames))
  for i in range(n):
    for start in range(20 + 7 * i, frames - 40, 90):
      loudness[i, start:start + 50] = -20.0 + rng.randn(50)
      conf[i, start:start + 50] = 0.9 + 0.05 * rng.rand(50)
      f0[i, start:start + 50] = 261.6 * 2**((2 * i + start % 5) / 12)
  return (loudness.astype(np.float32), conf.astype(np.float32),
          f0.astype(np.float32))


def test_smooth_and_detect_notes_match_jax():
  loudness, conf, _ = _notes()
  for size in (3, 4, 40):
    np.testing.assert_array_equal(t_post.smooth(conf, size),
                                  j_post.smooth(conf, size))
  np.testing.assert_array_equal(t_post.smooth(conf[0], 5),
                                j_post.smooth(conf[0], 5))
  for got, want in zip(t_post.detect_notes(loudness, conf),
                       j_post.detect_notes(loudness, conf)):
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('distribution', ['uniform', 'normal'])
def test_quantile_transform_matches_jax(distribution):
  rng = np.random.RandomState(1)
  x = rng.randn(500, 2) * [3.0, 0.5]
  want = j_post.QuantileTransformer(100, distribution).fit(x)
  got = t_post.QuantileTransformer(100, distribution).fit(x)
  np.testing.assert_array_equal(got.quantiles_, want.quantiles_)
  for fn in ('transform', 'inverse_transform'):
    arg = x if fn == 'transform' else want.transform(x)
    np.testing.assert_array_equal(getattr(got, fn)(arg),
                                  getattr(want, fn)(arg))
  loudness, conf, _ = _notes()
  mask, _ = j_post.detect_notes(loudness, conf)
  inv = j_post.QuantileTransformer().fit(rng.randn(400, 1) - 30)
  want_q, want_norm = j_post.fit_quantile_transform(loudness, mask, inv)
  got_q, got_norm = t_post.fit_quantile_transform(loudness, mask, inv)
  np.testing.assert_array_equal(got_q.quantiles_, want_q.quantiles_)
  np.testing.assert_array_equal(got_norm, want_norm)


def test_dataset_statistics_match_jax(tmp_path):
  loudness, conf, f0 = _notes(frames=126)
  audio = np.stack([0.3 * np.sin(2 * np.pi * f.mean() * np.arange(8000) /
                                 SR) for f in f0]).astype(np.float32)
  examples = {'audio': audio, 'loudness_db': loudness, 'f0_hz': f0,
              'f0_confidence': conf}
  want = j_post.compute_dataset_statistics(
      j_providers.ArrayDataProvider(examples), batch_size=2)
  path = str(tmp_path / 'stats.pkl')
  got = t_post.save_dataset_statistics(ArrayDataProvider(examples), path,
                                       batch_size=2, power_frame_size=1024,
                                       device='cpu')
  # save_dataset_statistics' default power frame (256 samples) is shorter
  # than the hop of its 50 Hz frames (320): both packages refuse it.
  for post, provider in ((j_post, j_providers.ArrayDataProvider),
                         (t_post, ArrayDataProvider)):
    kwargs = {'device': 'cpu'} if post is t_post else {}
    with pytest.raises(ValueError, match='must be greater than hop_size'):
      post.save_dataset_statistics(provider(examples), **kwargs)
  assert set(got) == set(want)
  for stats in (got, t_post.compute_dataset_statistics(
      ArrayDataProvider(examples), batch_size=2, device='cpu')):
    for k, v in want.items():
      if k == 'quantile_transform':
        np.testing.assert_array_equal(stats[k].quantiles_, v.quantiles_)
      elif 'power' in k:  # the two FFTs' powers, in dB
        np.testing.assert_allclose(stats[k], v, atol=LOUDNESS_ATOL_DB,
                                   rtol=0, err_msg=k)
      else:
        np.testing.assert_allclose(stats[k], v, atol=NUMPY_ATOL, rtol=0,
                                   err_msg=k)
  loaded = t_post.load_dataset_statistics(path)
  assert set(loaded) == set(got)
  np.testing.assert_array_equal(loaded['quantile_transform'].quantiles_,
                                got['quantile_transform'].quantiles_)


def test_tuning_matches_jax():
  _, conf, f0 = _notes(seed=2)
  f0_midi = 12 * np.log2(f0[0] / 440.0) + 69 + 0.23
  mask = conf[0] > 0.5
  want = j_post.get_tuning_factor(f0_midi, conf[0], mask)
  assert t_post.get_tuning_factor(f0_midi, conf[0], mask) == want
  for chromatic in (False, True):
    np.testing.assert_array_equal(
        t_post.auto_tune(f0_midi, want, mask, 0.7, chromatic),
        j_post.auto_tune(f0_midi, want, mask, 0.7, chromatic))
