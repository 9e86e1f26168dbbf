"""ddsp_torch.run (the ddsp-torch-run CLI) and the training loop's metrics
writer, on the CPU, against ddsp_tpu.run where the JAX package defines the
answer.

build_data_provider: the same provider class, geometry and first batch as
the JAX one for the specs that need no download (synthetic, a tfrecord
pattern written here, synthetic_notes), and the same TFDS name, split and
data_dir from a 'tfds:' spec (parsed, not loaded). main(): the tiny preset
trains for 2 steps, then evaluates once and samples, in this process; the
operative spec it writes is the JAX package's save_spec's, byte for byte;
a mesh over several cards in one process raises (--multihost runs in
tests/test_torch_distributed.py). MetricsWriter writes TensorBoard event
files where torch.utils.tensorboard imports and metrics.jsonl alone where
it does not.
"""

import glob
import json
import os
import sys

import numpy as np
import pytest
import torch

from ddsp_tpu import run as j_run
from ddsp_tpu.utils import registry as j_registry
from ddsp_torch import run as t_run
from ddsp_torch.data.tfrecord import write_examples
from ddsp_torch.data import SyntheticSinusoidProvider
from ddsp_torch.train import train_loop

torch.set_num_threads(1)

TINY = dict(n_samples=3200, time_steps=50, reverb_length=800)
GEOMETRY = (3200, 16000, 250)
# synthetic_notes makes its controls on the fly through float32 pow,
# sigmoid, exp and sums, whose last bits may differ between XLA and torch
# (tests/test_torch_synthetic_data.py's tier); the other providers read or
# draw the same numpy values, bit for bit.
NOTES_RTOL, NOTES_ATOL = 1e-5, 1e-6


def _providers(spec, **resolved):
  args = GEOMETRY + (resolved,)
  return (j_run.build_data_provider(spec, *args),
          t_run.build_data_provider(spec, *args, device='cpu'))


def _assert_same_batch(a, b, rtol=0.0, atol=0.0):
  assert sorted(a) == sorted(b)
  for key in a:
    assert np.asarray(b[key]).dtype == np.asarray(a[key]).dtype, key
    np.testing.assert_allclose(np.asarray(b[key]), np.asarray(a[key]),
                               rtol=rtol, atol=atol, err_msg=key)


@pytest.fixture(scope='module')
def records(tmp_path_factory):
  d = tmp_path_factory.mktemp('records')
  provider = SyntheticSinusoidProvider(n_samples=3200, n_examples=4, seed=3)
  write_examples(str(d / 'train.tfrecord-00000-of-00001'),
                 list(provider.get_dataset(shuffle=False)))
  return str(d / 'train.tfrecord*')


@pytest.mark.parametrize('kind', ['synthetic:4', 'tfrecord',
                                  'synthetic_notes'])
def test_build_data_provider_matches_jax(kind, records):
  spec = f'tfrecord:{records}' if kind == 'tfrecord' else kind
  resolved = dict(TINY, n_harmonics=20, n_noise_magnitudes=33)
  want, got = _providers(spec, **resolved)
  assert type(got).__name__ == type(want).__name__
  for attr in ('sample_rate', 'frame_rate', 'n_samples', 'n_timesteps',
               'n_harmonics', 'n_mags', 'n_examples'):
    assert getattr(got, attr, None) == getattr(want, attr, None), attr
  tol = ((NOTES_RTOL, NOTES_ATOL) if kind == 'synthetic_notes' else
         (0.0, 0.0))
  _assert_same_batch(next(want.get_batch(2, shuffle=False)),
                     next(got.get_batch(2, shuffle=False)), *tol)


@pytest.mark.parametrize('spec', [
    'tfds:nsynth/gansynth_subset.f0_and_loudness:2.3.0:train',
    'tfds:my_dataset:valid:gs://bucket/path:with:colons',
    'tfds:plain',
    'nsynth:test:/data/tfds',
])
def test_tfds_specs_parse_as_in_jax(spec):
  want, got = _providers(spec)
  assert type(got).__name__ == type(want).__name__
  for attr in ('_name', '_split', '_data_dir', 'sample_rate', 'frame_rate'):
    assert getattr(got, attr) == getattr(want, attr), attr


def test_unknown_data_spec_raises():
  with pytest.raises(ValueError, match='Unknown data spec'):
    t_run.build_data_provider('nope:x', *GEOMETRY)


@pytest.mark.parametrize('preset,kwargs,want', [
    ('tiny', {}, (16000, 16000, 250)),
    ('vst', {'seconds': 0.5}, (8000, 16000, 50)),
    ('solo_instrument', {'n_samples': 32000}, (32000, 16000, 250)),
])
def test_provider_geometry_follows_the_preset(preset, kwargs, want):
  _, n_samples, sample_rate, frame_rate = t_run.provider_geometry(
      preset, kwargs, 16000, 250)
  assert (n_samples, sample_rate, frame_rate) == want


@pytest.fixture(scope='module')
def trained(tmp_path_factory):
  """main(): train tiny for 2 steps on the CPU."""
  save_dir = str(tmp_path_factory.mktemp('run') / 'train')
  state = t_run.main([
      '--mode', 'train', '--preset', 'tiny', '--model_kwargs',
      json.dumps(TINY), '--save_dir', save_dir, '--data', 'synthetic:4',
      '--batch_size', '2', '--num_steps', '2', '--steps_per_summary', '1',
      '--steps_per_save', '2', '--device', 'cpu'])
  return save_dir, state


def test_main_trains(trained):
  save_dir, state = trained
  assert state.step == 2
  assert os.path.exists(os.path.join(save_dir, 'ckpt-00000002.pt'))
  with open(os.path.join(save_dir, 'metrics.jsonl')) as f:
    records = [json.loads(line) for line in f]
  assert [r['step'] for r in records] == [1, 2]
  assert all(np.isfinite(r['total_loss']) for r in records)


@pytest.mark.parametrize('mode', ['eval', 'sample'])
def test_main_evaluates_and_samples(trained, mode):
  """Eval and sample read the preset and geometry from the spec (no
  --preset or --model_kwargs)."""
  save_dir, _ = trained
  out = t_run.main(['--mode', mode, '--save_dir', save_dir, '--data',
                    'synthetic:4', '--batch_size', '2', '--run_once',
                    '--num_eval_batches', '1', '--device', 'cpu'])
  if mode == 'eval':
    assert np.isfinite(out['losses/total_loss'])
    assert 'metrics/loudness/loudness_db_l1' in out
  else:
    wavs = glob.glob(os.path.join(save_dir, 'samples', 'step_2', '*.wav'))
    assert wavs


def test_main_writes_the_jax_spec(trained, tmp_path):
  save_dir, _ = trained
  j_registry.save_spec(str(tmp_path), 'tiny', **TINY)
  with open(os.path.join(save_dir, 'operative_spec.json')) as a, open(
      tmp_path / 'operative_spec.json') as b:
    assert a.read() == b.read()


@pytest.mark.parametrize('flags,error,match', [
    (['--time_shards', '2'], SystemExit, 'must divide'),
])
def test_main_refuses(tmp_path, flags, error, match):
  with pytest.raises(error, match=match):
    t_run.main(['--save_dir', str(tmp_path), '--device', 'cpu'] + flags)
  assert not os.listdir(tmp_path)


def test_main_refuses_several_cards(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
  with pytest.raises(NotImplementedError, match='item 8'):
    t_run.main(['--save_dir', str(tmp_path)])
  assert t_run.visible_devices('cuda', 1) == [torch.device('cuda', 0)]


def test_main_runs_on_the_card_by_default(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='--device cpu'):
    t_run.main(['--save_dir', str(tmp_path)])


@pytest.mark.parametrize('tensorboard', [True, False])
def test_metrics_writer(tmp_path, monkeypatch, tensorboard):
  if not tensorboard:  # the import fails, as without the package
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
  writer = train_loop.MetricsWriter(str(tmp_path))
  writer.scalars(3, {'total_loss': 1.5})
  writer.close()
  with open(tmp_path / 'metrics.jsonl') as f:
    assert json.loads(f.read()) == {'step': 3, 'total_loss': 1.5}
  events = glob.glob(str(tmp_path / 'events.out.tfevents.*'))
  assert bool(events) == tensorboard
  if tensorboard:
    from tensorboard.backend.event_processing import event_accumulator  # pylint: disable=g-import-not-at-top
    acc = event_accumulator.EventAccumulator(str(tmp_path))
    acc.Reload()
    [scalar] = acc.Scalars('total_loss')
    assert (scalar.step, scalar.value) == (3, 1.5)
