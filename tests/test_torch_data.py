"""The port's data package against ddsp_tpu.data, on the CPU.

TFRecord framing and the tf.Example wire format: a file written by the port
is byte-identical to the JAX writer's for the same examples, each package
reads the other's files, and the native, pure-Python and JAX CRCs agree.
Providers: with the same seed every provider yields the same examples and
batches as its JAX counterpart, bit for bit and dtype for dtype (no
tolerance: both draw from np.random.RandomState in the same order and
compute nothing in floating point but casts to float32).
"""

import ast

import numpy as np
import pytest
import torch

from ddsp_tpu import data as j_data
from ddsp_tpu import native as j_native
from ddsp_tpu.data import tfrecord as j_tfrecord
from ddsp_torch import data
from ddsp_torch import native
from ddsp_torch.data import tfrecord

torch.set_num_threads(1)

N_SAMPLES = 1600                 # 0.1 s at 16 kHz
N_FRAMES = N_SAMPLES // 64 + 1   # centred framing at 250 frames/s


def _assert_same(port, ref):
  """Equal values, shapes and dtypes through dicts, tuples and lists."""
  if isinstance(ref, dict):
    assert isinstance(port, dict) and sorted(port) == sorted(ref)
    for k in ref:
      _assert_same(port[k], ref[k])
  elif isinstance(ref, (tuple, list)) and not (
      ref and isinstance(ref[0], bytes)):
    assert type(port) is type(ref) and len(port) == len(ref)
    for a, b in zip(port, ref):
      _assert_same(a, b)
  elif isinstance(ref, list):
    assert port == ref
  else:
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    np.testing.assert_array_equal(port, ref)


def _assert_streams_equal(port_iter, ref_iter, limit=50):
  port_items = [x for _, x in zip(range(limit), port_iter)]
  ref_items = [x for _, x in zip(range(limit), ref_iter)]
  assert len(port_items) == len(ref_items) > 0
  _assert_same(port_items, ref_items)
  return len(ref_items)


def _examples(n, seed=0, every_16k=False):
  """Examples of the reference schema, with the 16 kHz copy on odd ones
  (or on every one)."""
  rng = np.random.RandomState(seed)
  out = []
  for i in range(n):
    ex = {'audio': rng.randn(N_SAMPLES).astype(np.float32),
          'f0_hz': (100 + 400 * rng.rand(N_FRAMES)).astype(np.float32),
          'f0_confidence': rng.rand(N_FRAMES).astype(np.float32),
          'loudness_db': (-80 * rng.rand(N_FRAMES)).astype(np.float32)}
    if i % 2 or every_16k:
      ex['audio_16k'] = rng.randn(N_SAMPLES).astype(np.float32)
    out.append(ex)
  return out


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
  """Three shards of 7, 5 and 6 examples, written by the port."""
  d = tmp_path_factory.mktemp('shards')
  examples = _examples(18, every_16k=True)
  for i, (lo, hi) in enumerate([(0, 7), (7, 12), (12, 18)]):
    tfrecord.write_examples(str(d / f'train.tfrecord-{i:05d}-of-00003'),
                            examples[lo:hi])
  return str(d / 'train.tfrecord*')


# ---------------------------------------------------------------------------
# TFRecord framing and tf.Example
# ---------------------------------------------------------------------------
def test_written_files_are_byte_identical_and_cross_read(tmp_path):
  rng = np.random.RandomState(1)
  examples = _examples(5, seed=3) + [{
      'ints': np.array([0, 1, -1, 2**40, -2**62], np.int64),
      'names': [b'tpt', b'vn'],
      'scalar': np.float32(0.5),
      'empty': np.zeros(0, np.float32),
      'doubles': rng.randn(7),  # float64, written as float32
  }]
  port_path, jax_path = str(tmp_path / 'port'), str(tmp_path / 'jax')
  tfrecord.write_examples(port_path, examples)
  j_tfrecord.write_examples(jax_path, examples)
  with open(port_path, 'rb') as a, open(jax_path, 'rb') as b:
    assert a.read() == b.read()
  for e in examples:
    assert tfrecord.serialize_example(e) == j_tfrecord.serialize_example(e)
  _assert_same(list(tfrecord.read_examples(jax_path)),
               list(j_tfrecord.read_examples(port_path)))
  assert (list(tfrecord.read_records(jax_path, verify_crc=True)) ==
          list(j_tfrecord.read_records(port_path, verify_crc=True)))


def test_native_python_and_jax_crcs_agree():
  assert native.codec_name() == 'native'  # needs a C compiler on PATH
  assert native.library_path(native._compiler()).parent == native.BUILD_DIR
  rng = np.random.RandomState(2)
  for n in [0, 1, 3, 8, 15, 16, 255, 4096, 100001]:
    payload = rng.bytes(n)
    py = tfrecord.crc32c(payload)
    assert native.crc32c(payload) == py == j_tfrecord.crc32c(payload)
    assert native.crc32c(payload) == j_native.crc32c(payload)
    assert native.masked_crc(payload) == j_native.masked_crc(payload)
    assert native.masked_crc(payload) == (
        (((py >> 15) | (py << 17)) + 0xA282EAD8) & 0xFFFFFFFF)
    framed = native.frame_record(payload)
    assert framed == j_native.frame_record(payload)
    assert native.check_record(framed) == n
  assert native.crc32c(b'\x00' * 32) == 0x8A9136AA  # RFC 3720


def test_pure_python_fallback_writes_the_same_bytes(tmp_path, monkeypatch):
  examples = _examples(3)
  native_path = str(tmp_path / 'native')
  tfrecord.write_examples(native_path, examples)
  monkeypatch.setattr(native, 'load_codec', lambda: None)
  assert native.codec_name() == 'python'
  python_path = str(tmp_path / 'python')
  tfrecord.write_examples(python_path, examples)
  with open(native_path, 'rb') as a, open(python_path, 'rb') as b:
    assert a.read() == b.read()
  assert len(list(tfrecord.read_records(python_path, verify_crc=True))) == 3


def test_corrupt_records_raise(tmp_path):
  path = str(tmp_path / 'x')
  tfrecord.write_examples(path, _examples(2))
  raw = bytearray(open(path, 'rb').read())
  raw[20] ^= 0xFF
  open(path, 'wb').write(bytes(raw))
  with pytest.raises(IOError, match='data CRC'):
    list(tfrecord.read_records(path, verify_crc=True))
  open(path, 'wb').write(bytes(raw[:-10]))
  with pytest.raises(IOError, match='Truncated'):
    list(tfrecord.read_records(path))


# ---------------------------------------------------------------------------
# Providers: the same seed, the same batches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('shuffle,repeats,drop_remainder',
                         [(False, 1, True), (False, 2, False),
                          (True, 3, False), (True, 2, True)])
def test_array_provider_get_batch(shuffle, repeats, drop_remainder):
  arrays = {'audio': np.random.RandomState(0).randn(7, 5),
            'f0_hz': np.arange(7, dtype=np.float32)}
  port = data.ArrayDataProvider(arrays, seed=4)
  ref = j_data.ArrayDataProvider(arrays, seed=4)
  n = _assert_streams_equal(
      port.get_batch(3, shuffle, repeats, drop_remainder),
      ref.get_batch(3, shuffle, repeats, drop_remainder))
  # Dropping carries a partial batch into the next epoch; keeping it yields
  # it at the end of each epoch.
  assert n == ((7 * repeats) // 3 if drop_remainder else 3 * repeats)


def test_synthetic_sinusoid_provider():
  kwargs = dict(n_samples=N_SAMPLES, n_examples=5, seed=3)
  port = data.SyntheticSinusoidProvider(**kwargs)
  ref = j_data.SyntheticSinusoidProvider(**kwargs)
  assert port.n_frames == ref.n_frames == N_FRAMES
  _assert_streams_equal(port.get_batch(2, shuffle=True),
                        ref.get_batch(2, shuffle=True), limit=8)


@pytest.mark.parametrize('cls', ['TFRecordProvider', 'LegacyTFRecordProvider'])
@pytest.mark.parametrize('centered', [True, False])
def test_tfrecord_providers(shards, cls, centered):
  kwargs = dict(example_secs=N_SAMPLES / 16000, centered=centered, seed=5)
  port = getattr(data, cls)(shards, **kwargs)
  ref = getattr(j_data, cls)(shards, **kwargs)
  assert port.n_frames == ref.n_frames == N_FRAMES - (0 if centered else 1)
  _assert_streams_equal(port.get_dataset(shuffle=False),
                        ref.get_dataset(shuffle=False))
  # Shuffled: the file order, then the reservoir swaps and the final
  # shuffle, over three epochs (the generator's state carries over).
  for _ in range(3):
    _assert_streams_equal(port.get_dataset(shuffle=True),
                          ref.get_dataset(shuffle=True))
  for _ in range(2):
    _assert_streams_equal(port.get_dataset(shuffle=True, shuffle_buffer=3),
                          ref.get_dataset(shuffle=True, shuffle_buffer=3))
  _assert_streams_equal(port.get_batch(4, shuffle=True, repeats=2,
                                       drop_remainder=False),
                        ref.get_batch(4, shuffle=True, repeats=2,
                                      drop_remainder=False))


def test_multi_providers():
  def sources(mod):
    arrays = [{'audio': np.random.RandomState(s).randn(n, 4),
               'f0_hz': np.random.RandomState(s + 9).rand(n)}
              for s, n in ((0, 6), (1, 9))]
    return [mod.ArrayDataProvider(a, seed=i) for i, a in enumerate(arrays)]

  for ratios in ((), (1, 2)):
    port = data.ZippedProvider(sources(data), batch_size_ratios=ratios)
    ref = j_data.ZippedProvider(sources(j_data), batch_size_ratios=ratios)
    _assert_streams_equal(port.get_dataset(shuffle=True),
                          ref.get_dataset(shuffle=True))
    _assert_streams_equal(port.get_batch(3, repeats=2, drop_remainder=False),
                          ref.get_batch(3, repeats=2, drop_remainder=False))

  port = data.MixedProvider(sources(data), batch_size_ratios=(1, 3), seed=7)
  ref = j_data.MixedProvider(sources(j_data), batch_size_ratios=(1, 3), seed=7)
  _assert_streams_equal(port.get_batch(2, repeats=3, drop_remainder=False),
                        ref.get_batch(2, repeats=3, drop_remainder=False))


def _urmp_example(rng, n_frames, midi=True):
  ex = {'audio': rng.randn(64 * (n_frames - 1)).astype(np.float32),
        'f0_hz': rng.rand(n_frames).astype(np.float32),
        'f0_confidence': rng.rand(n_frames).astype(np.float32),
        'loudness_db': rng.rand(n_frames).astype(np.float32)}
  if midi:
    roll = (rng.rand(n_frames, 128) > 0.97).astype(np.float32)
    ex.update({
        'note_active_velocities': (roll * 90).ravel(),
        'note_active_frame_indices': roll.ravel(),
        'instrument_id': [b'tpt'],
        'power_db': rng.rand(n_frames).astype(np.float32),
        'note_onsets': (rng.rand(n_frames * 128) > 0.99).astype(np.float32),
        'note_offsets': (rng.rand(n_frames * 128) > 0.99).astype(np.float32),
    })
  return ex


def test_urmp_providers(tmp_path):
  rng = np.random.RandomState(8)
  for split, n_frames in (('train', 26), ('full', 0)):
    for shard in range(2):
      lengths = [26] * 3 if n_frames else [11, 40, 26]
      path = tmp_path / (f'urmp_tpt_solo_ddsp_conditioning_{split}.tfrecord'
                         f'-{shard:05d}-of-00002')
      tfrecord.write_examples(str(path), [_urmp_example(rng, n)
                                          for n in lengths])
  for cls, split in (('Urmp', 'train'), ('UrmpMidi', 'train'),
                     ('UrmpMidiUnsegmented', 'full')):
    port = getattr(data, cls)(str(tmp_path), 'tpt', split, seed=2)
    ref = getattr(j_data, cls)(str(tmp_path), 'tpt', split, seed=2)
    assert port.default_file_pattern == ref.default_file_pattern
    for _ in range(2):
      _assert_streams_equal(port.get_dataset(shuffle=True),
                            ref.get_dataset(shuffle=True))
    if split == 'train':
      _assert_streams_equal(port.get_batch(2, repeats=2),
                            ref.get_batch(2, repeats=2))
  with pytest.raises(FileNotFoundError):
    data.Urmp(str(tmp_path), 'vn')


def _nsynth_examples(name, split, data_dir, shuffle):
  del name, split, data_dir, shuffle
  rng = np.random.RandomState(0)
  for i in range(5):
    yield {'audio': rng.randn(N_SAMPLES).astype(np.float32),
           'f0': {'hz': rng.rand(N_FRAMES).astype(np.float32),
                  'confidence': rng.rand(N_FRAMES).astype(np.float32)},
           'loudness': {'db': rng.rand(N_FRAMES).astype(np.float32)},
           'pitch': np.int64(60 + i),
           'instrument': {'source': np.int64(0), 'family': np.int64(i % 3),
                          'label': np.int64(i)},
           'id': b'fake'}


def test_tfds_providers_with_an_injected_loader():
  for labels in (True, False):
    kwargs = dict(data_dir='/nonexistent', include_note_labels=labels,
                  loader=_nsynth_examples)
    _assert_streams_equal(
        data.NSynthTfds(**kwargs).get_batch(2, repeats=2,
                                            drop_remainder=False),
        j_data.NSynthTfds(**kwargs).get_batch(2, repeats=2,
                                              drop_remainder=False))
  _assert_streams_equal(
      data.TfdsProvider('x', 'train', loader=_nsynth_examples).get_dataset(),
      j_data.TfdsProvider('x', 'train', loader=_nsynth_examples)
      .get_dataset())
  with pytest.raises(ImportError, match='tensorflow_datasets'):
    next(data.NSynthTfds(data_dir='/nonexistent').get_dataset())


def test_experimental_provider(tmp_path, monkeypatch):
  """A tf.data snapshot read by both packages (the one test that imports
  TensorFlow); without TensorFlow the provider raises a clear error."""
  tf = pytest.importorskip('tensorflow')
  arrays = {'audio': np.random.RandomState(0).randn(4, 100).astype(
      np.float32), 'f0_hz': np.arange(4, dtype=np.float32)}
  snap = str(tmp_path / 'snapshot')
  tf.data.Dataset.from_tensor_slices(arrays).save(snap)
  _assert_streams_equal(
      data.ExperimentalDataProvider(snap).get_batch(2, repeats=1),
      j_data.ExperimentalDataProvider(snap).get_batch(2, repeats=1))
  monkeypatch.setitem(__import__('sys').modules, 'tensorflow', None)
  with pytest.raises(ImportError, match='tensorflow'):
    next(data.ExperimentalDataProvider(snap).get_dataset())


def test_data_package_exports_match_jax():
  """What the JAX data/__init__.py imports, prepare_records included."""
  source = ast.parse(open(j_data.__file__).read())
  names = {alias.asname or alias.name for node in ast.walk(source)
           if isinstance(node, ast.ImportFrom) for alias in node.names}
  assert set(data.__all__) == names
  for name in data.__all__:
    obj = getattr(data, name)
    assert getattr(obj, '__module__', obj.__name__).startswith(
        'ddsp_torch.data.')
