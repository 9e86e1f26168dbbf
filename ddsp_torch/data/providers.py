"""Data providers: host-side numpy iterators of feature dicts.

Port of ddsp_tpu/data/providers.py. Reference behavior:
magenta/ddsp's ddsp/training/data.py (DataProvider:58, TFRecordProvider:205).
Plain numpy iterators with no tf.data dependency; the training loop moves
each batch to the device (train(prefetch=...) through
ddsp_torch.data.prefetch). The feature schema matches the reference so
existing DDSP datasets work: audio [n_samples], f0_hz / f0_confidence /
loudness_db [n_frames]. Every provider draws from np.random.RandomState in
the JAX package's order, so the same seed gives the same batches bit for bit.

Across processes the JAX providers give every process the same examples
(they seed by `seed` alone, and the JAX CLI feeds each host's batch as its
rows of the global one). The port's `get_batch(shard=(index, count))`
keeps examples index, index + count, ... of that same stream instead, so
the ranks of a mesh's data rows read disjoint examples: a deliberate
difference (ROADMAP.md).
"""

from __future__ import annotations

import glob
import itertools
import logging
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from ddsp_torch.data import tfrecord
from ddsp_torch.ops.spectral import get_framed_lengths


class DataProvider:
  """Base class for returning batch iterators of feature dicts."""

  def __init__(self, sample_rate: int = 16000, frame_rate: int = 250):
    self._sample_rate = sample_rate
    self._frame_rate = frame_rate

  @property
  def sample_rate(self) -> int:
    return self._sample_rate

  @property
  def frame_rate(self) -> int:
    return self._frame_rate

  def get_dataset(self, shuffle: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield single examples (numpy feature dicts)."""
    raise NotImplementedError

  def get_batch(self,
                batch_size: int,
                shuffle: bool = True,
                repeats: int = -1,
                drop_remainder: bool = True,
                seed: Optional[int] = None,
                shard: Tuple[int, int] = (0, 1)
                ) -> Iterator[Dict[str, Any]]:
    """Yield batched feature dicts (numpy, stacked along axis 0).

    shard: (index, count): batch examples index, index + count, ... of
    each epoch only (a rank's share of the data, module docstring).
    """
    index, count = shard
    if not 0 <= index < count:
      raise ValueError(f'shard {shard} is not (index, count) with 0 <= '
                       'index < count.')
    if seed is not None:
      logging.getLogger('ddsp_torch').warning(
          'get_batch(seed=...) is accepted for API parity but ignored; '
          'seed shuffling at provider construction time instead.')
    epoch = 0
    buffer = []
    while repeats < 0 or epoch < repeats:
      for example in itertools.islice(self.get_dataset(shuffle=shuffle),
                                      index, None, count):
        buffer.append(example)
        if len(buffer) == batch_size:
          yield _stack(buffer)
          buffer = []
      epoch += 1
      if not drop_remainder and buffer:
        yield _stack(buffer)
        buffer = []


def _stack(examples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
  keys = examples[0].keys()
  return {k: np.stack([np.asarray(e[k]) for e in examples]) for k in keys}


class ArrayDataProvider(DataProvider):
  """Provider over an in-memory list of examples (or dict of arrays)."""

  def __init__(self, examples, sample_rate: int = 16000,
               frame_rate: int = 250, seed: int = 0):
    super().__init__(sample_rate, frame_rate)
    if isinstance(examples, dict):
      n = len(next(iter(examples.values())))
      examples = [{k: v[i] for k, v in examples.items()} for i in range(n)]
    self._examples = list(examples)
    self._rng = np.random.RandomState(seed)

  def get_dataset(self, shuffle: bool = True):
    order = np.arange(len(self._examples))
    if shuffle:
      self._rng.shuffle(order)
    for i in order:
      yield self._examples[i]


class SyntheticSinusoidProvider(DataProvider):
  """Random harmonic notes with exact (f0, loudness) labels.

  Generates what the reference's `gen_np_sinusoid` test fixture provides
  (reference test_util.py:20-32) plus loudness labels, so a full
  autoencoder can be trained end-to-end with zero external data. Useful for
  tests and benchmarks.
  """

  def __init__(self,
               n_samples: int = 64000,
               sample_rate: int = 16000,
               frame_rate: int = 250,
               n_examples: int = 64,
               f0_range=(80.0, 600.0),
               seed: int = 0):
    super().__init__(sample_rate, frame_rate)
    self.n_samples = n_samples
    self.n_examples = n_examples
    self.f0_range = f0_range
    # 'center'-padded framing like the reference TFRecord features
    # (n_frames = n_samples / hop + 1).
    hop = sample_rate // frame_rate
    self.n_frames = get_framed_lengths(n_samples, hop, hop, 'center')[0]
    self._seed = seed
    # Epoch-order RNG persists across get_dataset calls so shuffle=True
    # yields a different order every epoch (content stays seed-determined).
    self._order_rng = np.random.RandomState(seed + 1)
    self._cache = None

  def get_dataset(self, shuffle: bool = True):
    if self._cache is None:
      rng = np.random.RandomState(self._seed)
      self._cache = [self._make_example(rng)
                     for _ in range(self.n_examples)]
    order = np.arange(self.n_examples)
    if shuffle:
      self._order_rng.shuffle(order)
    for i in order:
      yield self._cache[i]

  def _make_example(self, rng) -> Dict[str, np.ndarray]:
    sr, n = self.sample_rate, self.n_samples
    lo, hi = self.f0_range
    # Random gliding f0 and amplitude envelope.
    f0 = np.exp(np.linspace(np.log(rng.uniform(lo, hi)),
                            np.log(rng.uniform(lo, hi)), n))
    amp = rng.uniform(0.2, 0.9) * np.hanning(n) ** 0.25
    n_harmonics = rng.randint(1, 10)
    t_phase = np.cumsum(2 * np.pi * f0 / sr)
    audio = np.zeros(n)
    weights = rng.dirichlet(np.ones(n_harmonics))
    for h in range(n_harmonics):
      harmonic = (h + 1) * f0
      mask = harmonic < sr / 2
      audio += weights[h] * np.sin((h + 1) * t_phase) * mask
    audio = (amp * audio).astype(np.float32)

    hop = sr // self.frame_rate
    idx = np.minimum(np.arange(self.n_frames) * hop, n - 1)
    f0_frames = f0[idx].astype(np.float32)
    # Loudness label computed by the preprocessor in-graph by default; a
    # crude dB estimate keeps the dataset self-contained when it is not.
    rms = np.sqrt(np.convolve(audio**2, np.ones(hop) / hop, 'same')[idx])
    loudness_db = (20 * np.log10(np.maximum(rms, 1e-7))).astype(np.float32)

    return {
        'audio': audio,
        'f0_hz': f0_frames,
        'f0_confidence': np.ones_like(f0_frames),
        'loudness_db': loudness_db,
    }


class TFRecordProvider(DataProvider):
  """Reads the reference's TFRecord datasets with a pure-Python parser.

  Feature schema (reference data.py:221-270): audio [n_samples], f0_hz,
  f0_confidence, loudness_db [n_frames] as float lists in tf.Example
  protos. No TensorFlow dependency: TFRecord framing and the Example proto
  wire format are parsed directly (see ddsp_torch.data.tfrecord).
  """

  def __init__(self,
               file_pattern: str,
               example_secs: float = 4,
               sample_rate: int = 16000,
               frame_rate: int = 250,
               centered: bool = True,
               seed: int = 0):
    super().__init__(sample_rate, frame_rate)
    self._files = sorted(glob.glob(file_pattern))
    if not self._files:
      raise FileNotFoundError(f'No files match {file_pattern!r}')
    self.example_secs = example_secs
    # float seconds keep fractional geometries exact (2.5 s @ 16 kHz).
    self.n_samples = int(round(example_secs * sample_rate))
    hop = sample_rate // frame_rate
    self.n_frames = get_framed_lengths(self.n_samples, hop, hop,
                                       'center' if centered else 'valid')[0]
    self._rng = np.random.RandomState(seed)
    self._include_audio_16k = True

  def get_dataset(self, shuffle: bool = True, shuffle_buffer: int = 1024):
    files = list(self._files)
    if shuffle:
      self._rng.shuffle(files)

    def parse(example):
      out = {
          'audio': example['audio'].astype(np.float32),
          'f0_hz': example['f0_hz'].astype(np.float32),
          'f0_confidence': example['f0_confidence'].astype(np.float32),
          'loudness_db': example['loudness_db'].astype(np.float32),
      }
      # The reference's modern records carry a 16 kHz copy for CREPE
      # (reference data.py:244-246); pass it through when present.
      if self._include_audio_16k and 'audio_16k' in example:
        out['audio_16k'] = example['audio_16k'].astype(np.float32)
      return out

    if not shuffle:
      for path in files:
        for example in tfrecord.read_examples(path):
          yield parse(example)
      return

    # Example-level shuffling via a reservoir buffer (tf.data
    # dataset.shuffle(buffer) semantics): file order alone would repeat
    # identical batches every epoch for single-file datasets.
    buffer = []
    for path in files:
      for example in tfrecord.read_examples(path):
        buffer.append(example)
        if len(buffer) >= shuffle_buffer:
          idx = self._rng.randint(len(buffer))
          buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
          yield parse(buffer.pop())
    self._rng.shuffle(buffer)
    for example in buffer:
      yield parse(example)


class LegacyTFRecordProvider(TFRecordProvider):
  """Old-schema TFRecords without the 16 kHz audio copy.

  Reference data.py:274 (`LegacyTFRecordProvider`): identical to
  TFRecordProvider but the records carry only
  audio/f0_hz/f0_confidence/loudness_db.
  """

  def __init__(self, *args, **kwargs):
    super().__init__(*args, **kwargs)
    self._include_audio_16k = False


class ExperimentalDataProvider(DataProvider):
  """Reads datasets saved with tf.data.Dataset.save().

  Reference data.py:82 (`ExperimentalDataProvider`, the
  tf.data.experimental.save/load interface). The snapshot format is
  TensorFlow-internal, so this provider requires the `tensorflow` package
  (import gated: constructing is safe, iterating raises a clear error
  without TF) and iterates the loaded dataset as numpy.
  """

  def __init__(self, data_dir: str, sample_rate: int = 16000,
               frame_rate: int = 250):
    super().__init__(sample_rate, frame_rate)
    self.data_dir = data_dir

  def get_dataset(self, shuffle: bool = True):
    del shuffle  # Element order comes from the saved snapshot.
    try:
      import tensorflow as tf  # pylint: disable=g-import-not-at-top
    except ImportError as e:
      raise ImportError(
          'ExperimentalDataProvider reads tf.data snapshot directories '
          'and requires the `tensorflow` package.') from e
    ds = tf.data.Dataset.load(self.data_dir)
    for example in ds.as_numpy_iterator():
      yield example
