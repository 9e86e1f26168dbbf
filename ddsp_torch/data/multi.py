"""Multi-dataset providers and self-supervised/URMP datasets.

Port of ddsp_tpu/data/multi.py. Reference behavior: magenta/ddsp's
ddsp/training/data.py (BaseMultiProvider:296, ZippedProvider:338,
MixedProvider:386, SyntheticNotes:407, Urmp:450, UrmpMidi:495,
UrmpMidiUnsegmented:557).

Host-side numpy iterators (no tf.data): zipping yields tuples of feature
dicts (what InverseSynthesis.parse_zipped_features consumes), mixing samples
between datasets with given ratios.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ddsp_torch.data import synthetic_data, tfrecord
from ddsp_torch.data.providers import DataProvider
from ddsp_torch.utils.device import DeviceLike


class BaseMultiProvider(DataProvider):
  """Base class for providers that combine multiple datasets."""

  def __init__(self, data_providers: Sequence[DataProvider],
               batch_size_ratios: Sequence[float] = ()):
    if batch_size_ratios:
      if len(batch_size_ratios) != len(data_providers):
        raise ValueError(
            f'List of batch size ratios ({len(batch_size_ratios)}) must '
            f'match the number of data providers ({len(data_providers)}).')
      total = sum(batch_size_ratios)
      batch_size_ratios = [float(b) / total for b in batch_size_ratios]
    else:
      batch_size_ratios = [1.0 for _ in data_providers]

    sample_rates = {dp.sample_rate for dp in data_providers}
    frame_rates = {dp.frame_rate for dp in data_providers}
    assert len(sample_rates) == 1, 'Sample rates must match.'
    assert len(frame_rates) == 1, 'Frame rates must match.'
    super().__init__(sample_rates.pop(), frame_rates.pop())
    self._data_providers = list(data_providers)
    self._batch_size_ratios = list(batch_size_ratios)


class ZippedProvider(BaseMultiProvider):
  """Yields tuples of examples/batches, one element per provider."""

  def get_dataset(self, shuffle: bool = True):
    """One epoch: zip of one epoch per provider (ends at the shortest).

    Finite, so the base get_batch's `repeats` semantics hold (an infinite
    generator here would make repeats=1 consumers loop forever).
    """
    iterators = [iter(dp.get_dataset(shuffle=shuffle))
                 for dp in self._data_providers]
    while True:
      items = []
      for it in iterators:
        try:
          items.append(next(it))
        except StopIteration:
          return
      yield tuple(items)

  def get_batch(self, batch_size: int, shuffle: bool = True,
                repeats: int = -1, drop_remainder: bool = True,
                seed: Optional[int] = None, shard=(0, 1)):
    """Yield tuples of batches; ratios scale the per-provider batch size;
    `shard` keeps each provider's share (DataProvider.get_batch)."""
    batch_sizes = [max(1, int(batch_size * r))
                   for r in self._batch_size_ratios]
    iterators = [dp.get_batch(bs, shuffle=shuffle, repeats=repeats,
                              drop_remainder=drop_remainder, shard=shard)
                 for bs, dp in zip(batch_sizes, self._data_providers)]
    while True:
      # Explicit loop: a StopIteration raised inside a generator
      # expression would become RuntimeError (PEP 479).
      items = []
      for it in iterators:
        try:
          items.append(next(it))
        except StopIteration:
          return
      yield tuple(items)


class MixedProvider(BaseMultiProvider):
  """Samples examples from the providers with the given probabilities."""

  def __init__(self, data_providers, batch_size_ratios=(), seed: int = 0):
    super().__init__(data_providers, batch_size_ratios)
    self._rng = np.random.RandomState(seed)

  def get_dataset(self, shuffle: bool = True):
    """One epoch: ratio-weighted sampling until a provider exhausts.

    Finite (like tf.data sample_from_datasets with
    stop_on_empty_dataset=True), so the base get_batch's `repeats`
    semantics hold AND the realized long-run mix matches
    batch_size_ratios — draining exhausted providers to the end would
    make the mix dataset-size-proportional instead. Zero-ratio providers
    are never sampled.
    """
    iterators = [iter(dp.get_dataset(shuffle=shuffle))
                 for dp in self._data_providers]
    probs = np.asarray(self._batch_size_ratios, np.float64)
    probs = probs / probs.sum()
    while True:
      idx = int(self._rng.choice(len(iterators), p=probs))
      try:
        yield next(iterators[idx])
      except StopIteration:
        return


class SyntheticNotesProvider(DataProvider):
  """Self-supervised control signal for InverseSynthesis.

  Either reads records produced by `generate_synthetic_dataset` (reference
  SyntheticNotes, data.py:407) or, with file_pattern=None, generates
  controls on the fly with synthetic_data.generate_notes_v2, whose torch ops
  run on `device` (CUDA unless the caller passes device='cpu').
  """

  def __init__(self, n_timesteps: int, n_harmonics: int, n_mags: int,
               file_pattern: Optional[str] = None,
               sample_rate: int = 16000, n_examples: int = 64,
               seed: int = 0, device: DeviceLike = None):
    super().__init__(sample_rate, frame_rate=250)
    self.n_timesteps = n_timesteps
    self.n_harmonics = n_harmonics
    self.n_mags = n_mags
    self.n_examples = n_examples
    self._seed = seed
    self._device = device
    if file_pattern:
      self._files = sorted(glob.glob(file_pattern))
      if not self._files:
        raise FileNotFoundError(f'No files match {file_pattern!r}')
    else:
      self._files = None

  def get_dataset(self, shuffle: bool = True):
    if self._files is not None:
      for path in self._files:
        for ex in tfrecord.read_examples(path):
          yield {
              'f0_hz': ex['f0_hz'].reshape(self.n_timesteps, 1),
              'harm_amp': ex['harm_amp'].reshape(self.n_timesteps, 1),
              'harm_dist': ex['harm_dist'].reshape(self.n_timesteps,
                                                   self.n_harmonics),
              'sin_amps': ex['sin_amps'].reshape(self.n_timesteps,
                                                 self.n_harmonics),
              'sin_freqs': ex['sin_freqs'].reshape(self.n_timesteps,
                                                   self.n_harmonics),
              'noise_magnitudes': ex['noise_magnitudes'].reshape(
                  self.n_timesteps, self.n_mags),
          }
    else:
      rng = np.random.RandomState(self._seed)
      for _ in range(self.n_examples):
        controls = synthetic_data.generate_notes_v2(
            n_batch=1, n_timesteps=self.n_timesteps,
            n_harmonics=self.n_harmonics, n_mags=self.n_mags,
            sample_rate=self.sample_rate, random_state=rng,
            device=self._device)
        yield {k: v[0] for k, v in controls.items()}


_URMP_INSTRUMENTS = ['vn', 'va', 'vc', 'db', 'fl', 'ob', 'cl', 'sax', 'bn',
                     'tpt', 'hn', 'tbn', 'tba']


class Urmp(DataProvider):
  """URMP dataset from the reference's TFRecords (solo conditioning).

  Reads the same records as the reference Urmp provider (data.py:450):
  audio/f0_hz/f0_confidence/loudness_db float features.
  """

  def __init__(self, base_dir: str, instrument_key: str = 'tpt',
               split: str = 'train', suffix: Optional[str] = None,
               sample_rate: int = 16000, frame_rate: int = 250,
               seed: int = 0):
    super().__init__(sample_rate, frame_rate)
    self.instrument_key = instrument_key
    self.split = split
    self.base_dir = base_dir
    self.suffix = '' if suffix is None else '_' + suffix
    self._files = sorted(glob.glob(self.default_file_pattern))
    if not self._files:
      raise FileNotFoundError(
          f'No files match {self.default_file_pattern!r}')
    self._rng = np.random.RandomState(seed)

  @property
  def default_file_pattern(self) -> str:
    if self.instrument_key == 'all':
      pattern = f'all_instruments_{self.split}{self.suffix}.tfrecord*'
    else:
      pattern = ('urmp_{}_solo_ddsp_conditioning_{}{}.tfrecord*'.format(
          self.instrument_key, self.split, self.suffix))
    return os.path.join(self.base_dir, pattern)

  def _parse(self, example: Dict[str, Any]) -> Dict[str, Any]:
    return {
        'audio': example['audio'].astype(np.float32),
        'f0_hz': example['f0_hz'].astype(np.float32),
        'f0_confidence': example['f0_confidence'].astype(np.float32),
        'loudness_db': example['loudness_db'].astype(np.float32),
    }

  def get_dataset(self, shuffle: bool = True):
    files = list(self._files)
    if shuffle:
      self._rng.shuffle(files)
    for path in files:
      for example in tfrecord.read_examples(path):
        yield self._parse(example)


class UrmpMidi(Urmp):
  """URMP (segmented, 4 s) with MIDI note data for the MidiAutoencoder.

  Adds reshaped pianoroll features (reference data.py:495-554):
  note_active_velocities / note_active_frame_indices [time, 128], integer
  instrument_id, quantized 'midi' track, binary onsets/offsets.
  """

  def _parse(self, example: Dict[str, Any]) -> Dict[str, Any]:
    data = super()._parse(example)
    velocities = example['note_active_velocities'].astype(
        np.float32).reshape(-1, 128)
    frame_idx = example['note_active_frame_indices'].astype(
        np.float32).reshape(-1, 128)
    instrument = example['instrument_id']
    if isinstance(instrument, (list, tuple)):
      instrument = instrument[0]
    if isinstance(instrument, bytes):
      instrument = instrument.decode()
    inst_id = (_URMP_INSTRUMENTS.index(instrument)
               if instrument in _URMP_INSTRUMENTS else -1)

    data.update({
        'note_active_velocities': velocities,
        'note_active_frame_indices': frame_idx,
        'instrument_id': np.asarray(inst_id, np.int32),
        'midi': np.argmax(frame_idx, axis=-1).astype(np.int64),
        'f0_hz': data['f0_hz'][..., np.newaxis],
        'loudness_db': data['loudness_db'][..., np.newaxis],
    })
    if 'power_db' in example:
      data['power_db'] = example['power_db'].astype(np.float32)
    for key, out in [('note_onsets', 'onsets'),
                     ('note_offsets', 'offsets')]:
      if key in example:
        marks = example[key].astype(np.float32).reshape(-1, 128)
        data[out] = (marks.sum(axis=-1) > 0).astype(np.int64)
    return data


class UrmpMidiUnsegmented(UrmpMidi):
  """URMP full-piece (unsegmented) records; same per-example transform.

  The reference uses VarLen (sparse) features here; the pure-Python parser
  already yields variable-length float lists, so parsing is identical.
  """
