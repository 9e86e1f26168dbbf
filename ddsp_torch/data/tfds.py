"""TFDS-backed data providers (NSynth et al.), as numpy feature dicts.

Port of ddsp_tpu/data/tfds.py. Reference behavior: magenta/ddsp's
ddsp/training/data.py:102-204
(`TfdsProvider`, `NSynthTfds` with its feature remap). The reference
returns a tf.data pipeline; here TFDS is consumed with
`tfds.as_numpy` on the host and examples flow through the same numpy
DataProvider protocol as every other provider (the training loop moves
each batch to the device).

`tensorflow_datasets` is an optional dependency: constructing a provider
is always safe, and a clear ImportError is raised only when a dataset is
actually requested without tfds installed. A `loader` callable can be
injected for tests (or any custom numpy example source).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Iterable, Iterator, Optional

import numpy as np

from ddsp_torch.data.providers import DataProvider

_PUBLIC_TFDS_BUCKET = 'gs://tfds-data/datasets'


def _default_loader(name: str, split: str, data_dir: Optional[str],
                    shuffle: bool) -> Iterable[Dict[str, Any]]:
  """Load a TFDS dataset and iterate it as numpy dicts."""
  try:
    import tensorflow_datasets as tfds  # pylint: disable=g-import-not-at-top
  except ImportError as e:
    raise ImportError(
        'TfdsProvider requires the `tensorflow_datasets` package. Install '
        'it (pip install tensorflow_datasets), or pass a `loader` callable '
        'yielding numpy example dicts.') from e
  ds = tfds.load(name, data_dir=data_dir, split=split,
                 shuffle_files=shuffle, download=False)
  if shuffle:
    ds = ds.shuffle(1024)
  return tfds.as_numpy(ds)


class TfdsProvider(DataProvider):
  """Reads examples from TensorFlow Datasets (TFDS) as numpy dicts.

  Args:
    name: TFDS dataset name (with optional config and version).
    split: Dataset split to use.
    data_dir: Directory to read prepared TFDS datasets from.
    sample_rate: Sample rate of audio in the dataset.
    frame_rate: Frame rate of features in the dataset.
    loader: Optional callable `(name, split, data_dir, shuffle) ->
      iterable of numpy example dicts`; defaults to tfds.load +
      tfds.as_numpy. Inject for tests or custom sources.
  """

  def __init__(self,
               name: str,
               split: str,
               data_dir: Optional[str] = None,
               sample_rate: int = 16000,
               frame_rate: int = 250,
               loader: Optional[Callable[..., Iterable[Dict[str, Any]]]]
               = None):
    super().__init__(sample_rate, frame_rate)
    self._name = name
    self._split = split
    self._data_dir = data_dir
    self._loader = loader or _default_loader

  def get_dataset(self, shuffle: bool = True) -> Iterator[Dict[str, Any]]:
    for example in self._loader(self._name, self._split, self._data_dir,
                                shuffle):
      yield example


class NSynthTfds(TfdsProvider):
  """The NSynth dataset (gansynth subset with f0/loudness annotations).

  Feature remap per the reference (data.py:175-197): nested
  `f0/{hz,confidence}` and `loudness/db` flatten to the canonical
  `f0_hz` / `f0_confidence` / `loudness_db` keys; note-level labels
  (pitch, instrument source/family/label) are carried along when
  `include_note_labels` so the OneHotEncoder / conditioning paths can
  consume them. This feeds the ICLR2020 nsynth_ae experiment
  (reference gin/papers/iclr2020/nsynth_ae.gin).
  """

  def __init__(self,
               name: str = 'nsynth/gansynth_subset.f0_and_loudness:2.3.0',
               split: str = 'train',
               data_dir: str = _PUBLIC_TFDS_BUCKET,
               sample_rate: int = 16000,
               frame_rate: int = 250,
               include_note_labels: bool = True,
               loader: Optional[Callable[..., Iterable[Dict[str, Any]]]]
               = None):
    if data_dir == _PUBLIC_TFDS_BUCKET:
      logging.warning(
          'Using the public TFDS GCS bucket to load NSynth. If not running '
          'on GCP this will be very slow; prepare the dataset locally with '
          'TFDS and set data_dir appropriately.')
    super().__init__(name, split, data_dir, sample_rate, frame_rate,
                     loader=loader)
    self._include_note_labels = include_note_labels

  def get_dataset(self, shuffle: bool = True) -> Iterator[Dict[str, Any]]:
    for ex in super().get_dataset(shuffle):
      out = {
          'audio': np.asarray(ex['audio'], np.float32),
          'f0_hz': np.asarray(ex['f0']['hz'], np.float32),
          'f0_confidence': np.asarray(ex['f0']['confidence'], np.float32),
          'loudness_db': np.asarray(ex['loudness']['db'], np.float32),
      }
      if self._include_note_labels:
        out.update({
            'pitch': np.asarray(ex['pitch']),
            'instrument_source': np.asarray(ex['instrument']['source']),
            'instrument_family': np.asarray(ex['instrument']['family']),
            'instrument': np.asarray(ex['instrument']['label']),
        })
      yield out
