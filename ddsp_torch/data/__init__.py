"""Data providers and dataset IO (port of ddsp_tpu.data).

Exports what the JAX package's data/__init__.py exports.
"""

from ddsp_torch.data import synthetic_data
from ddsp_torch.data.multi import (BaseMultiProvider, MixedProvider,
                                   SyntheticNotesProvider, Urmp, UrmpMidi,
                                   UrmpMidiUnsegmented, ZippedProvider)
from ddsp_torch.data.prefetch import prefetch_to_device
from ddsp_torch.data.prepare import prepare_records
from ddsp_torch.data.providers import (ArrayDataProvider, DataProvider,
                                       ExperimentalDataProvider,
                                       LegacyTFRecordProvider,
                                       SyntheticSinusoidProvider,
                                       TFRecordProvider)
from ddsp_torch.data.tfds import NSynthTfds, TfdsProvider

__all__ = ['ArrayDataProvider', 'BaseMultiProvider', 'DataProvider',
           'ExperimentalDataProvider', 'LegacyTFRecordProvider',
           'MixedProvider', 'NSynthTfds', 'SyntheticNotesProvider',
           'SyntheticSinusoidProvider', 'TFRecordProvider', 'TfdsProvider',
           'Urmp', 'UrmpMidi', 'UrmpMidiUnsegmented', 'ZippedProvider',
           'prefetch_to_device', 'prepare_records', 'synthetic_data']
