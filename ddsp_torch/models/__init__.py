"""Models (port of ddsp_tpu.models)."""

from ddsp_torch.models.autoencoder import Autoencoder
from ddsp_torch.models.inverse_synthesis import InverseSynthesis
from ddsp_torch.models.midi_autoencoder import (MarginLoss, MidiAutoencoder,
                                                SlownessLoss,
                                                ZMidiAutoencoder)
from ddsp_torch.models.model import Model

__all__ = ['Autoencoder', 'InverseSynthesis', 'MarginLoss',
           'MidiAutoencoder', 'Model', 'SlownessLoss', 'ZMidiAutoencoder']
