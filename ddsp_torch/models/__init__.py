"""Models (port of ddsp_tpu.models)."""

from ddsp_torch.models.autoencoder import Autoencoder
from ddsp_torch.models.midi_autoencoder import (MarginLoss, MidiAutoencoder,
                                                SlownessLoss,
                                                ZMidiAutoencoder)
from ddsp_torch.models.model import Model

__all__ = ['Autoencoder', 'MarginLoss', 'MidiAutoencoder', 'Model',
           'SlownessLoss', 'ZMidiAutoencoder']
