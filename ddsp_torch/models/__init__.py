"""Models (port of ddsp_tpu.models)."""

from ddsp_torch.models.autoencoder import Autoencoder
from ddsp_torch.models.model import Model

__all__ = ['Autoencoder', 'Model']
