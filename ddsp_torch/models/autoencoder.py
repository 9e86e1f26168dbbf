"""The DDSP Autoencoder (port of ddsp_tpu/models/autoencoder.py, forward).

Dataflow: features -> preprocessor -> [encoder] -> decoder ->
ProcessorGroup -> audio_synth.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ddsp_torch.models.model import Model, TensorDict


class Autoencoder(Model):
  """Preprocessor, optional encoder, decoder and processor group."""

  def __init__(self, preprocessor: Optional[nn.Module] = None,
               encoder: Optional[nn.Module] = None,
               decoder: Optional[nn.Module] = None,
               processor_group: Optional[nn.Module] = None):
    super().__init__()
    self.preprocessor = preprocessor
    self.encoder = encoder
    self.decoder = decoder
    self.processor_group = processor_group

  def encode(self, features: TensorDict) -> TensorDict:
    """Conditioning: preprocess, then encode."""
    features = dict(features)
    if self.preprocessor is not None:
      features.update(self.preprocessor(features))
    if self.encoder is not None:
      features.update(self.encoder(features))
    return features

  def decode(self, features: TensorDict,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> TensorDict:
    """Decoder then processor group.

    Returns the group's outputs dict (per-processor signals and controls,
    under the same keys as the JAX package) plus 'audio_synth'.
    """
    features = dict(features)
    features.update(self.decoder(features))
    pg_out = self.processor_group(features, return_outputs_dict=True,
                                  noise=noise, generator=generator)
    outputs = dict(pg_out['controls'])
    outputs['audio_synth'] = pg_out['signal']
    return outputs

  def forward(self, features: TensorDict,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> TensorDict:
    """Outputs dict for features; noise/generator feed FilteredNoise."""
    return self.decode(self.encode(features), noise=noise,
                       generator=generator)

  def get_audio_from_outputs(self, outputs: TensorDict) -> torch.Tensor:
    return outputs['audio_synth']
