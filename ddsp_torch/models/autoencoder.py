"""The DDSP Autoencoder (port of ddsp_tpu/models/autoencoder.py).

Dataflow: features -> preprocessor -> [encoder] -> decoder ->
ProcessorGroup -> audio_synth; losses compare (features['audio'],
audio_synth).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.models.model import Model, TensorDict
from ddsp_torch.proc.dags import loss_module_name


class Autoencoder(Model):
  """Preprocessor, optional encoder, decoder, processor group and losses.

  `training` is accepted where the JAX modules take it; no module of this
  model behaves differently under it.
  """

  def __init__(self, preprocessor: Optional[nn.Module] = None,
               encoder: Optional[nn.Module] = None,
               decoder: Optional[nn.Module] = None,
               processor_group: Optional[nn.Module] = None,
               losses: Sequence[nn.Module] = ()):
    super().__init__()
    self.preprocessor = preprocessor
    self.encoder = encoder
    self.decoder = decoder
    self.processor_group = processor_group
    self.losses = nn.ModuleList(losses)

  def encode(self, features: TensorDict, training: bool = True) -> TensorDict:
    """Conditioning: preprocess, then encode."""
    del training
    features = dict(features)
    if self.preprocessor is not None:
      features.update(self.preprocessor(features))
    if self.encoder is not None:
      features.update(self.encoder(features))
    return features

  def decode(self, features: TensorDict, training: bool = True,
             noise: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> TensorDict:
    """Decoder then processor group.

    Returns the group's outputs dict (per-processor signals and controls,
    under the same keys as the JAX package) plus 'audio_synth'.
    """
    del training
    features = dict(features)
    features.update(self.decoder(features))
    pg_out = self.processor_group(features, return_outputs_dict=True,
                                  noise=noise, generator=generator)
    outputs = dict(pg_out['controls'])
    outputs['audio_synth'] = pg_out['signal']
    return outputs

  def forward_with_losses(self, features: TensorDict, training: bool = True,
                          compute_losses: bool = True,
                          noise: Optional[torch.Tensor] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[TensorDict, TensorDict]:
    """Predictions and losses; noise/generator feed FilteredNoise."""
    features = self.encode(features, training=training)
    outputs = self.decode(features, training=training, noise=noise,
                          generator=generator)
    losses_dict = {}
    if compute_losses:
      for loss_obj in self.losses:
        name = loss_module_name(loss_obj)
        while name in losses_dict:
          name += '_'
        losses_dict[name] = loss_obj(features['audio'],
                                     outputs['audio_synth'])
    return outputs, losses_dict

  def get_audio_from_outputs(self, outputs: TensorDict) -> torch.Tensor:
    return outputs['audio_synth']
