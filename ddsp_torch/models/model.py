"""Model base class (port of ddsp_tpu/models/model.py).

There is no hidden loss state: `model(features, return_losses=True)` returns
`(outputs, losses_dict)` where losses_dict includes 'total_loss'; with
return_losses=False it returns just the outputs dictionary.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

TensorDict = Dict[str, Any]


class Model(nn.Module):
  """Wrap the model function for loss computation and audio extraction."""

  def forward(self, features: TensorDict, training: bool = True,
              return_losses: bool = False, **kwargs):
    """Run the forward pass, optionally adding losses.

    Args:
      features: Input dictionary of tensors.
      training: Run in training mode; it governs network behaviour only
        (losses are computed whenever they are asked for).
      return_losses: Also return a dictionary of scalar losses, including
        'total_loss'.
      **kwargs: Extra kwargs for the forward pass (noise=, generator=).

    Returns:
      outputs, or (outputs, losses_dict) if return_losses.
    """
    outputs, losses_dict = self.forward_with_losses(
        features, training=training, compute_losses=return_losses, **kwargs)
    if return_losses:
      losses_dict = dict(losses_dict)
      losses_dict['total_loss'] = (
          torch.sum(torch.stack(list(losses_dict.values())))
          if losses_dict else 0.0)
      return outputs, losses_dict
    return outputs

  def forward_with_losses(self, features: TensorDict, training: bool = True,
                          compute_losses: bool = True,
                          **kwargs) -> Tuple[TensorDict, TensorDict]:
    """Subclasses return (outputs, losses_dict)."""
    raise NotImplementedError

  def get_audio_from_outputs(self, outputs: TensorDict) -> torch.Tensor:
    """Extract the audio tensor from the outputs dict of forward()."""
    raise NotImplementedError
