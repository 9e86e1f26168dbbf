"""Model base class (port of ddsp_tpu/models/model.py, forward only).

Losses belong to the training slice of the port; the serving path calls a
model for its outputs dictionary alone.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

TensorDict = Dict[str, Any]


class Model(nn.Module):
  """Forward pass from a features dict to an outputs dict."""

  def get_audio_from_outputs(self, outputs: TensorDict) -> torch.Tensor:
    """Extract the audio tensor from the outputs dict of forward()."""
    raise NotImplementedError
