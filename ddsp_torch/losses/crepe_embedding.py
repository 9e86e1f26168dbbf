"""Perceptual embedding loss on frozen CREPE activations.

Port of ddsp_tpu/losses/crepe_embedding.py (EmbeddingLoss,
PretrainedCREPEEmbeddingLoss): the L1 distance between a frozen CREPE
layer's activations of the target and the synthesized audio, with the
reference's per-layer scale table.

The CREPE network is no submodule of the loss: its weights appear in no
model's parameters, state dict or optimizer, and `build_model(seed=...)`
re-draws none of them. It is built once per (weights file, capacity,
layer) and device and kept in a module-level cache, as the JAX package
caches the frozen variables. Weights come from model-<capacity>.npz (or
.h5) in $CREPE_WEIGHTS_DIR or the repository's assets/crepe, which commits
the tiny model's; a capacity with no weights file raises, naming the file.
(The JAX loss runs a randomly initialized CREPE when it is given no
weights_path; tests carry such variables across with
ops/crepe.py load_variables on `crepe_model(device)`.)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ddsp_torch.losses.spectral import Loss, mean_difference
from ddsp_torch.ops.core import full_float32
from ddsp_torch.ops.crepe import (CrepeModel, default_weights_path,
                                  load_variables, load_weights)

# The scale of each activation layer, to comparable loss magnitudes
# (reference losses.py:399-413).
_LAYER_SCALES = {
    'conv1-BN': 1.3, 'conv1-maxpool': 1.0,
    'conv2-BN': 1.4, 'conv2-maxpool': 1.1,
    'conv3-BN': 1.9, 'conv3-maxpool': 1.6,
    'conv4-BN': 1.5, 'conv4-maxpool': 1.4,
    'conv5-BN': 1.9, 'conv5-maxpool': 1.7,
    'conv6-BN': 30, 'conv6-maxpool': 25,
    'classifier': 130,
}

_CREPE_CACHE: Dict[Tuple[str, str, str, str], CrepeModel] = {}


def frozen_crepe(weights_path: str, model_capacity: str,
                 activation_layer: str,
                 device: torch.device) -> CrepeModel:
  """The frozen CREPE of these weights and layer on `device` (cached)."""
  key = (weights_path, model_capacity, activation_layer, str(device))
  if key not in _CREPE_CACHE:
    model = CrepeModel(model_capacity=model_capacity,
                       activation_layer=activation_layer)
    load_variables(model, load_weights(weights_path, model_capacity))
    _CREPE_CACHE[key] = model.requires_grad_(False).eval().to(device)
  return _CREPE_CACHE[key]


class EmbeddingLoss(Loss):
  """Perceptual loss on the activations of a frozen pretrained model.

  Subclasses provide `_embedding(audio) -> [batch, frames, depth]`; the
  loss is weight * scale * mean_difference between the target's embedding
  (detached) and the synthesized audio's.

  Attributes:
    weight: Loss weight.
    loss_type: Distance type ('L1', 'L2', 'COSINE').
    scale: Extra multiplier applied on top of weight (layer balancing).
  """

  def __init__(self, weight: float = 1.0, loss_type: str = 'L1',
               scale: float = 1.0, name: Optional[str] = None):
    super().__init__(name)
    self.weight = weight
    self.loss_type = loss_type
    self.scale = scale

  def _embedding(self, audio: torch.Tensor) -> torch.Tensor:
    raise NotImplementedError

  def forward(self, target_audio: torch.Tensor,
              audio: torch.Tensor) -> torch.Tensor:
    loss = torch.zeros((), device=audio.device)
    if self.weight > 0.0:
      target_emb = self._embedding(target_audio).detach()
      synth_emb = self._embedding(audio)
      loss = (self.scale * self.weight *
              mean_difference(target_emb, synth_emb, self.loss_type))
    return loss


class PretrainedCREPEEmbeddingLoss(EmbeddingLoss):
  """L1 loss between frozen-CREPE activations of two audio signals.

  Attributes:
    weight: Base loss weight (scaled by 20 x the layer's scale, as in the
      reference).
    loss_type: Distance type.
    model_capacity: CREPE size ('tiny' by default).
    activation_layer: Which layer's activations to compare.
    weights_path: A CREPE .npz or .h5; None takes
      ops/crepe.py default_weights_path(model_capacity), and raises
      FileNotFoundError where there is none.
  """

  def __init__(self, weight: float = 1.0, loss_type: str = 'L1',
               model_capacity: str = 'tiny',
               activation_layer: str = 'classifier',
               weights_path: Optional[str] = None,
               name: Optional[str] = None, scale: float = 1.0):
    # `scale` is EmbeddingLoss's field, which the JAX class takes and then
    # replaces by 20 x the layer's scale, as here.
    del scale
    if activation_layer not in _LAYER_SCALES:
      raise ValueError(
          f'activation layer {activation_layer} not found, valid names are '
          f'{sorted(_LAYER_SCALES)}')
    # 20x base scaling plus the per-layer balance factor (losses.py:398).
    super().__init__(weight=weight, loss_type=loss_type,
                     scale=20.0 * _LAYER_SCALES[activation_layer], name=name)
    self.model_capacity = model_capacity
    self.activation_layer = activation_layer
    if weights_path is None:
      weights_path = default_weights_path(model_capacity)
      if weights_path is None:
        raise FileNotFoundError(
            f'PretrainedCREPEEmbeddingLoss: no weights for CREPE '
            f'{model_capacity!r}: model-{model_capacity}.npz (or .h5) is '
            'in neither $CREPE_WEIGHTS_DIR nor assets/crepe; the repository '
            "commits only 'tiny'. Pass weights_path.")
    self.weights_path = weights_path

  def crepe_model(self, device) -> CrepeModel:
    """The frozen CREPE this loss runs on `device`."""
    return frozen_crepe(self.weights_path, self.model_capacity,
                        self.activation_layer, torch.device(device))

  def _embedding(self, audio: torch.Tensor) -> torch.Tensor:
    """[batch, n] audio (n divisible by 1024) -> [batch, frames, depth]."""
    frame_length = hop_length = 1024
    # Frames centered on their timestamps.
    pad = frame_length // 2
    audio = torch.nn.functional.pad(audio, (pad, pad))
    frames = audio.unfold(-1, frame_length, hop_length)
    # The per-frame normalization CREPE expects.
    mean = torch.mean(frames, dim=-1, keepdim=True)
    var = torch.var(frames, dim=-1, keepdim=True, correction=0)
    frames = (frames - mean) / (var**0.5 + 1e-5)
    batch_size, n_frames = frames.shape[0], frames.shape[1]
    with full_float32():
      acts = self.crepe_model(audio.device)(frames.reshape(-1, frame_length))
    return acts.reshape(batch_size, n_frames, -1)
