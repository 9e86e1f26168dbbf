"""Processor base class, ProcessorGroup, and the Add and Crop processors.

Port of ddsp_tpu/proc/processors.py. A Processor turns network outputs into
controls (`get_controls`) and controls into a signal (`get_signal`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ddsp_torch.proc.dags import DAGModule

TensorDict = Dict[str, Any]


class Processor(nn.Module):
  """Abstract base class for signal processors.

  `noise` / `generator` are handed to every processor of a group; only
  noise processors read them (see `render`).
  """

  def __init__(self, name: Optional[str] = None):
    super().__init__()
    self.name = name

  def forward(self, *args, return_outputs_dict: bool = False,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
    controls = self.get_controls(*args)
    signal = self.render(controls, noise=noise, generator=generator)
    if return_outputs_dict:
      return dict(signal=signal, controls=controls)
    return signal

  def render(self, controls: TensorDict, noise=None, generator=None):
    """Signal from controls; processors that draw noise override this."""
    del noise, generator
    return self.get_signal(**controls)

  def get_controls(self, *args) -> TensorDict:
    raise NotImplementedError

  def get_signal(self, *args, **kwargs) -> torch.Tensor:
    raise NotImplementedError


class ProcessorGroup(DAGModule):
  """A DAG of processors; the final node's signal is the group output."""

  def forward(self, inputs: TensorDict, return_outputs_dict: bool = False,
              **kwargs):
    controls = self.get_controls(inputs, **kwargs)
    signal = self.get_signal(controls)
    if return_outputs_dict:
      return dict(signal=signal, controls=controls)
    return signal

  def get_controls(self, inputs: TensorDict, **kwargs) -> TensorDict:
    """Run the DAG and return the complete nested outputs dictionary."""
    return self.run_dag(inputs, **kwargs)

  def get_signal(self, outputs: TensorDict) -> torch.Tensor:
    return outputs['out']['signal']


class Add(Processor):
  """Sum two signals."""

  def get_controls(self, signal_one, signal_two) -> TensorDict:
    return {'signal_one': signal_one, 'signal_two': signal_two}

  def get_signal(self, signal_one, signal_two) -> torch.Tensor:
    return signal_one + signal_two


class Crop(Processor):
  """Trim the samples that padded frames added, from one or both ends.

  One frame_size of samples goes in total: all from the start ('front'),
  all from the end ('back'), or half from each ('center', the two
  half-frames of centered framing, rounded down for odd sizes).
  """

  def __init__(self, frame_size: int = 1024, crop_location: str = 'back',
               name: Optional[str] = None):
    super().__init__(name)
    self.frame_size = frame_size
    self.crop_location = crop_location

  def get_controls(self, audio) -> TensorDict:
    return {'audio': audio}

  def get_signal(self, audio) -> torch.Tensor:
    half = int(self.frame_size // 2)
    if self.crop_location == 'front':
      return audio[:, 2 * half:]
    if self.crop_location == 'center':
      return audio[:, half:-half]
    if self.crop_location == 'back':
      return audio[:, :-2 * half]
    raise ValueError(f'Unknown crop_location {self.crop_location!r}; '
                     "expected 'front', 'center', or 'back'.")
