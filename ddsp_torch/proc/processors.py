"""Processor base class, ProcessorGroup, and the Add, Mix and Crop
processors.

Port of ddsp_tpu/proc/processors.py. A Processor turns network outputs into
controls (`get_controls`) and controls into a signal (`get_signal`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ddsp_torch.ops.resample import resample
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


class Mix(Processor):
  """Constant-power crossfade between two signals of the same length."""

  def get_controls(self, signal_one, signal_two,
                   nn_out_mix_level) -> TensorDict:
    """nn_out_mix_level [batch, frames, 1]: the raw balance, squashed by a
    sigmoid and resampled to the signals' length."""
    n_time_one = int(signal_one.shape[1])
    n_time_two = int(signal_two.shape[1])
    if n_time_one != n_time_two:
      raise ValueError(f'Mix needs equal-length signals; got {n_time_one} '
                       f'vs {n_time_two} samples.')
    mix_level = resample(torch.sigmoid(nn_out_mix_level), n_time_one)
    # A [batch, n, 1] level against [batch, n] signals: drop the channel
    # axis (it would broadcast to [batch, n, n]).
    if mix_level.ndim == signal_one.ndim + 1:
      mix_level = mix_level[..., 0]
    return {'signal_one': signal_one, 'signal_two': signal_two,
            'mix_level': mix_level}

  def get_signal(self, signal_one, signal_two, mix_level) -> torch.Tensor:
    mix_level_one = torch.sqrt(torch.abs(mix_level))
    mix_level_two = 1.0 - torch.sqrt(torch.abs(mix_level - 1.0))
    return mix_level_one * signal_one + mix_level_two * signal_two


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
