"""Convolutional reverbs (port of Reverb and FilteredNoiseReverb in
ddsp_tpu/proc/effects.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops.core import torch_float32
from ddsp_torch.ops.fftconv import fft_convolve
from ddsp_torch.proc.processors import Processor
from ddsp_torch.proc.synths import FilteredNoise


def _mask_dry_ir(ir: torch.Tensor) -> torch.Tensor:
  """Zero the first impulse-response sample to mask the dry signal."""
  if ir.ndim == 1:
    ir = ir[None, :]
  if ir.ndim == 3:
    ir = ir[:, :, 0]
  return torch.cat([ir.new_zeros(ir.shape[0], 1), ir[:, 1:]], dim=1)


def _match_dimensions(audio: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
  """Repeat the impulse response to the audio's batch size."""
  if ir.ndim == 1:
    ir = ir[None, :]
  return ir.expand(int(audio.shape[0]), -1)


class Reverb(Processor):
  """Convolutional (FIR) reverb.

  Attributes:
    trainable: Learn one impulse response `ir` [reverb_length] for the
      whole dataset (else the caller passes `ir`).
    reverb_length: Impulse-response length (trainable only).
    add_dry: Add the dry signal to the reverberated one.
  """

  def __init__(self, trainable: bool = False, reverb_length: int = 48000,
               add_dry: bool = True, name: Optional[str] = None):
    super().__init__(name)
    self.trainable = trainable
    self.reverb_length = reverb_length
    self.add_dry = add_dry
    if trainable:
      self.ir = nn.Parameter(torch.empty(reverb_length))
      self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    if self.trainable:
      with torch.no_grad():
        nn.init.normal_(self.ir, std=1e-6, generator=generator)

  def get_controls(self, audio, ir: Optional[torch.Tensor] = None):
    """audio: dry audio [batch, n_samples]; ir: [batch, ir_size(, 1)]."""
    if self.trainable:
      ir = _match_dimensions(audio, self.ir)
    elif ir is None:
      raise ValueError('Must provide "ir" tensor if Reverb trainable=False.')
    return {'audio': audio, 'ir': ir}

  def get_signal(self, audio, ir) -> torch.Tensor:
    """Reverberated audio [batch, n_samples]."""
    audio = torch_float32(audio)
    ir = _mask_dry_ir(torch_float32(ir))
    if self.trainable:
      # Every row of the controls' IR is the one shared IR: transform it
      # once and broadcast it over the batch in the frequency domain.
      ir = ir[:1]
    wet = fft_convolve(audio, ir, padding='same', delay_compensation=0)
    return (wet + audio) if self.add_dry else wet


class FilteredNoiseReverb(Reverb):
  """Reverb whose impulse response is white noise through a time-varying
  filter (an inner FilteredNoise, `ir_synth`).

  Attributes (besides Reverb's; there is no `ir` parameter):
    window_size: Window size of the noise filter.
    n_frames: Time resolution of `magnitudes` (trainable only).
    n_filter_banks: Frequency resolution of `magnitudes` (trainable only).
    scale_fn: Scale function for the magnitudes.
    initial_bias: Shift of the magnitudes before scale_fn.

  Trainable, it learns `magnitudes` [n_frames, n_filter_banks]. The IR's
  noise, [1, reverb_length], follows FilteredNoise's rule: the `noise`
  handed to this processor (a ProcessorGroup hands it `noise[name]` when
  its noise is a dict), else a draw from the caller's generator, else from
  a generator seeded with 0.
  """

  def __init__(self, trainable: bool = False, reverb_length: int = 48000,
               add_dry: bool = True, window_size: int = 257,
               n_frames: int = 1000, n_filter_banks: int = 16,
               scale_fn=ops_core.exp_sigmoid, initial_bias: float = -3.0,
               name: Optional[str] = None):
    Processor.__init__(self, name)
    self.trainable = trainable
    self.reverb_length = reverb_length
    self.add_dry = add_dry
    self.ir_synth = FilteredNoise(n_samples=reverb_length,
                                  window_size=window_size, scale_fn=scale_fn,
                                  initial_bias=initial_bias, name='ir_synth')
    if trainable:
      self.magnitudes = nn.Parameter(torch.empty(n_frames, n_filter_banks))
      self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    if self.trainable:
      with torch.no_grad():
        nn.init.normal_(self.magnitudes, std=1e-2, generator=generator)

  def forward(self, *args, return_outputs_dict: bool = False,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
    controls = self.get_controls(*args, noise=noise, generator=generator)
    signal = self.get_signal(**controls)
    if return_outputs_dict:
      return dict(signal=signal, controls=controls)
    return signal

  def get_controls(self, audio, magnitudes: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """audio [batch, n]; magnitudes [batch, n_frames, n_filter_banks]
    (unused if trainable); noise, generator: the IR's noise (above)."""
    if self.trainable:
      magnitudes = self.magnitudes[None]
    elif magnitudes is None:
      raise ValueError('Must provide "magnitudes" tensor if '
                       'FilteredNoiseReverb trainable=False.')
    ir = self.ir_synth(magnitudes, noise=noise, generator=generator)
    if self.trainable:
      ir = _match_dimensions(audio, ir)
    return {'audio': audio, 'ir': ir}
