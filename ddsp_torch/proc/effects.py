"""Effects: convolutional reverbs, the LTV-FIR filter and the modulated
delay (port of ddsp_tpu/proc/effects.py)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import wavetable as wavetable_ops
from ddsp_torch.ops.core import torch_float32
from ddsp_torch.ops.fftconv import fft_convolve, frequency_filter
from ddsp_torch.proc.processors import Processor, TensorDict
from ddsp_torch.proc.synths import FilteredNoise, uniform_noise


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


class _NoiseIRReverb(Reverb):
  """A Reverb whose impulse response is drawn from noise: `noise` and
  `generator` go to get_controls, which makes the IR."""

  def forward(self, *args, return_outputs_dict: bool = False,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
    controls = self.get_controls(*args, noise=noise, generator=generator)
    signal = self.get_signal(**controls)
    if return_outputs_dict:
      return dict(signal=signal, controls=controls)
    return signal


class ExpDecayReverb(_NoiseIRReverb):
  """Reverb whose impulse response is an exponentially decaying noise
  burst: scale_fn(gain) * exp(-(2 + exp(decay)) t) * noise, t in [0, 1].

  Trainable, it learns `gain` and `decay`, each [1] (initially 2 and 4);
  otherwise the caller passes them, [batch, 1]. The noise, [1,
  reverb_length], follows FilteredNoise's rule: the `noise` handed to this
  processor, else a draw from the caller's generator, else from a
  generator seeded with 0.
  """

  def __init__(self, trainable: bool = False, reverb_length: int = 48000,
               add_dry: bool = True, scale_fn=ops_core.exp_sigmoid,
               name: Optional[str] = None):
    Processor.__init__(self, name)
    self.trainable = trainable
    self.reverb_length = reverb_length
    self.add_dry = add_dry
    self.scale_fn = scale_fn
    if trainable:
      self.gain = nn.Parameter(torch.empty(1))
      self.decay = nn.Parameter(torch.empty(1))
      self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    del generator
    if self.trainable:
      with torch.no_grad():
        self.gain.fill_(2.0)
        self.decay.fill_(4.0)

  def get_ir(self, gain, decay, noise=None, generator=None) -> torch.Tensor:
    """The decaying noise IR [batch of gain, reverb_length]."""
    gain = self.scale_fn(gain)
    decay_exponent = 2.0 + torch.exp(decay)
    time = torch.linspace(0.0, 1.0, self.reverb_length,
                          device=gain.device)[None, :]
    noise = uniform_noise((1, self.reverb_length), gain.device, noise,
                          generator)
    return gain * torch.exp(-decay_exponent * time) * noise

  def get_controls(self, audio, gain: Optional[torch.Tensor] = None,
                   decay: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None) -> TensorDict:
    """audio [batch, n]; gain, decay [batch, 1] (unused if trainable)."""
    if self.trainable:
      gain, decay = self.gain[None, :], self.decay[None, :]
    elif gain is None or decay is None:
      raise ValueError('Must provide "gain" and "decay" tensors if '
                       'ExpDecayReverb trainable=False.')
    ir = self.get_ir(gain, decay, noise, generator)
    if self.trainable:
      ir = _match_dimensions(audio, ir)
    return {'audio': audio, 'ir': ir}


class FilteredNoiseReverb(_NoiseIRReverb):
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


class FIRFilter(Processor):
  """Linear time-varying FIR filter designed from magnitudes by frequency
  sampling (scale_fn on the magnitudes)."""

  def __init__(self, window_size: int = 257,
               scale_fn=ops_core.exp_sigmoid, name: Optional[str] = None):
    super().__init__(name)
    self.window_size = window_size
    self.scale_fn = scale_fn

  def get_controls(self, audio, magnitudes) -> TensorDict:
    """audio [batch, n]; magnitudes [batch, time, n_filter_banks]."""
    if self.scale_fn is not None:
      magnitudes = self.scale_fn(magnitudes)
    return {'audio': audio, 'magnitudes': magnitudes}

  def get_signal(self, audio, magnitudes) -> torch.Tensor:
    return frequency_filter(audio, magnitudes, window_size=self.window_size)


class ModDelay(Processor):
  """Modulated delay (chorus, flanger, vibrato): a delay of center_ms +-
  depth_ms set by phase, the wet signal times gain, plus the dry one with
  add_dry."""

  def __init__(self, center_ms: float = 15.0, depth_ms: float = 10.0,
               sample_rate: int = 16000,
               gain_scale_fn=ops_core.exp_sigmoid,
               phase_scale_fn=torch.sigmoid, add_dry: bool = True,
               name: Optional[str] = None):
    super().__init__(name)
    self.center_ms = center_ms
    self.depth_ms = depth_ms
    self.sample_rate = sample_rate
    self.gain_scale_fn = gain_scale_fn
    self.phase_scale_fn = phase_scale_fn
    self.add_dry = add_dry

  def get_controls(self, audio, gain, phase) -> TensorDict:
    """audio [b, n]; gain [b, n, 1]; phase (relative delay) [b, n, 1]."""
    if self.gain_scale_fn is not None:
      gain = self.gain_scale_fn(gain)
    if self.phase_scale_fn is not None:
      phase = self.phase_scale_fn(phase)
    return {'audio': audio, 'gain': gain, 'phase': phase}

  def get_signal(self, audio, gain, phase) -> torch.Tensor:
    max_delay_ms = self.center_ms + self.depth_ms
    max_length_samples = int(self.sample_rate / 1000.0 * max_delay_ms)
    depth_phase = self.depth_ms / max_delay_ms
    center_phase = self.center_ms / max_delay_ms
    phase = phase * depth_phase + center_phase
    wet_audio = wavetable_ops.variable_length_delay(
        audio=audio, phase=phase, max_length=max_length_samples)
    if gain.ndim == 3:
      gain = gain[..., 0]
    wet_audio = wet_audio * gain
    return (wet_audio + audio) if self.add_dry else wet_audio
