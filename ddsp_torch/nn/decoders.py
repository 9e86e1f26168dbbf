"""Decoders: conditioning features -> synthesizer controls.

Port of ddsp_tpu/nn/decoders.py: RnnFcDecoder (stateful, and stateless for
streaming), FcStackDecoder, MidiDecoder, MidiToHarmonicDecoder and
DilatedConvDecoder. Widths flax infers at the first call (a net's output,
the inputs' channels) are constructor arguments here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.nn import layers as nn_layers
from ddsp_torch.nn.dilated_conv import DilatedConvStack
from ddsp_torch.ops import core as ops_core


class RnnFcDecoder(nn_layers.DictModule):
  """Per-input FC stacks -> GRU -> FC stack -> float32 dense -> controls.

  Attributes:
    rnn_channels: GRU width.
    rnn_type: 'gru' (the only type ported).
    ch: Width of the fully connected layers.
    layers_per_stack: FC layers per stack.
    stateless: Pass the GRU state in and out explicitly (streaming
      inference): adds 'state' [batch, rnn_channels] to the input and
      output keys.
    input_keys: One FC stack is created per input.
    input_dims: Channels of each input (1 each by default: the scaled f0
      and loudness; give z's width where 'z' is an input).
    output_splits: (name, n_channels) pairs the dense head is split into.
    compute_dtype: 'bfloat16' or 'float32' for the stacks and the GRU; the
      head is always float32.
  """

  def __init__(self, rnn_channels: int = 512, rnn_type: str = 'gru',
               ch: int = 512, layers_per_stack: int = 3,
               stateless: bool = False,
               input_keys: Tuple[str, ...] = ('ld_scaled', 'f0_scaled', 'z'),
               input_dims: Optional[Sequence[int]] = None,
               output_splits: Tuple[Tuple[str, int], ...] = (
                   ('amps', 1), ('harmonic_distribution', 40)),
               compute_dtype: str = 'bfloat16'):
    super().__init__()
    self.stateless = stateless
    self.output_splits = tuple(output_splits)
    self.input_keys = tuple(input_keys)
    self.dtype = nn_layers.compute_dtype_of(compute_dtype)
    self.n_stacks = len(input_keys)
    input_dims = tuple(input_dims or (1,) * self.n_stacks)
    for i, in_dim in enumerate(input_dims):
      self.add_module(f'in_stack_{i}', nn_layers.FcStack(
          in_dim, ch, layers_per_stack, compute_dtype=compute_dtype))
    rnn_class = nn_layers.StatelessRnn if stateless else nn_layers.Rnn
    self.rnn = rnn_class(ch * self.n_stacks, rnn_channels, rnn_type,
                         compute_dtype=compute_dtype)
    self.out_stack = nn_layers.FcStack(ch * self.n_stacks + rnn_channels, ch,
                                       layers_per_stack,
                                       compute_dtype=compute_dtype)
    n_out = sum(v[1] for v in self.output_splits)
    self.dense_out = nn_layers.Dense(ch, n_out, dtype=torch.float32)

  def _input_keys(self) -> Sequence[str]:
    return list(self.input_keys) + (['state'] if self.stateless else [])

  def _output_keys(self) -> Sequence[str]:
    return [v[0] for v in self.output_splits] + (
        ['state'] if self.stateless else [])

  def compute(self, *inputs):
    inputs = list(inputs)
    if self.stateless:
      state = inputs.pop()
    inputs = [getattr(self, f'in_stack_{i}')(x) for i, x in enumerate(inputs)]
    x = torch.cat(inputs, dim=-1)
    if self.stateless:
      x, new_state = self.rnn(x, state)
    else:
      x = self.rnn(x)
    if self.dtype != torch.float32:
      # The out-stack's first Dense casts to bf16 anyway; casting before the
      # concat is bit-identical downstream (decoders.py:97-104).
      x = x.to(self.dtype)
    x = self.out_stack(torch.cat(inputs + [x], dim=-1))
    x = self.dense_out(x)
    outputs = nn_layers.split_to_dict(x, self.output_splits)
    if self.stateless:
      outputs['state'] = new_state
    return outputs


class FcStackDecoder(nn_layers.DictModule):
  """Concatenated inputs -> FC stack -> dense -> split (no recurrence).

  input_dims gives each input's channels (1 for the scaled f0 and loudness).
  """

  def __init__(self, ch: int = 256, layers_per_stack: int = 3,
               input_keys: Tuple[str, ...] = ('ld_scaled', 'f0_scaled'),
               input_dims: Optional[Sequence[int]] = None,
               output_splits: Tuple[Tuple[str, int], ...] = (
                   ('amps', 1), ('harmonic_distribution', 40))):
    super().__init__()
    self.input_keys = tuple(input_keys)
    self.output_splits = tuple(output_splits)
    in_features = sum(input_dims or (1,) * len(self.input_keys))
    self.stack = nn_layers.FcStack(in_features, ch, layers_per_stack)
    self.dense_out = nn_layers.Dense(self.stack.out_features,
                                     sum(v[1] for v in self.output_splits))

  def _output_keys(self) -> Sequence[str]:
    return [v[0] for v in self.output_splits]

  def compute(self, *inputs):
    x = self.dense_out(self.stack(torch.cat(list(inputs), dim=-1)))
    return nn_layers.split_to_dict(x, self.output_splits)


class _MidiNetDecoder(nn_layers.DictModule):
  """net (conditioned on z when given) -> Normalize('layer') (norm_layer)
  -> dense_out, from the quantized pitch z_pitch [batch, time, 1].

  The velocity z_vel is accepted and unused, as in the JAX package (a TODO
  of the reference).
  """

  def __init__(self, net: Optional[nn.Module], n_out: int, norm: bool,
               input_keys: Tuple[str, ...]):
    super().__init__()
    self.net = nn_layers.required_net(net, type(self).__name__)
    self.norm = norm
    self.input_keys = tuple(input_keys)
    self.dense_out = nn_layers.Dense(net.out_features, n_out)
    if norm:
      self.norm_layer = nn_layers.Normalize(net.out_features, 'layer')

  def _optional_input_keys(self) -> Sequence[str]:
    return ('z_vel', 'z')

  def _features(self, z_pitch, z):
    x = self.net(z_pitch) if z is None else self.net(z_pitch, z)
    if self.norm:
      x = self.norm_layer(x)
    return self.dense_out(x)


class MidiDecoder(_MidiNetDecoder):
  """MIDI pitch (and velocity) -> f0 (MIDI) and loudness curves; loudness
  recentered to the usual dB range (x * 30 - 70)."""

  def __init__(self, net: Optional[nn.Module] = None,
               f0_residual: bool = True, center_loudness: bool = True,
               norm: bool = True,
               input_keys: Tuple[str, ...] = ('z_pitch',),
               output_keys: Tuple[str, ...] = ('f0_midi', 'loudness')):
    super().__init__(net, 2, norm, input_keys)
    self.f0_residual = f0_residual
    self.center_loudness = center_loudness
    self.output_keys = tuple(output_keys)

  def compute(self, z_pitch, z_vel=None, z=None):
    del z_vel
    x = self._features(z_pitch, z)
    f0_midi, loudness = x[..., 0:1], x[..., 1:2]
    if self.f0_residual:
      f0_midi = f0_midi + z_pitch
    if self.center_loudness:
      loudness = loudness * 30.0 - 70.0
    return f0_midi, loudness


class MidiToHarmonicDecoder(_MidiNetDecoder):
  """MIDI pitch (and velocity) -> the harmonic synthesizer's controls, with
  f0 both in MIDI (residual on z_pitch) and in Hz ('f0_hz';
  midi_zero_silence maps MIDI 0 to 0 Hz)."""

  def __init__(self, net: Optional[nn.Module] = None,
               f0_residual: bool = True, norm: bool = True,
               output_splits: Tuple[Tuple[str, int], ...] = (
                   ('f0_midi', 1), ('amplitudes', 1),
                   ('harmonic_distribution', 60), ('magnitudes', 65)),
               midi_zero_silence: bool = True,
               input_keys: Tuple[str, ...] = ('z_pitch',)):
    output_splits = tuple(output_splits)
    super().__init__(net, sum(v[1] for v in output_splits), norm,
                     input_keys)
    self.f0_residual = f0_residual
    self.output_splits = output_splits
    self.midi_zero_silence = midi_zero_silence

  def _output_keys(self) -> Sequence[str]:
    return [v[0] for v in self.output_splits] + ['f0_hz']

  def compute(self, z_pitch, z_vel=None, z=None):
    del z_vel
    outputs = nn_layers.split_to_dict(self._features(z_pitch, z),
                                      self.output_splits)
    if self.f0_residual:
      outputs['f0_midi'] = outputs['f0_midi'] + z_pitch
    outputs['f0_hz'] = ops_core.midi_to_hz(
        outputs['f0_midi'], midi_zero_silence=self.midi_zero_silence)
    return outputs


class DilatedConvDecoder(nn_layers.DictModule):
  """WaveNet-style dilated conv decoder with optional z conditioning.

  The inputs (input_keys, of input_dims channels) are concatenated into x;
  the conditioning inputs (conditioning_keys, of conditioning_dims) into z,
  which FiLM-modulates the stack's normalizations, after the optional
  precondition_stack (a module with `out_features`).
  """

  takes_training = True

  def __init__(self, ch: int = 256, kernel_size: int = 3,
               layers_per_stack: int = 5, stacks: int = 2, dilation: int = 2,
               norm_type: str = 'layer', resample_stride: int = 1,
               stacks_per_resample: int = 1,
               resample_after_convolve: bool = True,
               input_keys: Tuple[str, ...] = ('ld_scaled', 'f0_scaled'),
               input_dims: Optional[Sequence[int]] = None,
               output_splits: Tuple[Tuple[str, int], ...] = (
                   ('amps', 1), ('harmonic_distribution', 60)),
               conditioning_keys: Tuple[str, ...] = ('z',),
               conditioning_dims: Optional[Sequence[int]] = None,
               precondition_stack: Optional[nn.Module] = None,
               spectral_norm: bool = False, ortho_init: bool = False):
    super().__init__()
    conditioning_keys = tuple(conditioning_keys or ())
    self.conditioning_keys = conditioning_keys
    if not self.conditional and precondition_stack is not None:
      raise ValueError('You must specify conditioning keys if you specify '
                       'a precondition stack.')
    if self.conditional and conditioning_dims is None:
      raise ValueError('A conditional DilatedConvDecoder needs '
                       'conditioning_dims.')
    self.n_cond = len(conditioning_keys)
    self.input_keys = tuple(input_keys)
    self.output_splits = tuple(output_splits)
    self.precondition_stack = precondition_stack
    z_ch = None
    if self.conditional:
      z_ch = (precondition_stack.out_features if precondition_stack
              is not None else sum(conditioning_dims))
    self.dilated_conv_stack = DilatedConvStack(
        sum(input_dims or (1,) * len(input_keys)), ch=ch,
        kernel_size=kernel_size, layers_per_stack=layers_per_stack,
        stacks=stacks, dilation=dilation, norm_type=norm_type,
        resample_type='upsample' if resample_stride > 1 else None,
        resample_stride=resample_stride,
        stacks_per_resample=stacks_per_resample,
        resample_after_convolve=resample_after_convolve,
        conditional=self.conditional, z_ch=z_ch,
        spectral_norm=spectral_norm, ortho_init=ortho_init)
    self.dense_out = nn_layers.Dense(ch, sum(v[1] for v in self.output_splits))

  @property
  def conditional(self) -> bool:
    return bool(self.conditioning_keys)

  def _input_keys(self) -> Sequence[str]:
    return list(self.input_keys) + list(self.conditioning_keys)

  def _output_keys(self) -> Sequence[str]:
    return [v[0] for v in self.output_splits]

  def compute(self, *inputs, training: bool = False):
    if self.conditional:
      x = torch.cat(inputs[:-self.n_cond], dim=-1)
      z = torch.cat(inputs[-self.n_cond:], dim=-1)
      if self.precondition_stack is not None:
        z = self.precondition_stack(z)
      y = self.dilated_conv_stack(x, z, training=training)
    else:
      y = self.dilated_conv_stack(torch.cat(inputs, dim=-1),
                                  training=training)
    return nn_layers.split_to_dict(self.dense_out(y), self.output_splits)
