"""Decoders: conditioning features -> synthesizer controls.

Port of RnnFcDecoder (stateful, and stateless for streaming) from
ddsp_tpu/nn/decoders.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ddsp_torch.nn import layers as nn_layers


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
    input_dims: Channels of each input (1 for the scaled f0 and loudness).
    output_splits: (name, n_channels) pairs the dense head is split into.
    compute_dtype: 'bfloat16' or 'float32' for the stacks and the GRU; the
      head is always float32.
  """

  def __init__(self, rnn_channels: int = 512, rnn_type: str = 'gru',
               ch: int = 512, layers_per_stack: int = 3,
               stateless: bool = False,
               input_keys: Tuple[str, ...] = ('ld_scaled', 'f0_scaled'),
               input_dims: Optional[Sequence[int]] = None,
               output_splits: Tuple[Tuple[str, int], ...] = (
                   ('amps', 1), ('harmonic_distribution', 40)),
               compute_dtype: str = 'bfloat16'):
    super().__init__()
    self.stateless = stateless
    self.output_splits = tuple(output_splits)
    self.input_keys = tuple(input_keys) + (('state',) if stateless else ())
    self.output_keys = tuple(v[0] for v in self.output_splits) + (
        ('state',) if stateless else ())
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
