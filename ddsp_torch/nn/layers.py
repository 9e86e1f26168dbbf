"""Neural network building blocks (port of ddsp_tpu/nn/layers.py).

Parameters keep the JAX package's names and layouts (a Dense kernel is
[in, out], LayerNorm has `scale` and `bias`, FastGRU has wi/wh/bi/bn), and
submodules are registered under flax's auto names (Fc_0, Dense_0, ...), so
a module's `named_parameters()` are the flax tree's 'a/b/c' paths with '.'
for '/'. utils/convert.py relies on that to load a JAX parameter tree.

The bf16 policy follows the JAX package: with compute_dtype='bfloat16' the
Dense products and the activations are bf16 while LayerNorm statistics,
the GRU carry and gate math are float32; with 'float32' everything is.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.kernels.gru import gru_sequence
from ddsp_torch.ops.core import nested_lookup

TensorDict = Dict[str, Any]

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
  if name not in _DTYPES:
    raise ValueError(f'compute_dtype must be one of {sorted(_DTYPES)}, not '
                     f'{name!r}.')
  return _DTYPES[name]


def get_nonlinearity(nonlinearity: str) -> Callable[[torch.Tensor],
                                                    torch.Tensor]:
  """Name -> activation (tf.nn names; leaky_relu has slope 0.2)."""
  if nonlinearity == 'leaky_relu':
    return lambda x: torch.nn.functional.leaky_relu(x, negative_slope=0.2)
  fn = getattr(torch.nn.functional, nonlinearity, None) or getattr(
      torch, nonlinearity, None)
  if fn is None:
    raise ValueError(f'Unknown nonlinearity: {nonlinearity}')
  return fn


def split_to_dict(tensor: torch.Tensor,
                  tensor_splits: Sequence[Tuple[str, int]]) -> TensorDict:
  """Split the last axis into a dict of named tensors."""
  labels = [v[0] for v in tensor_splits]
  sizes = [v[1] for v in tensor_splits]
  return dict(zip(labels, torch.split(tensor, sizes, dim=-1)))


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None):
  """flax's lecun_normal: truncated normal (+-2 std) of variance 1/fan_in."""
  # Std of a unit normal truncated to [-2, 2], as jax.nn.initializers uses.
  std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
  return nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                               generator=generator)


class DictModule(nn.Module):
  """Dict-in/dict-out module with explicitly declared keys.

  Subclasses set `input_keys` / `output_keys` and implement
  `compute(*tensors)` returning a tuple (matched to output_keys) or a dict.
  Calling the module with a features dict looks the inputs up by key.
  """

  input_keys: Tuple[str, ...] = ()
  output_keys: Tuple[str, ...] = ()

  def forward(self, *args) -> TensorDict:
    if len(args) == 1 and isinstance(args[0], dict):
      inputs = [nested_lookup(k, args[0]) for k in self.input_keys]
    else:
      inputs = list(args)
    outputs = self.compute(*inputs)
    if isinstance(outputs, dict):
      return outputs
    if not isinstance(outputs, (tuple, list)):
      outputs = (outputs,)
    if len(self.output_keys) != len(outputs):
      raise ValueError(
          f'Module {type(self).__name__} returned {len(outputs)} outputs '
          f'but declares output_keys {list(self.output_keys)}.')
    return dict(zip(self.output_keys, outputs))

  def compute(self, *inputs):
    raise NotImplementedError


class Dense(nn.Module):
  """flax.linen.Dense: y = x @ kernel + bias, kernel [in, out].

  With a bf16 dtype the inputs, kernel and bias are cast to bf16 first.
  """

  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.dtype = dtype
    self.kernel = nn.Parameter(torch.empty(in_features, features))
    self.bias = nn.Parameter(torch.empty(features))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      lecun_normal_(self.kernel, self.kernel.shape[0], generator)
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = self.dtype
    return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class LayerNorm(nn.Module):
  """flax.linen.LayerNorm over the last axis (fast variance, float32 stats).

  The output is cast to `dtype`; statistics, scale and bias are float32.
  """

  def __init__(self, features: int, epsilon: float = 1e-3,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.epsilon = epsilon
    self.dtype = dtype
    self.scale = nn.Parameter(torch.empty(features))
    self.bias = nn.Parameter(torch.empty(features))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    del generator
    with torch.no_grad():
      self.scale.fill_(1.0)
      self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + self.epsilon) * self.scale
    return ((xf - mean) * mul + self.bias).to(self.dtype)


class Fc(nn.Module):
  """Dense -> LayerNorm (eps 1e-3) -> nonlinearity."""

  def __init__(self, in_features: int, ch: int = 128,
               nonlinearity: str = 'leaky_relu',
               compute_dtype: str = 'bfloat16'):
    super().__init__()
    dt = compute_dtype_of(compute_dtype)
    self.Dense_0 = Dense(in_features, ch, dtype=dt)
    self.LayerNorm_0 = LayerNorm(ch, epsilon=1e-3, dtype=dt)
    self.act = get_nonlinearity(nonlinearity)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.act(self.LayerNorm_0(self.Dense_0(x)))


class FcStack(nn.Module):
  """Stack of Fc layers (Fc_0, Fc_1, ...)."""

  def __init__(self, in_features: int, ch: int = 256, layers: int = 2,
               nonlinearity: str = 'leaky_relu',
               compute_dtype: str = 'bfloat16'):
    super().__init__()
    self.n_layers = layers
    for i in range(layers):
      self.add_module(f'Fc_{i}', Fc(in_features if i == 0 else ch, ch,
                                    nonlinearity, compute_dtype))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.n_layers):
      x = getattr(self, f'Fc_{i}')(x)
    return x


class FastGRU(nn.Module):
  """GRU with the input projection hoisted out of the recurrence.

  Reset-after convention (flax GRUCell): n = tanh(x W_in + b_in +
  r * (h W_hn + b_hn)). All T input projections are one GEMM (plain
  torch.matmul, differentiated by autograd); the recurrence is kernel K2f
  on a CUDA tensor and its backward kernel K2b.

  Stream dtype. In bf16 mode the GEMM takes bf16 operands with float32
  accumulation. Where the JAX package runs its Pallas kernel
  (ddsp_tpu/nn/layers.py:209-237: a TPU and gru_kernel_supported,
  ddsp_tpu/ops/pallas_kernels/gru.py:84: at least MIN_BF16_STEPS steps and
  a multiple of BF16_HIDDEN_MULTIPLE units), xp and wh enter the recurrence
  as bf16. Where it runs its float32 lax.scan instead (a shorter sequence,
  or another H such as the tiny preset's 64), xp stays float32 (the bf16
  GEMM's float32 result, not cast back) and wh float32 (:239-253), so the
  port runs K2's float32 routes there: a streaming decoder's T = 1
  recurrence takes the step kernel. The VMEM clause of :84 is a TPU layout
  limit and is not followed.
  """

  # ddsp_tpu/ops/pallas_kernels/gru.py:84: `seq_len >= 8` and
  # `hidden % _LANES == 0` (128 lanes).
  MIN_BF16_STEPS = 8
  BF16_HIDDEN_MULTIPLE = 128

  def __init__(self, in_features: int, dims: int = 512,
               compute_dtype: str = 'bfloat16'):
    super().__init__()
    self.dims = dims
    self.dtype = compute_dtype_of(compute_dtype)
    self.wi = nn.Parameter(torch.empty(in_features, 3 * dims))
    self.wh = nn.Parameter(torch.empty(dims, 3 * dims))
    self.bi = nn.Parameter(torch.empty(3 * dims))
    self.bn = nn.Parameter(torch.empty(dims))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      lecun_normal_(self.wi, self.wi.shape[0], generator)
      nn.init.orthogonal_(self.wh, generator=generator)
      self.bi.zero_()
      self.bn.zero_()

  def forward(self, x: torch.Tensor,
              initial_state: Optional[torch.Tensor] = None,
              return_state: bool = False):
    """x [batch, time, in] -> ys [batch, time, dims] float32, and the final
    state [batch, dims] if return_state; initial_state [batch, dims] is
    the carry's start (zeros if None)."""
    dt = self.dtype
    if dt != torch.float32:
      # Products of bf16 operands are exact in float32: this is a bf16 GEMM
      # with float32 accumulation.
      xp = x.to(dt).float() @ self.wi.to(dt).float() + self.bi
      if (x.shape[1] >= self.MIN_BF16_STEPS and
          self.dims % self.BF16_HIDDEN_MULTIPLE == 0):
        xp = xp.to(dt)  # bf16 streams: K2's bf16 route
    else:
      xp = x.float() @ self.wi + self.bi  # [batch, time, 3H]
    if initial_state is None:
      h0 = x.new_zeros((x.shape[0], self.dims), dtype=torch.float32)
    else:
      h0 = initial_state.float()
    ys = gru_sequence(xp.transpose(0, 1).contiguous(), self.wh, self.bn,
                      h0).transpose(0, 1)
    if return_state:
      return ys, ys[:, -1]
    return ys


class Rnn(nn.Module):
  """Single unidirectional GRU layer (FastGRU_0) over [batch, time, ch].

  The JAX package's other cells (LSTM, bidirectional, flax GRUCell) are not
  on the serving path and are not ported.
  """

  def __init__(self, in_features: int, dims: int = 512,
               rnn_type: str = 'gru', compute_dtype: str = 'bfloat16'):
    super().__init__()
    if rnn_type != 'gru':
      raise NotImplementedError(
          f"ddsp_torch's Rnn runs the FastGRU only, not {rnn_type!r}.")
    self.FastGRU_0 = FastGRU(in_features, dims, compute_dtype)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.FastGRU_0(x).float()


class StatelessRnn(nn.Module):
  """One GRU layer (FastGRU_0) with its state passed in and out, for
  streaming (port of ddsp_tpu/nn/layers.py:305, GRU only)."""

  def __init__(self, in_features: int, dims: int = 512,
               rnn_type: str = 'gru', compute_dtype: str = 'bfloat16'):
    super().__init__()
    if rnn_type != 'gru':
      raise NotImplementedError(
          f"ddsp_torch's StatelessRnn runs the FastGRU only, not "
          f'{rnn_type!r}.')
    self.FastGRU_0 = FastGRU(in_features, dims, compute_dtype)

  def forward(self, x: torch.Tensor, state: torch.Tensor):
    """x [batch, time, ch], state [batch, dims] -> (y [batch, time, dims],
    new_state [batch, dims]), both float32."""
    return self.FastGRU_0(x, initial_state=state, return_state=True)
