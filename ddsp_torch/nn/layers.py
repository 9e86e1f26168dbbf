"""Neural network building blocks (port of ddsp_tpu/nn/layers.py).

Parameters keep the JAX package's names and layouts (a Dense kernel is
[in, out], LayerNorm has `scale` and `bias`, FastGRU has wi/wh/bi/bn,
flax's cells their Denses ir, hn, if, ...; Normalize's scale and shift
are [1, 1, 1, ch]), and
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


def required_net(net: Optional[nn.Module], owner: str) -> nn.Module:
  """`net`, which the JAX field defaults to None but every call needs: the
  port sizes the layers after it from its out_features, so None raises
  here rather than at the first call."""
  if net is None:
    raise ValueError(f'{owner} needs a net (a module with out_features); '
                     'it defaults to None only as the JAX field does.')
  return net


class DictModule(nn.Module):
  """Dict-in/dict-out module with explicitly declared keys.

  Subclasses take `input_keys` / `output_keys` (constructor arguments where
  the JAX module has them as fields, with its defaults) and implement
  `compute(*tensors)` returning a tuple (matched to the output keys) or a
  dict. Calling the module with a features dict looks the inputs up by key.
  `_input_keys()` / `_output_keys()` are the keys read and written (a
  subclass may add to them, e.g. 'state'); `_optional_input_keys()` those
  that may be absent from the features (passed as None). `training` reaches
  compute only where a subclass sets takes_training, as the JAX modules
  take it (or drop it into **unused_kwargs).
  """

  input_keys: Tuple[str, ...] = ()
  output_keys: Tuple[str, ...] = ()
  takes_training = False

  def _input_keys(self) -> Sequence[str]:
    return self.input_keys

  def _output_keys(self) -> Sequence[str]:
    return self.output_keys

  def _optional_input_keys(self) -> Sequence[str]:
    return ()

  def forward(self, *args, training: bool = False) -> TensorDict:
    if len(args) == 1 and isinstance(args[0], dict):
      optional = set(self._optional_input_keys())
      inputs = []
      for k in self._input_keys():
        try:
          inputs.append(nested_lookup(k, args[0]))
        except KeyError:
          if k not in optional:
            raise
          inputs.append(None)
    else:
      inputs = list(args)
    kwargs = {'training': training} if self.takes_training else {}
    outputs = self.compute(*inputs, **kwargs)
    if isinstance(outputs, dict):
      return outputs
    if not isinstance(outputs, (tuple, list)):
      outputs = (outputs,)
    output_keys = list(self._output_keys())
    if len(output_keys) != len(outputs):
      raise ValueError(
          f'Module {type(self).__name__} returned {len(outputs)} outputs '
          f'but declares output_keys {output_keys}.')
    return dict(zip(output_keys, outputs))

  def compute(self, *inputs):
    raise NotImplementedError


class OutputSplitsModule(DictModule):
  """One network head split into a dict of named outputs (the reference's
  OutputSplitsLayer, nn.py:249).

  The base class of a custom head: a subclass implements
  `compute_output(*inputs)` -> [batch, time, n_out], n_out the sum of the
  output_splits' sizes, and the module returns it split into
  {name: [batch, time, size]}.
  """

  def __init__(self, input_keys: Tuple[str, ...] = (),
               output_splits: Tuple[Tuple[str, int], ...] = (('amps', 1),)):
    super().__init__()
    self.input_keys = tuple(input_keys)
    self.output_splits = tuple(output_splits)

  def _output_keys(self) -> Sequence[str]:
    return [v[0] for v in self.output_splits]

  @property
  def n_out(self) -> int:
    return sum(v[1] for v in self.output_splits)

  def compute(self, *inputs, **kwargs) -> TensorDict:
    return split_to_dict(self.compute_output(*inputs, **kwargs),
                         self.output_splits)

  def compute_output(self, *inputs, **kwargs) -> torch.Tensor:
    raise NotImplementedError


class Dense(nn.Module):
  """flax.linen.Dense: y = x @ kernel + bias, kernel [in, out].

  With a bf16 dtype the inputs, kernel and bias are cast to bf16 first.
  kernel_init is flax's name of the kernel's initializer: 'lecun_normal'
  (the default) or 'orthogonal' (the recurrent kernels of flax's cells).
  """

  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32, use_bias: bool = True,
               kernel_init: str = 'lecun_normal'):
    super().__init__()
    self.dtype = dtype
    self.kernel_init = kernel_init
    self.kernel = nn.Parameter(torch.empty(in_features, features))
    self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      if self.kernel_init == 'orthogonal':
        nn.init.orthogonal_(self.kernel, generator=generator)
      else:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
      if self.bias is not None:
        self.bias.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    dt = self.dtype
    y = x.to(dt) @ self.kernel.to(dt)
    return y if self.bias is None else y + self.bias.to(dt)


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
    self.out_features = ch
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
    self.out_features = ch if layers else in_features
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


class GRUCell(nn.Module):
  """flax.linen.GRUCell: input Denses ir, iz, in with a bias, recurrent
  Denses hr, hz without one and hn with one (reset-after):
  n = tanh(in(x) + r * hn(h)), h' = (1 - z) n + z h.

  With a bf16 dtype the Denses and the gate math are bf16, as flax's
  `dtype` makes them; the carry stays float32 (flax promotes z * h).
  """

  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.features = features
    for name in ('ir', 'iz', 'in'):
      self.add_module(name, Dense(in_features, features, dtype))
    for name in ('hr', 'hz', 'hn'):
      self.add_module(name, Dense(features, features, dtype,
                                  use_bias=name == 'hn',
                                  kernel_init='orthogonal'))

  def initial_carry(self, x: torch.Tensor) -> torch.Tensor:
    return x.new_zeros((x.shape[0], self.features), dtype=torch.float32)

  def input_projection(self, x: torch.Tensor):
    """Each time step's input terms, [batch, time, features] x 3."""
    return tuple(getattr(self, n)(x) for n in ('ir', 'iz', 'in'))

  def step(self, carry: torch.Tensor, xp_t):
    """(h, the step's input terms) -> (h', output h')."""
    h = carry
    xr, xz, xn = xp_t
    r = torch.sigmoid(xr + self.hr(h))
    z = torch.sigmoid(xz + self.hz(h))
    n = torch.tanh(xn + r * getattr(self, 'hn')(h))
    h = (1.0 - z) * n + z * h
    return h, h


class OptimizedLSTMCell(nn.Module):
  """flax.linen.OptimizedLSTMCell: input Denses ii, if, ig, io without a
  bias, recurrent Denses hi, hf, hg, ho with one; the carry is (c, h).

  With a bf16 dtype the products and gates are bf16; c and h stay float32
  (flax promotes f * c and o * tanh(c)).
  """

  GATES = ('i', 'f', 'g', 'o')

  def __init__(self, in_features: int, features: int,
               dtype: torch.dtype = torch.float32):
    super().__init__()
    self.features = features
    for gate in self.GATES:
      self.add_module(f'i{gate}', Dense(in_features, features, dtype,
                                        use_bias=False))
      self.add_module(f'h{gate}', Dense(features, features, dtype,
                                        kernel_init='orthogonal'))

  def initial_carry(self, x: torch.Tensor):
    zeros = x.new_zeros((x.shape[0], self.features), dtype=torch.float32)
    return zeros, zeros

  def input_projection(self, x: torch.Tensor):
    return tuple(getattr(self, f'i{gate}')(x) for gate in self.GATES)

  def step(self, carry, xp_t):
    c, h = carry
    pre = [xg + getattr(self, f'h{gate}')(h)
           for gate, xg in zip(self.GATES, xp_t)]
    i, f, o = (torch.sigmoid(pre[k]) for k in (0, 1, 3))
    g = torch.tanh(pre[2])
    c = f * c + i * g
    h = o * torch.tanh(c)
    return (c, h), h


_CELLS = {'lstm': OptimizedLSTMCell, 'gru': GRUCell}


def _cell(rnn_type: str, in_features: int, dims: int,
          compute_dtype: str) -> nn.Module:
  if rnn_type not in _CELLS:
    raise ValueError(f'rnn_type must be one of {sorted(_CELLS)}, not '
                     f'{rnn_type!r}.')
  return _CELLS[rnn_type](in_features, dims, compute_dtype_of(compute_dtype))


def run_cell(cell: nn.Module, x: torch.Tensor, carry=None,
             reverse: bool = False):
  """flax.linen.RNN over [batch, time, ch]: a step loop (the JAX package's
  lax.scan). reverse runs from the last step and keeps the outputs in
  input order (keep_order=True). Returns (final carry, ys [batch, time,
  features])."""
  if carry is None:
    carry = cell.initial_carry(x)
  xp = cell.input_projection(x)
  steps = range(x.shape[1] - 1, -1, -1) if reverse else range(x.shape[1])
  ys = [None] * x.shape[1]
  for t in steps:
    carry, ys[t] = cell.step(carry, tuple(p[:, t] for p in xp))
  return carry, torch.stack(ys, dim=1)


class Rnn(nn.Module):
  """One RNN layer over [batch, time, ch] (port of ddsp_tpu/nn/layers.py
  Rnn).

  'gru' with use_fast_gru is FastGRU_0 (kernels K2f, K2b on the card).
  Otherwise flax's cells, as a step loop: GRUCell_0 or OptimizedLSTMCell_0,
  and with bidir two of them (_0 forward, _1 over reversed time), their
  outputs concatenated. return_sequences=False keeps the last step. The
  output is float32.
  """

  def __init__(self, in_features: int, dims: int = 512,
               rnn_type: str = 'gru', compute_dtype: str = 'bfloat16',
               return_sequences: bool = True, bidir: bool = False,
               use_fast_gru: bool = True):
    super().__init__()
    self.return_sequences = return_sequences
    self.bidir = bidir
    self.out_features = 2 * dims if bidir else dims
    if bidir:
      self.cell_names = []
      for i in range(2):
        cell = _cell(rnn_type, in_features, dims, compute_dtype)
        self.cell_names.append(f'{type(cell).__name__}_{i}')
        self.add_module(self.cell_names[-1], cell)
    elif rnn_type == 'gru' and use_fast_gru:
      self.FastGRU_0 = FastGRU(in_features, dims, compute_dtype)
    else:
      cell = _cell(rnn_type, in_features, dims, compute_dtype)
      self.cell_names = [f'{type(cell).__name__}_0']
      self.add_module(self.cell_names[0], cell)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    if hasattr(self, 'FastGRU_0'):
      y = self.FastGRU_0(x)
    elif self.bidir:
      fwd, bwd = (getattr(self, n) for n in self.cell_names)
      y = torch.cat([run_cell(fwd, x)[1], run_cell(bwd, x, reverse=True)[1]],
                    dim=-1)
    else:
      y = run_cell(getattr(self, self.cell_names[0]), x)[1]
    if not self.return_sequences:
      y = y[:, -1]
    return y.float()


class StatelessRnn(nn.Module):
  """One unidirectional RNN layer with its state passed in and out, for
  streaming (port of ddsp_tpu/nn/layers.py StatelessRnn).

  'gru' is FastGRU_0, state [batch, dims]; 'lstm' is OptimizedLSTMCell_0,
  state [batch, 2 * dims] packing (c, h). The JAX package's flax-GRUCell
  branch (use_fast_gru=False) splits the state as an LSTM carry and fails,
  so it has no counterpart here.
  """

  def __init__(self, in_features: int, dims: int = 512,
               rnn_type: str = 'gru', compute_dtype: str = 'bfloat16',
               use_fast_gru: bool = True):
    super().__init__()
    self.dims = dims
    self.out_features = dims
    if rnn_type == 'gru' and use_fast_gru:
      self.FastGRU_0 = FastGRU(in_features, dims, compute_dtype)
    elif rnn_type == 'lstm':
      self.OptimizedLSTMCell_0 = _cell('lstm', in_features, dims,
                                       compute_dtype)
    else:
      raise ValueError(
          f'StatelessRnn runs FastGRU (rnn_type gru, use_fast_gru) or an '
          f'LSTM, not rnn_type={rnn_type!r} with use_fast_gru='
          f'{use_fast_gru}: that flax-GRUCell branch of the JAX package '
          'fails on its own state.')

  def forward(self, x: torch.Tensor, state: torch.Tensor):
    """x [batch, time, ch], state -> (y [batch, time, dims], new_state),
    both float32."""
    if hasattr(self, 'FastGRU_0'):
      return self.FastGRU_0(x, initial_state=state, return_state=True)
    carry = (state[..., :self.dims].float(), state[..., self.dims:].float())
    carry, y = run_cell(self.OptimizedLSTMCell_0, x, carry)
    return y.float(), torch.cat(carry, dim=-1).float()


class RnnFc(nn.Module):
  """n_rnn RNN layers (Rnn_0, ...) -> Fc_0 (sigmoid by default)."""

  def __init__(self, in_features: int, rnn_feat: int = 512,
               out_feat: int = 512, rnn_type: str = 'lstm',
               nonlinearity: str = 'sigmoid', bidir: bool = False,
               n_rnn: int = 1):
    super().__init__()
    self.n_rnn = n_rnn
    self.out_features = out_feat
    for i in range(n_rnn):
      rnn = Rnn(in_features, rnn_feat, rnn_type, bidir=bidir)
      self.add_module(f'Rnn_{i}', rnn)
      in_features = rnn.out_features
    self.Fc_0 = Fc(in_features, out_feat, nonlinearity=nonlinearity)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    for i in range(self.n_rnn):
      x = getattr(self, f'Rnn_{i}')(x)
    return self.Fc_0(x)


class RnnSandwich(nn.Module):
  """FcStack_0 -> Rnn_0 -> FcStack_1."""

  def __init__(self, in_features: int, fc_stack_ch: int = 256,
               fc_stack_layers: int = 2, rnn_ch: int = 512,
               rnn_type: str = 'gru'):
    super().__init__()
    self.FcStack_0 = FcStack(in_features, fc_stack_ch, fc_stack_layers)
    self.Rnn_0 = Rnn(self.FcStack_0.out_features, rnn_ch, rnn_type)
    self.FcStack_1 = FcStack(rnn_ch, fc_stack_ch, fc_stack_layers)
    self.out_features = self.FcStack_1.out_features

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.FcStack_1(self.Rnn_0(self.FcStack_0(x)))


class SingleGru(nn.Module):
  """Rnn_0 (GRU) -> LayerNorm_0."""

  def __init__(self, in_features: int, gru_dim: int = 128):
    super().__init__()
    self.out_features = gru_dim
    self.Rnn_0 = Rnn(in_features, gru_dim, 'gru')
    self.LayerNorm_0 = LayerNorm(gru_dim, epsilon=1e-3)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.LayerNorm_0(self.Rnn_0(x))


class FcStackOut(nn.Module):
  """FcStack_0 -> a float32 Dense_0 to n_out."""

  def __init__(self, in_features: int, ch: int, layers: int, n_out: int):
    super().__init__()
    self.out_features = n_out
    self.FcStack_0 = FcStack(in_features, ch, layers)
    self.Dense_0 = Dense(self.FcStack_0.out_features, n_out)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.Dense_0(self.FcStack_0(x))


class Identity(nn.Module):
  """Pass-through module (a no-op norm slot)."""

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return x


class Embed(nn.Module):
  """flax.linen.Embed: rows of `embedding` [num_embeddings, features]."""

  def __init__(self, num_embeddings: int, features: int):
    super().__init__()
    self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    # flax's default: variance scaling 1.0, fan_in = num_embeddings.
    with torch.no_grad():
      lecun_normal_(self.embedding, self.embedding.shape[0], generator)

  def forward(self, idx: torch.Tensor) -> torch.Tensor:
    return self.embedding[idx.long()]


class Embedding(nn.Module):
  """Real-valued embedding of an integer id (Embed_0)."""

  def __init__(self, vocab_size: int = 1024, n_dims: int = 256):
    super().__init__()
    self.out_features = n_dims
    self.Embed_0 = Embed(vocab_size, n_dims)

  def forward(self, idx: torch.Tensor) -> torch.Tensor:
    return self.Embed_0(idx)


def ensure_4d(x: torch.Tensor) -> torch.Tensor:
  """Add height and width axes: [b, ch] -> [b, 1, 1, ch], [b, t, ch] ->
  [b, t, 1, ch]."""
  if x.ndim == 2:
    return x[:, None, None, :]
  if x.ndim == 3:
    return x[:, :, None, :]
  return x


def inv_ensure_4d(x: torch.Tensor, n_dims: int) -> torch.Tensor:
  """Remove the axes ensure_4d added to a tensor of n_dims dimensions."""
  if n_dims == 2:
    return x[:, 0, 0, :]
  if n_dims == 3:
    return x[:, :, 0, :]
  return x


def normalize_op(x: torch.Tensor, norm_type: Optional[str] = 'layer',
                 eps: float = 1e-5) -> torch.Tensor:
  """Instance, layer or group (32 groups) normalization of
  [batch, height, width, ch] without learned parameters: statistics over
  height, width and each group's channels, population variance. None
  passes x through."""
  if norm_type is None:
    return x
  mb, h, w, ch = x.shape
  n_groups = {'instance': ch, 'layer': 1, 'group': 32}[norm_type]
  x = x.reshape(mb, h, w, n_groups, ch // n_groups)
  mean = x.mean(dim=(1, 2, 4), keepdim=True)
  var = x.var(dim=(1, 2, 4), keepdim=True, correction=0)
  x = (x - mean) / torch.sqrt(var + eps)
  return x.reshape(mb, h, w, ch)


class Normalize(nn.Module):
  """normalize_op then a learned scale and shift, each [1, 1, 1, ch]
  (norm_type None: the scale and shift alone)."""

  def __init__(self, ch: int, norm_type: Optional[str] = 'layer'):
    super().__init__()
    self.norm_type = norm_type
    self.scale = nn.Parameter(torch.empty(1, 1, 1, ch))
    self.shift = nn.Parameter(torch.empty(1, 1, 1, ch))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    del generator
    with torch.no_grad():
      self.scale.fill_(1.0)
      self.shift.zero_()

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    n_dims = x.ndim
    x = normalize_op(ensure_4d(x), self.norm_type)
    return inv_ensure_4d(x * self.scale + self.shift, n_dims)
