"""Residual networks (bottleneck ResNet) and FiLM conditional normalization.

Port of ddsp_tpu/nn/resnet.py. Inputs are NHWC [batch, time, freq, ch], as
there; convolutions stride over frequency (width) only. Conv keeps flax's
parameters, kernel [kh, kw, in, out] and bias [out], so a JAX tree loads as
it is (utils/convert.py); forward permutes the kernel to torch's
[out, in, kh, kw] and pads as flax's 'SAME' does (the smaller half before,
the larger after).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.nn.layers import (Dense, Normalize, ensure_4d,
                                  get_nonlinearity, lecun_normal_,
                                  normalize_op)
from ddsp_torch.ops.core import full_float32


def same_padding(size: int, k: int, s: int) -> Tuple[int, int]:
  """flax/XLA 'SAME' padding (before, after) of one axis."""
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


def transpose_same_padding(k: int, s: int) -> Tuple[int, int]:
  """lax.conv_transpose's 'SAME' padding (before, after) of one axis of the
  stride-dilated input."""
  pad_len = k + s - 2
  pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
  return pad_a, pad_len - pad_a


def init_kernel_(kernel: torch.Tensor, kernel_init: str = 'lecun_normal',
                 generator: Optional[torch.Generator] = None):
  """flax's initializers of a [..., in, out] kernel: 'lecun_normal',
  'glorot_uniform' (fans over the receptive field) or 'orthogonal' (the
  kernel as a [prod(shape[:-1]), out] matrix)."""
  receptive = math.prod(kernel.shape[:-2])
  fan_in, fan_out = receptive * kernel.shape[-2], receptive * kernel.shape[-1]
  with torch.no_grad():
    if kernel_init == 'lecun_normal':
      lecun_normal_(kernel, fan_in, generator)
    elif kernel_init == 'glorot_uniform':
      limit = math.sqrt(6.0 / (fan_in + fan_out))
      kernel.uniform_(-limit, limit, generator=generator)
    elif kernel_init == 'orthogonal':
      matrix = torch.empty(fan_in, kernel.shape[-1])
      nn.init.orthogonal_(matrix, generator=generator)
      kernel.copy_(matrix.reshape(kernel.shape))
    else:
      raise ValueError(f'Unknown kernel_init {kernel_init!r}.')


class _Float32Conv2d(torch.autograd.Function):
  """conv2d (no padding) whose forward and backward both run in full float32
  (`full_float32`): the process's TF32 setting reaches neither."""

  @staticmethod
  def forward(ctx, x, weight, bias, stride, dilation):
    ctx.save_for_backward(x, weight)
    ctx.conf = (stride, dilation)
    with full_float32():
      return torch.nn.functional.conv2d(x, weight, bias, stride, 0, dilation)

  @staticmethod
  def backward(ctx, grad):
    x, weight = ctx.saved_tensors
    stride, dilation = ctx.conf
    with full_float32():
      gx, gw, gb = torch.ops.aten.convolution_backward(
          grad, x, weight, [weight.shape[0]], list(stride), [0, 0],
          list(dilation), False, [0, 0], 1, list(ctx.needs_input_grad[:3]))
    return gx, gw, gb, None, None


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           stride=(1, 1), dilation=(1, 1),
           float32: bool = False) -> torch.Tensor:
  """torch conv2d of NCHW x (already padded); pinned to full float32 both
  ways when `float32` is set."""
  if float32:
    return _Float32Conv2d.apply(x, weight, bias, tuple(stride),
                                tuple(dilation))
  return torch.nn.functional.conv2d(x, weight, bias, stride, 0, dilation)


class Conv(nn.Module):
  """flax.linen.Conv on NHWC with 'SAME' padding, strides and kernel
  dilation. kernel_init names flax's initializer; full_float32 pins the
  convolution's precision both ways (`conv2d`)."""

  def __init__(self, in_features: int, features: int,
               kernel_size: Tuple[int, int], strides: Tuple[int, int] = (1, 1),
               kernel_dilation: Tuple[int, int] = (1, 1),
               kernel_init: str = 'lecun_normal', full_float32: bool = False):
    super().__init__()
    self.strides = tuple(strides)
    self.kernel_dilation = tuple(kernel_dilation)
    self.kernel_init = kernel_init
    self.full_float32 = full_float32
    self.kernel = nn.Parameter(torch.empty(*kernel_size, in_features,
                                           features))
    self.bias = nn.Parameter(torch.empty(features))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    init_kernel_(self.kernel, self.kernel_init, generator)
    with torch.no_grad():
      self.bias.zero_()

  def forward(self, x: torch.Tensor,
              kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H, W, in] -> [B, H', W', out]; `kernel` replaces the
    parameter (a spectrally normalized one)."""
    kernel = self.kernel if kernel is None else kernel
    kh, kw = kernel.shape[:2]
    (sh, sw), (dh, dw) = self.strides, self.kernel_dilation
    h, w = x.shape[1:3]
    ph = same_padding(h, (kh - 1) * dh + 1, sh)
    pw = same_padding(w, (kw - 1) * dw + 1, sw)
    x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), pw + ph)
    y = conv2d(x, kernel.permute(3, 2, 0, 1), self.bias, self.strides,
               self.kernel_dilation, self.full_float32)
    return y.permute(0, 2, 3, 1)


class ConvTranspose(Conv):
  """flax.linen.ConvTranspose (lax.conv_transpose, transpose_kernel=False)
  on NHWC with 'SAME' padding: the input dilated by the strides, padded as
  lax pads it and correlated with the kernel as stored, unflipped. An
  input of H x W gives H * sh x W * sw."""

  def forward(self, x: torch.Tensor,
              kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    kernel = self.kernel if kernel is None else kernel
    kh, kw = kernel.shape[:2]
    (sh, sw), (dh, dw) = self.strides, self.kernel_dilation
    b, h, w, c = x.shape
    dilated = x.new_zeros(b, c, (h - 1) * sh + 1, (w - 1) * sw + 1)
    dilated[:, :, ::sh, ::sw] = x.permute(0, 3, 1, 2)
    pads = (transpose_same_padding((kw - 1) * dw + 1, sw) +
            transpose_same_padding((kh - 1) * dh + 1, sh))
    y = conv2d(torch.nn.functional.pad(dilated, pads),
               kernel.permute(3, 2, 0, 1), self.bias,
               dilation=self.kernel_dilation, float32=self.full_float32)
    return y.permute(0, 2, 3, 1)


def max_pool_same(x: torch.Tensor, window: Tuple[int, int],
                  strides: Tuple[int, int]) -> torch.Tensor:
  """flax.linen.max_pool with 'SAME' padding (padded with -inf) on NHWC."""
  ph = same_padding(x.shape[1], window[0], strides[0])
  pw = same_padding(x.shape[2], window[1], strides[1])
  x = torch.nn.functional.pad(x.permute(0, 3, 1, 2), pw + ph,
                              value=float('-inf'))
  y = torch.nn.functional.max_pool2d(x, window, strides)
  return y.permute(0, 2, 3, 1)


class ConditionalScaleAndShift(nn.Module):
  """FiLM: x * scale + shift with (scale, shift) = Dense_0(z)."""

  def __init__(self, x_ch: int, z_ch: int, shift_only: bool = False):
    super().__init__()
    self.shift_only = shift_only
    self.x_ch = x_ch
    self.Dense_0 = Dense(z_ch, x_ch if shift_only else 2 * x_ch)

  def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    scale_shift = self.Dense_0(z)
    if self.shift_only:
      return x + scale_shift
    return x * scale_shift[..., :self.x_ch] + scale_shift[..., self.x_ch:]


class ConditionalNorm(nn.Module):
  """normalize_op, then ConditionalScaleAndShift_0 of z."""

  def __init__(self, x_ch: int, z_ch: int, norm_type: str = 'instance',
               shift_only: bool = False):
    super().__init__()
    self.norm_type = norm_type
    self.ConditionalScaleAndShift_0 = ConditionalScaleAndShift(
        x_ch, z_ch, shift_only)

  def forward(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    return self.ConditionalScaleAndShift_0(normalize_op(x, self.norm_type), z)


def get_norm(norm_type: str, conditional: bool, shift_only: bool, *,
             ch: int, z_ch: Optional[int] = None) -> nn.Module:
  """Normalization layer: learned scale and shift (Normalize), or
  FiLM-conditioned on z (ConditionalNorm).

  The port's layers take their channel counts, which flax infers: ch those
  of x, z_ch those of z (conditional only).
  """
  if conditional:
    return ConditionalNorm(ch, z_ch, norm_type=norm_type,
                           shift_only=shift_only)
  return Normalize(ch, norm_type=norm_type)


class NormReluConv(nn.Module):
  """Normalize_0 -> ReLU -> Conv_0 (k x k, stride (1, s))."""

  def __init__(self, in_ch: int, ch: int, k: int, s: int, norm_type: str):
    super().__init__()
    self.Normalize_0 = Normalize(in_ch, norm_type)
    self.Conv_0 = Conv(in_ch, ch, (k, k), (1, s))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.Conv_0(torch.relu(self.Normalize_0(x)))


class ResidualLayer(nn.Module):
  """One bottleneck layer, 4 * ch channels out; with `shortcut` a strided
  1x1 projection (conv_proj) after the first norm and ReLU."""

  def __init__(self, in_ch: int, ch: int, stride: int, shortcut: bool,
               norm_type: str, conditional: bool = False,
               shift_only: bool = False, z_ch: int = 0):
    super().__init__()
    self.conditional = conditional
    self.shortcut = shortcut
    ch_out = 4 * ch
    if conditional:
      self.ConditionalNorm_0 = ConditionalNorm(in_ch, z_ch, norm_type,
                                               shift_only)
    else:
      self.Normalize_0 = Normalize(in_ch, norm_type)
    if shortcut:
      self.conv_proj = Conv(in_ch, ch_out, (1, 1), (1, stride))
    self.Conv_0 = Conv(in_ch, ch, (1, 1))
    self.NormReluConv_0 = NormReluConv(ch, ch, 3, stride, norm_type)
    self.NormReluConv_1 = NormReluConv(ch, ch_out, 1, 1, norm_type)

  def forward(self, x: torch.Tensor,
              z: Optional[torch.Tensor] = None) -> torch.Tensor:
    r = x
    x = ensure_4d(x)
    if self.conditional:
      x = torch.relu(self.ConditionalNorm_0(x, ensure_4d(z)))
    else:
      x = torch.relu(self.Normalize_0(x))
    if self.shortcut:
      r = self.conv_proj(x)
    x = self.Conv_0(x)
    x = self.NormReluConv_0(x)
    return self.NormReluConv_1(x) + r


class ResidualStack(nn.Module):
  """Blocks of residual layers (ResidualLayer_0, ...; the first of each
  block with the shortcut and stride), then Normalize_0 and the
  nonlinearity."""

  def __init__(self, in_ch: int, filters: Sequence[int],
               block_sizes: Sequence[int], strides: Sequence[int],
               norm_type: str, conditional: bool = False,
               shift_only: bool = False, nonlinearity: str = 'relu',
               z_ch: int = 0):
    super().__init__()
    self.conditional = conditional
    self.n_layers = 0
    for ch, n_layers, stride in zip(filters, block_sizes, strides):
      for i in range(n_layers):
        self.add_module(f'ResidualLayer_{self.n_layers}', ResidualLayer(
            in_ch, ch, stride if i == 0 else 1, i == 0, norm_type,
            conditional, shift_only, z_ch))
        self.n_layers += 1
        in_ch = 4 * ch
    self.out_features = in_ch
    self.Normalize_0 = Normalize(in_ch, norm_type)
    self.act = get_nonlinearity(nonlinearity)

  def forward(self, x: torch.Tensor,
              z: Optional[torch.Tensor] = None) -> torch.Tensor:
    for i in range(self.n_layers):
      layer = getattr(self, f'ResidualLayer_{i}')
      x = layer(x, z) if self.conditional else layer(x)
    return self.act(self.Normalize_0(x))


class ResNet(nn.Module):
  """Residual network over spectrogram-like [batch, time, freq, ch] inputs
  (3-D inputs gain a channel axis); frequency is downsampled 2x by the
  stem, 2x by the pool and by the stacks' strides.

  in_ch is the input's channel count (1 for a spectrogram), z_ch the
  conditioning's when conditional.
  """

  SIZES = {'small': (32, (2, 3, 4)), 'medium': (32, (3, 4, 6)),
           'large': (64, (3, 4, 6))}

  def __init__(self, size: str = 'large', norm_type: str = 'layer',
               conditional: bool = False, shift_only: bool = False,
               in_ch: int = 1, z_ch: int = 0):
    super().__init__()
    ch, blocks = self.SIZES[size]
    self.conditional = conditional
    self.Conv_0 = Conv(in_ch, 64, (7, 7), (1, 2))
    self.ResidualStack_0 = ResidualStack(
        64, [ch, 2 * ch, 4 * ch], blocks, [1, 2, 2], norm_type, conditional,
        shift_only, z_ch=z_ch)
    self.ResidualStack_1 = ResidualStack(
        self.ResidualStack_0.out_features, [8 * ch], [3], [2], norm_type,
        conditional, shift_only, z_ch=z_ch)
    self.out_features = self.ResidualStack_1.out_features

  def forward(self, x: torch.Tensor,
              z: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = self.Conv_0(ensure_4d(x))
    x = max_pool_same(x, (1, 3), (1, 2))
    for stack in (self.ResidualStack_0, self.ResidualStack_1):
      x = stack(x, z) if self.conditional else stack(x)
    return x
