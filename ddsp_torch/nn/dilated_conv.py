"""WaveNet-style dilated convolution stacks with optional FiLM conditioning.

Port of ddsp_tpu/nn/dilated_conv.py (polyphase_resample, PolyphaseResample,
DilatedConvStack) and of flax's SpectralNorm as the stack uses it.
Convolutions are 2-D over NHWC [batch, time, 1, ch], time being the conv
height, as there. Submodules keep flax's auto names (Conv_<i>,
ConvTranspose_<i>, Normalize_<i>, ConditionalNorm_<i>, SpectralNorm_<i>), so
a JAX tree loads as it is (utils/convert.py).

Precision: every convolution of a stack runs in full float32 forward and
backward (nn/resnet.py `conv2d`), whatever the process's TF32 setting; with
TF32 the ~40 residual layers of the midiae preset would land ~1e-3 apart
from the CPU port, enough to move the straight-through rounding of a pitch.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ddsp_torch.nn.layers import Normalize, ensure_4d
from ddsp_torch.nn.resnet import ConditionalNorm, Conv, ConvTranspose


def polyphase_resample(x: torch.Tensor, stride: int = 2,
                       resample_type: str = 'down',
                       trim_or_pad: str = 'pad') -> torch.Tensor:
  """Resample by interleaving time and channels (a lossless reshape).

  Downsampling: [batch, time, ch] -> [batch, time / stride, ch * stride],
  time padded with zeros (or trimmed) to a multiple of stride first.
  Upsampling: [batch, time, ch] -> [batch, time * stride, ch / stride],
  channels padded (or trimmed) first. 4-D [batch, time, 1, ch] input keeps
  its width axis.
  """
  is_4d = x.ndim == 4
  if is_4d:
    x = x[:, :, 0, :]
  n_time, n_ch = x.shape[1], x.shape[2]
  if resample_type == 'down':
    if trim_or_pad == 'pad':
      x = torch.nn.functional.pad(x, (0, 0, 0, (stride - n_time % stride) %
                                      stride))
    elif n_time % stride:
      x = x[:, :-(n_time % stride), :]
    n_time = x.shape[1]
    x = x.reshape(-1, n_time // stride, n_ch * stride)
  elif resample_type == 'up':
    if trim_or_pad == 'pad':
      x = torch.nn.functional.pad(x, (0, (stride - n_ch % stride) % stride))
    elif n_ch % stride:
      x = x[:, :, :-(n_ch % stride)]
    n_ch = x.shape[2]
    x = x.reshape(-1, n_time * stride, n_ch // stride)
  else:
    raise ValueError('`resample_type` must be either "up" or "down"')
  return x[:, :, None, :] if is_4d else x


class PolyphaseResample(nn.Module):
  """polyphase_resample as a module."""

  def __init__(self, stride: int = 2, resample_type: str = 'down',
               trim_or_pad: str = 'pad'):
    super().__init__()
    self.stride = stride
    self.resample_type = resample_type
    self.trim_or_pad = trim_or_pad

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return polyphase_resample(x, self.stride, self.resample_type,
                              self.trim_or_pad)


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
  return x * torch.rsqrt(torch.sum(x * x) + eps)


class SpectralNorm(nn.Module):
  """flax.linen.SpectralNorm of one conv's kernel (n_steps 1, eps 1e-12).

  The kernel, as a [prod(shape[:-1]), out] matrix, is divided by sigma, the
  estimate of its largest singular value from one power iteration that
  starts at the buffer `u` [1, out] (no gradient flows through the
  iteration). With update_stats (training) the new u and sigma are stored.
  The buffers are flax's 'batch_stats' '<layer>/kernel/u' and
  '<layer>/kernel/sigma' of this module; `u` is drawn from a unit normal.
  """

  jax_collection = 'batch_stats'

  def __init__(self, layer_name: str, features: int, eps: float = 1e-12):
    super().__init__()
    self.layer_name = layer_name
    self.eps = eps
    self.register_buffer('u', torch.empty(1, features))
    self.register_buffer('sigma', torch.ones(()))
    self.reset_parameters()

  def reset_parameters(self, generator: Optional[torch.Generator] = None):
    with torch.no_grad():
      self.u.normal_(generator=generator)
      self.sigma.fill_(1.0)

  def jax_collection_items(self) -> Dict[str, torch.Tensor]:
    return {f'{self.layer_name}/kernel/u': self.u,
            f'{self.layer_name}/kernel/sigma': self.sigma}

  def forward(self, kernel: torch.Tensor,
              update_stats: bool = False) -> torch.Tensor:
    value = kernel.reshape(-1, kernel.shape[-1])
    with torch.no_grad():
      v0 = _l2_normalize(self.u @ value.T, self.eps)
      u0 = _l2_normalize(v0 @ value, self.eps)
    sigma = (v0 @ value @ u0.T)[0, 0]
    value = value / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
    if update_stats:
      with torch.no_grad():
        self.u.copy_(u0)
        self.sigma.copy_(sigma)
    return value.reshape(kernel.shape)


class DilatedConvStack(nn.Module):
  """Stack of dilated convs with residual connections and conditioning.

  The output's time axis is (stacks // stacks_per_resample) *
  resample_stride times smaller (downsample) or larger (upsample) than the
  input's.

  Attributes:
    in_ch: Channels of the input (flax infers them).
    ch: Channels of every convolution.
    layers_per_stack: Conv layers per stack; the dilation grows as
      dilation**j with depth j in a stack (or shrinks, if `dilation` is
      negative).
    stacks: Number of stacks.
    kernel_size: Conv kernel size (time axis).
    dilation: Base of the dilation factor.
    norm_type: 'layer' / 'instance' / 'group' normalization, or None.
    resample_type: None, 'upsample' or 'downsample'.
    resample_stride: Stride of the resampling convs.
    stacks_per_resample: Stacks between resampling layers.
    resample_after_convolve: Resample after (True) or before (False) each
      group of stacks.
    spectral_norm: Spectral normalization of every conv kernel (flax's
      SpectralNorm, state in 'batch_stats', updated when training).
    ortho_init: Orthogonal kernel init (glorot_uniform otherwise).
    shift_only: FiLM shift-only conditioning.
    conditional: FiLM-condition the normalizations on z.
    z_ch: Channels of z (conditional stacks).
  """

  def __init__(self, in_ch: int, ch: int = 256, layers_per_stack: int = 5,
               stacks: int = 2, kernel_size: int = 3, dilation: int = 2,
               norm_type: Optional[str] = None,
               resample_type: Optional[str] = None, resample_stride: int = 1,
               stacks_per_resample: int = 1,
               resample_after_convolve: bool = True,
               spectral_norm: bool = False, ortho_init: bool = False,
               shift_only: bool = False, conditional: bool = False,
               z_ch: Optional[int] = None):
    super().__init__()
    if conditional and z_ch is None:
      raise ValueError('A conditional DilatedConvStack needs z_ch.')
    if resample_type not in (None, 'upsample', 'downsample'):
      raise ValueError(f'invalid resample type: {resample_type}, must be '
                       'either `upsample` or `downsample`.')
    self.out_features = ch
    self.conditional = conditional
    counts = {}
    init = 'orthogonal' if ortho_init else 'glorot_uniform'

    def add(kind: str, module: nn.Module) -> str:
      """Register module under flax's next auto name of its kind."""
      name = f'{kind}_{counts.get(kind, 0)}'
      counts[kind] = counts.get(kind, 0) + 1
      self.add_module(name, module)
      return name

    def conv(in_features, k, stride=1, dilation_rate=1, transpose=False):
      layer = (ConvTranspose if transpose else Conv)(
          in_features, ch, (k, 1), (stride, 1), (dilation_rate, 1),
          kernel_init=init, full_float32=True)
      name = add('ConvTranspose' if transpose else 'Conv', layer)
      if spectral_norm:
        return name, add('SpectralNorm', SpectralNorm(name, ch))
      return name, None

    def resample():
      if resample_type == 'downsample':
        return conv(ch, resample_stride, resample_stride)
      return conv(ch, resample_stride * 2, resample_stride, transpose=True)

    # The plan: ('conv', conv name, spectral norm name) and
    # ('res', conv name, spectral norm name, norm name), in call order.
    self._plan = [('conv',) + conv(in_ch, kernel_size)]
    for i in range(stacks):
      if (resample_type and not resample_after_convolve and
          i % stacks_per_resample == 0):
        self._plan.append(('conv',) + resample())
      for j in range(layers_per_stack):
        if dilation > 0:
          dilation_rate = int(dilation**j)
        else:
          # A negative base: the dilation decreases with depth instead.
          dilation_rate = int((-dilation)**(layers_per_stack - j - 1))
        names = conv(ch, kernel_size, 1, dilation_rate)
        if conditional:
          norm = add('ConditionalNorm', ConditionalNorm(
              ch, z_ch, norm_type=norm_type, shift_only=shift_only))
        else:
          norm = add('Normalize', Normalize(ch, norm_type))
        self._plan.append(('res',) + names + (norm,))
      if (resample_type and resample_after_convolve and
          (i + 1) % stacks_per_resample == 0):
        self._plan.append(('conv',) + resample())

  def _conv(self, conv_name: str, sn_name: Optional[str], x: torch.Tensor,
            training: bool) -> torch.Tensor:
    layer = getattr(self, conv_name)
    if sn_name is None:
      return layer(x)
    kernel = getattr(self, sn_name)(layer.kernel, update_stats=training)
    return layer(x, kernel=kernel)

  def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
              training: bool = False) -> torch.Tensor:
    """x [batch, time, in_ch] (or 4-D) -> [batch, time', ch]."""
    x = ensure_4d(x)
    if self.conditional:
      if z is None:
        raise ValueError('conditional DilatedConvStack requires z.')
      z = ensure_4d(z)
    for step in self._plan:
      if step[0] == 'conv':
        x = self._conv(step[1], step[2], x, training)
        continue
      y = self._conv(step[1], step[2], torch.relu(x), training)
      norm = getattr(self, step[3])
      x = x + (norm(y, z) if self.conditional else norm(y))
    return x[:, :, 0, :]
