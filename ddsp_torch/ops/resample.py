"""Frame-rate to audio-rate resampling of control signals.

Port of ddsp_tpu/ops/resample.py. Index math follows the legacy
tf.image.resize conventions (align_corners = not add_endpoint,
half_pixel_centers=False), computed in float64 numpy at trace time exactly
as the JAX package does, so both give the same gather indices and weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ddsp_torch.ops.core import torch_float32


def _source_coords(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
  """Legacy tf.image.resize source coordinates for each output index."""
  if align_corners and n_out > 1:
    scale = (n_in - 1) / (n_out - 1)
  else:
    scale = n_in / n_out
  return np.arange(n_out, dtype=np.float64) * scale


def _take(x: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
  return torch.index_select(
      x, 1, torch.as_tensor(idx.astype(np.int64), device=x.device))


def _weights(w: np.ndarray, shape, x: torch.Tensor) -> torch.Tensor:
  return torch.as_tensor(w.astype(np.float32), device=x.device).reshape(shape)


def _interp_nearest(x, n_out: int, align_corners: bool):
  n_in = x.shape[1]
  src = _source_coords(n_in, n_out, align_corners)
  # Legacy resize rounds halves away from zero (roundf) when aligning corners.
  idx = np.floor(src + 0.5) if align_corners else np.floor(src)
  return _take(x, np.minimum(idx, n_in - 1))


def _interp_linear(x, n_out: int, align_corners: bool):
  n_in = x.shape[1]
  src = _source_coords(n_in, n_out, align_corners)
  lo = np.floor(src).astype(np.int64)
  frac = (src - lo).astype(np.float32)
  lo = np.clip(lo, 0, n_in - 1)
  hi = np.clip(lo + 1, 0, n_in - 1)
  trailing = (1,) * (x.ndim - 2)

  # Integer-ratio upsampling: when the gather indices form regular hop
  # blocks, build the output as broadcast segments (same values as the
  # gathers, with the same float32 frac).
  if n_out % n_in == 0 and n_out > n_in:
    hop = n_out // n_in
    regular = (np.all(lo.reshape(n_in, hop) == np.arange(n_in)[:, None]) and
               np.all(hi.reshape(n_in, hop) ==
                      np.minimum(np.arange(n_in) + 1, n_in - 1)[:, None]))
    if regular:
      ext = torch.cat([x, x[:, -1:]], dim=1)
      x_lo = ext[:, :-1].unsqueeze(2)
      x_hi = ext[:, 1:].unsqueeze(2)
      w = _weights(frac, (1, n_in, hop) + trailing, x)
      seg = x_lo * (1.0 - w) + x_hi * w
      return seg.reshape((x.shape[0], n_out) + tuple(x.shape[2:]))

  w = _weights(frac, (1, n_out) + trailing, x)
  return _take(x, lo) * (1.0 - w) + _take(x, hi) * w


def _cubic_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
  """Keys cubic convolution weights for 4 taps (legacy bicubic, A=-0.75)."""
  x = frac
  w0 = a * (x + 1)**3 - 5 * a * (x + 1)**2 + 8 * a * (x + 1) - 4 * a
  w1 = (a + 2) * x**3 - (a + 3) * x**2 + 1
  w2 = (a + 2) * (1 - x)**3 - (a + 3) * (1 - x)**2 + 1
  w3 = a * (2 - x)**3 - 5 * a * (2 - x)**2 + 8 * a * (2 - x) - 4 * a
  return np.stack([w0, w1, w2, w3], axis=-1)


def _interp_cubic(x, n_out: int, align_corners: bool):
  n_in = x.shape[1]
  src = _source_coords(n_in, n_out, align_corners)
  lo = np.floor(src).astype(np.int64)
  weights = _cubic_weights(src - lo).astype(np.float32)  # [n_out, 4]
  shape = (1, n_out) + (1,) * (x.ndim - 2)
  out = None
  for tap in range(4):
    x_tap = _take(x, np.clip(lo + tap - 1, 0, n_in - 1))
    term = x_tap * _weights(weights[:, tap], shape, x)
    out = term if out is None else out + term
  return out


def upsample_with_windows(inputs: torch.Tensor, n_timesteps: int,
                          add_endpoint: bool = True) -> torch.Tensor:
  """Upsample frames [batch, n_frames, ch] with 50%-overlapping hann windows.

  After trimming the half windows at the ends, the overlap-add output is
  (n_frames - 1) hop-sized segments x[i+1] * rise + x[i] * fall.
  """
  inputs = torch_float32(inputs)
  if inputs.ndim != 3:
    raise ValueError('Upsample_with_windows() only supports 3 dimensions, '
                     f'not {tuple(inputs.shape)}.')
  if add_endpoint:
    inputs = torch.cat([inputs, inputs[:, -1:, :]], dim=1)

  n_frames = int(inputs.shape[1])
  n_intervals = n_frames - 1
  if n_frames >= n_timesteps:
    raise ValueError('Upsample with windows cannot be used for downsampling. '
                     f'More input frames ({n_frames}) than output timesteps '
                     f'({n_timesteps})')
  if n_timesteps % n_intervals != 0.0:
    minus_one = '' if add_endpoint else ' - 1'
    raise ValueError(
        'For upsampling, the target number of timesteps must be divisible '
        f'by the number of input frames{minus_one}. (timesteps:{n_timesteps},'
        f' frames:{n_frames}, add_endpoint={add_endpoint}).')

  hop_size = n_timesteps // n_intervals
  window_length = 2 * hop_size
  t = torch.arange(window_length, dtype=torch.float32, device=inputs.device)
  window = 0.5 - 0.5 * torch.cos(2.0 * np.pi * t / window_length)
  rise = window[:hop_size]
  fall = window[hop_size:]
  x = inputs.unsqueeze(-1)  # [batch, n_frames, channels, 1]
  segments = x[:, 1:] * rise + x[:, :-1] * fall
  # [batch, n_intervals, channels, hop] -> [batch, n_timesteps, channels]
  segments = segments.permute(0, 1, 3, 2)
  return segments.reshape(segments.shape[0], n_timesteps, segments.shape[-1])


def resample(inputs: torch.Tensor, n_timesteps: int, method: str = 'linear',
             add_endpoint: bool = True) -> torch.Tensor:
  """Interpolate [n_frames], [b, n_frames], [b, n_frames, ch] or
  [b, n_frames, n_freq, ch] to n_timesteps along the time axis.

  method is one of 'nearest', 'linear', 'cubic', 'window' ('window' is
  hann overlap-add, upsampling only, not for 4-D inputs).
  """
  inputs = torch_float32(inputs)
  is_1d, is_2d, is_4d = inputs.ndim == 1, inputs.ndim == 2, inputs.ndim == 4
  if is_1d:
    inputs = inputs[None, :, None]
  elif is_2d:
    inputs = inputs[:, :, None]

  align_corners = not add_endpoint
  if method == 'nearest':
    outputs = _interp_nearest(inputs, n_timesteps, align_corners)
  elif method == 'linear':
    outputs = _interp_linear(inputs, n_timesteps, align_corners)
  elif method == 'cubic':
    outputs = _interp_cubic(inputs, n_timesteps, align_corners)
  elif method == 'window':
    if is_4d:
      raise ValueError("method 'window' is not supported for 4-D inputs.")
    outputs = upsample_with_windows(inputs, n_timesteps, add_endpoint)
  else:
    raise ValueError(f'Method ({method}) is invalid. Must be one of '
                     "['nearest', 'linear', 'cubic', 'window'].")

  if is_1d:
    return outputs[0, :, 0]
  if is_2d:
    return outputs[:, :, 0]
  return outputs


def center_crop(audio: torch.Tensor, frame_size: int) -> torch.Tensor:
  """Remove the padding of centered framing: frame_size // 2 samples from
  each end of the time axis (dim 1)."""
  pad_amount = int(frame_size // 2)
  if pad_amount == 0:
    return audio
  return audio[:, pad_amount:-pad_amount]
