"""Core helpers, unit conversions and the control nonlinearities.

Port of ddsp_tpu/ops/core.py.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, List, Sequence, Union

import numpy as np
import torch

__all__ = [
    'Array', 'Number', 'DB_RANGE', 'full_float32', 'torch_float32', 'f32',
    'make_iterable', 'to_dict', 'nested_keys', 'nested_lookup', 'flatten',
    'leaf_key', 'map_shape', 'pad_axis', 'diff', 'nan_to_num', 'safe_divide',
    'safe_log', 'logb', 'log10', 'log_scale', 'soft_limit',
    'gradient_reversal', 'amplitude_to_db', 'power_to_db', 'db_to_amplitude',
    'db_to_power', 'midi_to_hz', 'hz_to_midi', 'unit_to_midi',
    'midi_to_unit', 'unit_to_hz', 'hz_to_unit', 'hz_to_bark', 'bark_to_hz',
    'hz_to_mel', 'mel_to_hz', 'hz_to_erb', 'exp_sigmoid', 'sym_exp_sigmoid',
    'frequencies_softmax', 'frequencies_sigmoid', 'get_deviation_hz',
    'frequencies_critical_bands']

Array = torch.Tensor
Number = Union[float, int, np.ndarray, Array]

DB_RANGE = 80.0


@contextlib.contextmanager
def full_float32():
  """cuDNN convolutions and matmuls in full float32 (no TF32) inside the
  block, whatever the process set; the settings are restored after."""
  cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
  saved = (cudnn.allow_tf32, matmul.allow_tf32)
  cudnn.allow_tf32 = matmul.allow_tf32 = False
  try:
    yield
  finally:
    cudnn.allow_tf32, matmul.allow_tf32 = saved


def torch_float32(x: Any, device=None) -> torch.Tensor:
  """x as a float32 tensor (on `device` when it is not a tensor yet)."""
  if isinstance(x, torch.Tensor):
    return x.to(torch.float32)
  return torch.as_tensor(np.asarray(x, np.float32), device=device)


# The JAX package's short alias (its f32 = jnp_float32).
f32 = torch_float32


def make_iterable(x: Any) -> Sequence[Any]:
  """None -> [], a single tensor or scalar -> [x], lists and tuples as they are."""
  if x is None:
    return []
  if isinstance(x, (np.ndarray, torch.Tensor)):
    return [x]
  if isinstance(x, (list, tuple)):
    return x
  try:
    iter(x)
  except TypeError:
    return [x]
  return x


def to_dict(x: Any, keys: Sequence[str]) -> Dict[str, Any]:
  """Zip output values with their key names into a dict (length-checked)."""
  if isinstance(x, dict):
    return x
  x = make_iterable(x)
  if len(keys) != len(x):
    raise ValueError(f'Keys: {keys} must be the same length as {x}')
  return dict(zip(keys, x))


def nested_keys(nested_dict: Dict[str, Any], delimiter: str = '/',
                prefix: str = '') -> List[str]:
  """All leaf paths of a nested dict as 'a/b/c' strings."""
  keys = []
  for k, v in nested_dict.items():
    key = k if not prefix else f'{prefix}{delimiter}{k}'
    if isinstance(v, dict):
      keys += nested_keys(v, delimiter=delimiter, prefix=key)
    else:
      keys.append(key)
  return keys


def nested_lookup(nested_key: str, nested_dict: Dict[str, Any],
                  delimiter: str = '/') -> Any:
  """Look up a slash-separated path ('a/b/c') in a nested dict."""
  value = nested_dict
  for key in nested_key.split(delimiter):
    try:
      value = value[key]
    except (KeyError, TypeError) as e:
      raise KeyError(
          f"Key '{key}' as a part of nested key '{nested_key}' not found "
          f'during nested dictionary lookup, out of available keys: '
          f'{nested_keys(nested_dict)}') from e
  return value


def flatten(tree: Dict[str, Any], prefix: str = '') -> Dict[str, Any]:
  """Nested dict -> flat dict with 'a/b/c' keys."""
  flat = {}
  for k, v in tree.items():
    key = f'{prefix}/{k}' if prefix else k
    if isinstance(v, dict):
      flat.update(flatten(v, key))
    else:
      flat[key] = v
  return flat


def leaf_key(nested_key: str, delimiter: str = '/') -> str:
  """Last component of a slash-separated key path."""
  return nested_key.split(delimiter)[-1]


def map_shape(x: Dict[str, Any]) -> Dict[str, Any]:
  """Shape of every tensor leaf in a (nested) dict, as lists."""
  if isinstance(x, dict):
    return {k: map_shape(v) for k, v in x.items()}
  if isinstance(x, (list, tuple)):
    return type(x)(map_shape(v) for v in x)
  return list(x.shape) if isinstance(x, torch.Tensor) else list(np.shape(x))


def pad_axis(x: torch.Tensor, padding=(0, 0), axis: int = 0) -> torch.Tensor:
  """Zero-pad a single axis by (before, after)."""
  axis = axis % x.ndim
  pads = [0, 0] * (x.ndim - axis - 1) + [int(padding[0]), int(padding[1])]
  return torch.nn.functional.pad(x, pads)


def diff(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
  """First-order difference x[i+1] - x[i] along an axis (length shrinks by 1)."""
  if axis >= x.ndim:
    raise ValueError(f'Invalid axis index: {axis} for tensor with only '
                     f'{x.ndim} axes.')
  axis = axis % x.ndim
  size = x.shape[axis]
  return x.narrow(axis, 1, size - 1) - x.narrow(axis, 0, size - 1)


def nan_to_num(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
  """Substitute a fixed value wherever x is NaN."""
  return torch.where(torch.isnan(x), torch.full_like(x, value), x)


def safe_divide(numerator: torch.Tensor, denominator: torch.Tensor,
                eps: float = 1e-7) -> torch.Tensor:
  """Division that swaps exact-zero denominators for eps first."""
  safe_denominator = torch.where(denominator == 0.0,
                                 torch.full_like(denominator, eps),
                                 denominator)
  return numerator / safe_denominator


def safe_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  """log(x) with non-positive inputs clamped to eps beforehand."""
  return torch.log(torch.where(x <= 0.0, torch.full_like(x, eps), x))


def logb(x: torch.Tensor, base: float = 2.0, eps: float = 1e-5):
  """log_base(x) via the ratio of two safe_logs."""
  base_t = torch.full_like(x, base)
  return safe_divide(safe_log(x, eps), safe_log(base_t, eps), eps)


def log10(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  """Base-10 logarithm (safe at zero)."""
  return logb(x, base=10.0, eps=eps)


def log_scale(x, min_x: float, max_x: float) -> torch.Tensor:
  """Map [-1, 1] onto [min_x, max_x] with geometric (log-domain) spacing."""
  x = (torch_float32(x) + 1.0) / 2.0
  return torch.exp((1.0 - x) * float(np.log(min_x)) +
                   x * float(np.log(max_x)))


def soft_limit(x: torch.Tensor, x_min: float = 0.0,
               x_max: float = 1.0) -> torch.Tensor:
  """Smooth double-softplus saturation onto [x_min, x_max]."""
  softplus = torch.nn.functional.softplus
  return softplus(x) + x_min - softplus(x - (x_max - x_min))


class _GradientReversal(torch.autograd.Function):
  """Identity forward; the backward negates the gradient."""

  @staticmethod
  def forward(ctx, x):  # pylint: disable=arguments-differ
    return x.view_as(x)

  @staticmethod
  def backward(ctx, grad):  # pylint: disable=arguments-differ
    return -grad


def gradient_reversal(x: torch.Tensor) -> torch.Tensor:
  """Forward identity whose gradient is negated (adversarial branches)."""
  return _GradientReversal.apply(x)


def amplitude_to_db(amplitude, ref_db: float = 0.0,
                    range_db: float = DB_RANGE) -> torch.Tensor:
  """Converts amplitude in linear scale to power in decibels."""
  power = torch_float32(amplitude)**2.0
  return power_to_db(power, ref_db=ref_db, range_db=range_db)


def power_to_db(power, ref_db: float = 0.0,
                range_db: float = DB_RANGE) -> torch.Tensor:
  """Converts power from linear scale to decibels."""
  pmin = 10**-(range_db / 10.0)
  power = torch.clamp(torch_float32(power), min=pmin)
  db = 10.0 * log10(power) - ref_db
  return torch.clamp(db, min=-range_db)


def db_to_amplitude(db) -> torch.Tensor:
  """Converts power in decibels to amplitude in linear scale."""
  return db_to_power(torch_float32(db) / 2.0)


def db_to_power(db) -> torch.Tensor:
  """Converts power from decibels to linear scale."""
  return 10.0**(torch_float32(db) / 10.0)


def midi_to_hz(notes, midi_zero_silence: bool = False) -> torch.Tensor:
  """MIDI pitch to frequency in hertz."""
  notes = torch_float32(notes)
  hz = 440.0 * (2.0**((notes - 69.0) / 12.0))
  if midi_zero_silence:
    hz = torch.where(notes == 0.0, torch.zeros_like(hz), hz)
  return hz


def hz_to_midi(frequencies) -> torch.Tensor:
  """Frequency in hertz to MIDI pitch (0 Hz -> MIDI 0)."""
  frequencies = torch_float32(frequencies)
  a4 = torch.full_like(frequencies, 440.0)
  notes = 12.0 * (logb(frequencies, 2.0) - logb(a4, 2.0)) + 69.0
  return torch.where(frequencies <= 0.0, torch.zeros_like(notes), notes)


def unit_to_midi(unit, midi_min=20.0, midi_max=90.0,
                 clip: bool = False) -> torch.Tensor:
  """Map the unit interval [0, 1] to MIDI notes."""
  unit = torch_float32(unit)
  if clip:
    unit = torch.clamp(unit, 0.0, 1.0)
  return midi_min + (midi_max - midi_min) * unit


def midi_to_unit(midi, midi_min=20.0, midi_max=90.0,
                 clip: bool = False) -> torch.Tensor:
  """Map MIDI notes to the unit interval [0, 1]."""
  unit = (torch_float32(midi) - midi_min) / (midi_max - midi_min)
  return torch.clamp(unit, 0.0, 1.0) if clip else unit


def unit_to_hz(unit, hz_min, hz_max, clip: bool = False) -> torch.Tensor:
  """Map the unit interval [0, 1] to [hz_min, hz_max], logarithmically."""
  unit = torch_float32(unit)
  return midi_to_hz(unit_to_midi(unit,
                                 midi_min=_midi_of(hz_min, unit),
                                 midi_max=_midi_of(hz_max, unit), clip=clip))


def hz_to_unit(hz, hz_min, hz_max, clip: bool = False) -> torch.Tensor:
  """Map [hz_min, hz_max] to the unit interval [0, 1], logarithmically."""
  midi = hz_to_midi(hz)
  return midi_to_unit(midi, midi_min=_midi_of(hz_min, midi),
                      midi_max=_midi_of(hz_max, midi), clip=clip)


def _midi_of(hz, like: torch.Tensor) -> torch.Tensor:
  """hz_to_midi of a bound, as a tensor on `like`'s device."""
  return hz_to_midi(torch_float32(hz, device=like.device).to(like.device))


def hz_to_bark(hz) -> torch.Tensor:
  """Frequency in hertz to Bark scale (Traunmuller 1990)."""
  return 26.81 / (1.0 + (1960.0 / torch_float32(hz))) - 0.53


def bark_to_hz(bark) -> torch.Tensor:
  """Bark scale to frequency in hertz (Traunmuller 1990)."""
  return 1960.0 / (26.81 / (torch_float32(bark) + 0.53) - 1.0)


def hz_to_mel(hz) -> torch.Tensor:
  """Frequency in hertz to mel scale (HTK convention)."""
  return 2595.0 * logb(1.0 + torch_float32(hz) / 700.0, 10.0)


def mel_to_hz(mel) -> torch.Tensor:
  """Mel scale to frequency in hertz (HTK convention)."""
  return 700.0 * (10.0**(torch_float32(mel) / 2595.0) - 1.0)


def hz_to_erb(hz) -> torch.Tensor:
  """Equivalent Rectangular Bandwidth (Moore & Glasberg 1996)."""
  return 0.108 * torch_float32(hz) + 24.7


# log(exponent) in float32, as jnp.log(jnp_float32(exponent)) gives it.
def _f32_log(exponent: float) -> float:
  return float(np.log(np.float32(exponent)))


def exp_sigmoid(x: torch.Tensor, exponent: float = 10.0,
                max_value: float = 2.0, threshold: float = 1e-7):
  """Exponentiated sigmoid, bounded to [threshold, max_value + threshold].

  The canonical DDSP control nonlinearity for amplitudes and magnitudes.
  """
  x = torch_float32(x)
  return max_value * torch.sigmoid(x)**_f32_log(exponent) + threshold


def sym_exp_sigmoid(x: torch.Tensor, width: float = 8.0) -> torch.Tensor:
  """Symmetrical version of exp_sigmoid centered at (0, 1e-7)."""
  x = torch_float32(x)
  return exp_sigmoid(width * (torch.abs(x) / 2.0 - 1.0))


def _add_depth_axis(freqs: torch.Tensor, depth: int = 1) -> torch.Tensor:
  """[batch, time, sinusoids * depth] -> [batch, time, sinusoids, depth]."""
  n_batch, n_time, n_combined = freqs.shape
  return freqs.reshape(n_batch, n_time, int(n_combined) // depth, depth)


def frequencies_softmax(freqs: torch.Tensor, depth: int = 1,
                        hz_min: float = 20.0,
                        hz_max: float = 8000.0) -> torch.Tensor:
  """Softmax over `depth` bins per sinusoid, scaled logarithmically to
  frequencies in hertz [batch, time, n_sinusoids].

  freqs: [batch, time, n_sinusoids * depth] or [batch, time, n_sinusoids,
  depth] network outputs.
  """
  if freqs.ndim == 3:
    freqs = _add_depth_axis(freqs, depth)
  else:
    depth = int(freqs.shape[-1])
  f_probs = torch.softmax(freqs, dim=-1)
  unit_bins = torch.linspace(0.0, 1.0, depth, device=freqs.device)
  f_unit = torch.sum(unit_bins * f_probs, dim=-1)
  return unit_to_hz(f_unit, hz_min=hz_min, hz_max=hz_max)


def frequencies_sigmoid(freqs: torch.Tensor, depth: int = 1,
                        hz_min: float = 0.0,
                        hz_max: float = 8000.0) -> torch.Tensor:
  """Sum of `depth` sigmoids per sinusoid, each over its own band of a
  partition of [hz_min, hz_max] in factors of 2, logarithmically scaled;
  [batch, time, n_sinusoids] in hertz."""
  if freqs.ndim == 3:
    freqs = _add_depth_axis(freqs, depth)
  else:
    depth = int(freqs.shape[-1])
  f_probs = torch.sigmoid(freqs)
  hz_scales = []
  hz_min_copy = hz_min
  remainder = hz_max - hz_min
  scale_factor = remainder**(1.0 / depth)
  for i in range(depth):
    if i == depth - 1:
      # The last component spans the minimum to the remainder.
      hz_max = remainder
      hz_min = hz_min_copy
    else:
      hz_max = remainder * (1.0 - 1.0 / scale_factor)
      hz_min = 0
      remainder -= hz_max
    hz_scales.append(unit_to_hz(f_probs[..., i], hz_min=hz_min,
                                hz_max=hz_max))
  return torch.sum(torch.stack(hz_scales, dim=-1), dim=-1)


def get_deviation_hz(midi_interval: float, frequency_hz) -> torch.Tensor:
  """A MIDI interval as a deviation in hertz at a given frequency."""
  frequency_hz = torch_float32(frequency_hz)
  return midi_to_hz(hz_to_midi(frequency_hz) + midi_interval) - frequency_hz


def frequencies_critical_bands(freqs: torch.Tensor, depth: int = 1,
                               depth_scale: float = 10.0,
                               bandwidth_scale: float = 1.0,
                               hz_min: float = 20.0, hz_max: float = 8000.0,
                               scale: str = 'bark') -> torch.Tensor:
  """Centre frequencies evenly spaced on the bark or mel scale, each moved
  by a tanh-bounded deviation of one ERB (depth components at scales
  depth_scale**-i), soft-limited to [hz_min, hz_max]."""
  if freqs.ndim == 3:
    freqs = _add_depth_axis(freqs, depth)
  else:
    depth = int(freqs.shape[-1])
  n_sinusoids = int(freqs.shape[-2])
  dev = freqs.device
  if scale == 'bark':
    lo, hi = float(hz_to_bark(hz_min)), float(hz_to_bark(hz_max))
    f_center = bark_to_hz(torch.linspace(lo, hi, n_sinusoids, device=dev))
  else:
    lo, hi = float(hz_to_mel(hz_min)), float(hz_to_mel(hz_max))
    f_center = mel_to_hz(torch.linspace(lo, hi, n_sinusoids, device=dev))
  bw = hz_to_erb(f_center)
  depth_modifier = depth_scale**-torch.arange(depth, dtype=torch.float32,
                                              device=dev)
  modifier = torch.sum(torch.tanh(freqs) * depth_modifier, dim=-1)
  f_modifier = bandwidth_scale * bw * modifier
  return soft_limit(f_center + f_modifier, hz_min, hz_max)
