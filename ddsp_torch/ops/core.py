"""Core helpers, unit conversions and the control nonlinearity.

Port of ddsp_tpu/ops/core.py: the subset the serving path uses.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

DB_RANGE = 80.0


def torch_float32(x: Any, device=None) -> torch.Tensor:
  """x as a float32 tensor (on `device` when it is not a tensor yet)."""
  if isinstance(x, torch.Tensor):
    return x.to(torch.float32)
  return torch.as_tensor(np.asarray(x, np.float32), device=device)



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


def pad_axis(x: torch.Tensor, padding=(0, 0), axis: int = 0) -> torch.Tensor:
  """Zero-pad a single axis by (before, after)."""
  axis = axis % x.ndim
  pads = [0, 0] * (x.ndim - axis - 1) + [int(padding[0]), int(padding[1])]
  return torch.nn.functional.pad(x, pads)


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
