"""Preset registry and the 'operative spec' artifact.

Port of ddsp_tpu/utils/registry.py. A spec is operative_spec.json, holding
{'preset': name, 'kwargs': {...}}, written beside checkpoints (save_spec)
and exported artifacts (infer/export.py), by the port or the JAX package; it
rebuilds (and may mutate) the exact model.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional

import torch

from ddsp_torch.utils.device import DeviceLike, resolve_device

_PRESETS: Dict[str, Callable[..., Any]] = {}

SPEC_FILENAME = 'operative_spec.json'


def register_preset(name: str):
  """Decorator registering a model factory under a preset name."""

  def wrap(fn):
    _PRESETS[name] = fn
    return fn

  return wrap


def get_preset(name: str) -> Callable[..., Any]:
  # Importing configs registers the built-in presets.
  import ddsp_torch.configs  # noqa: F401  pylint: disable=g-import-not-at-top
  if name not in _PRESETS:
    raise KeyError(f'Unknown preset {name!r}. Available: '
                   f'{sorted(_PRESETS)}')
  return _PRESETS[name]


def list_presets() -> List[str]:
  """The registered presets' names, sorted."""
  import ddsp_torch.configs  # noqa: F401  pylint: disable=g-import-not-at-top
  return sorted(_PRESETS)


def init_parameters(model: torch.nn.Module, seed: int) -> None:
  """Re-draw every parameter from a torch.Generator seeded with `seed`."""
  generator = torch.Generator().manual_seed(seed)
  for module in model.modules():
    reset = getattr(module, 'reset_parameters', None)
    if reset is not None:
      reset(generator=generator)


def build_model(name: str, device: DeviceLike = None,
                seed: Optional[int] = None, **kwargs):
  """Instantiate a registered preset on `device` (CUDA by default).

  With a seed, parameters come from a torch.Generator seeded with it.
  """
  device = resolve_device(device)
  model = get_preset(name)(**kwargs)
  if seed is not None:
    init_parameters(model, seed)
  return model.to(device)


def save_spec(save_dir: str, preset: str, **kwargs) -> str:
  """Write the (preset, kwargs) model spec next to checkpoints."""
  os.makedirs(save_dir, exist_ok=True)
  path = os.path.join(save_dir, SPEC_FILENAME)
  with open(path, 'w') as f:
    json.dump({'preset': preset, 'kwargs': kwargs}, f, indent=2,
              sort_keys=True)
  return path


def load_spec(save_dir: str) -> Dict[str, Any]:
  """Read the model spec from a train or export directory."""
  with open(os.path.join(save_dir, SPEC_FILENAME)) as f:
    return json.load(f)


def model_from_spec(save_dir: str, device: DeviceLike = None, **overrides):
  """Rebuild the model from a saved spec, with optional mutations.

  As in the JAX package, an override the preset does not accept is dropped
  with a warning, so one mutation set serves every preset.
  """
  spec = load_spec(save_dir)
  kwargs = dict(spec['kwargs'])
  kwargs.update(overrides)
  sig_params = inspect.signature(get_preset(spec['preset'])).parameters
  takes_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in sig_params.values())
  if not takes_var_kw:
    dropped = sorted(set(kwargs) - set(sig_params))
    if dropped:
      logging.getLogger('ddsp_torch').warning(
          'model_from_spec: preset %r does not accept %s; dropping those '
          'overrides.', spec['preset'], dropped)
      kwargs = {k: v for k, v in kwargs.items() if k in sig_params}
  return build_model(spec['preset'], device=device, **kwargs)
