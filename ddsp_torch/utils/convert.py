"""Load a JAX (flax) parameter tree, and its state collections, into the
port's modules.

The port's modules keep flax's parameter names and layouts, so a module's
`named_parameters()` are the tree's 'a/b/c' paths with '.' in place of '/'
(e.g. decoder.in_stack_0.Fc_0.Dense_0.kernel, [in, out] as flax stores it).
flax's other collections ('batch_stats' of SpectralNorm, 'vq_stats' of
VectorQuantization) are buffers of the modules that declare
`jax_collection` and `jax_collection_items()` (their keys under the
module's path).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ddsp_torch.ops.core import flatten


def collection_buffers(model: torch.nn.Module) -> Dict[str, Dict[str,
                                                                  torch.Tensor]]:
  """{collection: {'a/b/c': buffer}} of the model's flax state."""
  out = {}
  for prefix, module in model.named_modules():
    name = getattr(module, 'jax_collection', None)
    if name is None:
      continue
    path = prefix.replace('.', '/')
    for key, buf in module.jax_collection_items().items():
      out.setdefault(name, {})[f'{path}/{key}' if path else key] = buf
  return out


def _copy_strict(what: str, given: Dict[str, Any],
                 expected: Dict[str, torch.Tensor]) -> None:
  given = {k: np.asarray(v) for k, v in flatten(dict(given)).items()}
  missing = sorted(set(expected) - set(given))
  extra = sorted(set(given) - set(expected))
  if missing or extra:
    raise ValueError(f'JAX {what} do not match the model: missing '
                     f'{missing}, extra {extra}.')
  for key, p in expected.items():
    if given[key].shape != tuple(p.shape):
      raise ValueError(f'{what} {key}: JAX shape {given[key].shape} != '
                       f'model shape {tuple(p.shape)}.')


def load_jax_params(model: torch.nn.Module, params: Dict[str, Any],
                    **collections: Dict[str, Any]) -> None:
  """Copy a flax params tree (nested, or flat with 'a/b/c' keys) into model,
  and each collection given by name (batch_stats=..., vq_stats=...) into
  the buffers that hold it.

  Strict: every leaf is used exactly once and every parameter and
  collection buffer is set. Raises on a missing or extra key (a collection
  the model holds and the caller omits counts as missing) or a shape
  mismatch, before copying anything.
  """
  targets = {'params': (params, {name.replace('.', '/'): p
                                 for name, p in model.named_parameters()})}
  held = collection_buffers(model)
  for name in sorted(set(held) | set(collections)):
    targets[name] = (collections.get(name) or {}, held.get(name, {}))
  for what, (given, expected) in targets.items():
    _copy_strict(what, given, expected)
  with torch.no_grad():
    for given, expected in targets.values():
      flat = flatten(dict(given))
      for key, p in expected.items():
        p.copy_(torch.from_numpy(np.asarray(flat[key]).astype(np.float32)))
