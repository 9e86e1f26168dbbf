"""Load a JAX (flax) parameter tree into the port's modules.

The port's modules keep flax's parameter names and layouts, so a module's
`named_parameters()` are the tree's 'a/b/c' paths with '.' in place of '/'
(e.g. decoder.in_stack_0.Fc_0.Dense_0.kernel, [in, out] as flax stores it).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ddsp_torch.ops.core import flatten


def load_jax_params(model: torch.nn.Module, params: Dict[str, Any]) -> None:
  """Copy a flax params tree (nested, or flat with 'a/b/c' keys) into model.

  Strict: every leaf is used exactly once and every parameter is set. Raises
  on a missing or extra key or a shape mismatch, before copying anything.
  """
  given = {k: np.asarray(v) for k, v in flatten(dict(params)).items()}
  expected = {name.replace('.', '/'): p
              for name, p in model.named_parameters()}
  missing = sorted(set(expected) - set(given))
  extra = sorted(set(given) - set(expected))
  if missing or extra:
    raise ValueError(f'JAX params do not match the model: missing '
                     f'{missing}, extra {extra}.')
  for key, p in expected.items():
    if given[key].shape != tuple(p.shape):
      raise ValueError(f'{key}: JAX shape {given[key].shape} != model shape '
                       f'{tuple(p.shape)}.')
  with torch.no_grad():
    for key, p in expected.items():
      p.copy_(torch.from_numpy(given[key].astype(np.float32)))
