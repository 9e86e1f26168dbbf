"""What every run shares: the fixed cache directories inside the
checkout, the card's description, the check that no JAX module was
loaded, and the result line."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'ddsp_tpu')


def fix_cache_dirs(root: Path) -> None:
  """Point the compilers' caches at fixed directories under build/ of the
  checkout (the kernels' nvcc libraries already build into
  build/ddsp_torch_kernels/), so that only a checkout's first run builds."""
  build = root / 'build'
  for var, sub in (('TRITON_CACHE_DIR', 'triton_cache'),
                   ('TORCHINDUCTOR_CACHE_DIR', 'inductor_cache')):
    path = build / sub
    path.mkdir(parents=True, exist_ok=True)
    os.environ[var] = str(path)


def forbidden_modules() -> List[str]:
  """Loaded modules whose top-level name is JAX's or the JAX package's."""
  return sorted(name for name in list(sys.modules)
                if name.split('.')[0] in FORBIDDEN)


def power_limit_w() -> float:
  """The card's power limit (nvidia-smi); NaN where it cannot be read."""
  try:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=power.limit',
         '--format=csv,noheader,nounits', '--id=0'],
        capture_output=True, text=True, timeout=30, check=True).stdout
    return float(out.split()[0])
  except (OSError, subprocess.SubprocessError, ValueError, IndexError):
    return math.nan


def device(count: int, memory_peak_bytes: int) -> Dict[str, Any]:
  import torch  # pylint: disable=g-import-not-at-top
  return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
          'count': count, 'memory_peak_bytes': int(memory_peak_bytes),
          'power_limit_w': power_limit_w()}


def _finite(x):
  if isinstance(x, float) and not math.isfinite(x):
    return None
  if isinstance(x, dict):
    return {k: _finite(v) for k, v in x.items()}
  if isinstance(x, list):
    return [_finite(v) for v in x]
  return x


def print_result(result: Dict[str, Any]) -> None:
  """The result as the last line of standard output; non-finite numbers
  are written as null."""
  print(json.dumps(_finite(result)), flush=True)
