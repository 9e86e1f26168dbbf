"""Where the port's training checkpoints live: one ckpt-<step>.pt a save.

Trainer (train/trainer.py) writes and restores them; AutoencoderInference
(infer/inference.py) serves the newest one of a train directory.
"""

from __future__ import annotations

import os
import re
from typing import List

_CKPT_RE = re.compile(r'ckpt-(\d+)\.pt$')


def checkpoint_steps(directory: str) -> List[int]:
  """Steps of the checkpoints in `directory`, ascending."""
  if not os.path.isdir(directory):
    return []
  found = (_CKPT_RE.match(name) for name in os.listdir(directory))
  return sorted(int(m.group(1)) for m in found if m)


def checkpoint_path(directory: str, step: int) -> str:
  return os.path.join(directory, f'ckpt-{step:08d}.pt')
