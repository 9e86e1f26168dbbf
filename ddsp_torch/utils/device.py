"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
  """The device an entry point runs on: CUDA unless the caller says otherwise.

  Raises instead of falling back to the CPU, so a run that was meant for the
  GPU never silently measures or serves on the host.
  """
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          'ddsp_torch entry points run on CUDA by default, and no CUDA '
          "device is available; pass device='cpu' to run on the CPU.")
    return torch.device('cuda')
  return torch.device(device)
