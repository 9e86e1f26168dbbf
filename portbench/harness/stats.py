"""The benchmark's statistics."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def p95(values: Sequence[float]) -> float:
  """The 95th percentile of all values (linear between order
  statistics)."""
  return float(np.percentile(np.asarray(values, np.float64), 95))


def rel_l2(value: torch.Tensor, reference: torch.Tensor) -> float:
  """|value - reference| / |reference| in float64."""
  value, reference = value.double(), reference.double()
  return float((value - reference).norm() / reference.norm())


def spectrum_gap(value: torch.Tensor, reference: torch.Tensor,
                 size: int = 2048) -> float:
  """Relative L2 distance of the magnitudes of two audio signals' STFTs
  (hann frames of `size` from the first sample, hop size / 4), in
  float64."""
  window = torch.hann_window(size, dtype=torch.float64)
  mags = [torch.stft(x.double().reshape(-1), size, size // 4, window=window,
                     center=False, return_complex=True).abs()
          for x in (value, reference)]
  return float((mags[0] - mags[1]).norm() / mags[1].norm())
