"""The numbers that decide `correct`, each against its limit.

A training cell compares, with the reference's three steps from the same
weights, batches and noise: the first step's loss and its terms, the norm
of each leaf's first gradient as the optimiser took it, and the norm of
each leaf's change over the three steps. A leaf's gap is |program -
reference| over the larger of the reference's norm of that leaf and of
the median leaf, and the median leaf's gap is compared: the spectral
loss's log-magnitude term passes 1 / |X| of near-silent bins into the
gradients, so the worst leaf (solo_instrument's reverb impulse response,
DDSP-inv's convolutions and f0 head) and the later steps' losses move
with float32 rounding of the audio, in the reference alone as much as
between program and reference (PERF.md gives the readings). A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone and is left out of the change. A served cell compares
each sampled answer with the reference's, as the relative L2 distance of
the magnitudes of their spectrograms.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Mapping, Sequence

QUIET_LEAF = 1e-3


def loss_gap(program: float, reference: float) -> float:
  """|program - reference| / |reference|."""
  return abs(program - reference) / abs(reference)


def leaf_gaps(program: Mapping[str, float], reference: Mapping[str, float],
              leaves: Sequence[str]) -> Sequence[float]:
  """Each leaf's gap of norms (see the module's docstring)."""
  median = statistics.median(reference[k] for k in reference)
  return [abs(program[k] - reference[k]) / max(reference[k], median)
          for k in leaves]


def median_leaf_gap(program: Mapping[str, float],
                    reference: Mapping[str, float],
                    leaves: Sequence[str]) -> float:
  gaps = leaf_gaps(program, reference, leaves)
  return statistics.median(gaps) if gaps else math.inf


def moving_leaves(first_grad_norms: Mapping[str, float]) -> Sequence[str]:
  """The leaves whose reference gradient is not nought to rounding."""
  median = statistics.median(first_grad_norms.values())
  return [k for k, v in first_grad_norms.items() if v >= QUIET_LEAF * median]


def verdict(values: Dict[str, float], limits: Mapping[str, float]) -> bool:
  """Every number finite and within its limit; a missing number fails."""
  return all(k in values and math.isfinite(values[k]) and
             values[k] <= limits[k] for k in limits)


def report(values: Dict[str, float], limits: Mapping[str, float]) -> Dict:
  """{name: {'value', 'limit'}}, also printed as the last lines of
  standard error."""
  out = {k: {'value': values.get(k, math.nan), 'limit': limits[k]}
         for k in limits}
  for k, v in out.items():
    print(f'check {k} {v["value"]!r} limit {v["limit"]!r}', file=sys.stderr,
          flush=True)
  return out
