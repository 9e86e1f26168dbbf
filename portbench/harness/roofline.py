"""Peaks and the least time a piece of work needs on one NVIDIA H100.

The bound functions are a frozen copy of chip_smoke.py's `bound`,
`k1_bound` and `k2_bound`, which count each input byte read once and each
output byte written once against NVIDIA's published peaks (SXM part,
dense, 700 W): the share of a kernel's roofline is that least time over
the device time of the kernels that ran under its op.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}


def bound_s(n_bytes: float, ops: float, dtype: str) -> float:
  """Least seconds for n_bytes moved once and ops at dtype's peak rate."""
  return max(n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype])


def k1_active(f0_hz: np.ndarray, n_samples: int, n_harmonics: int,
              sample_rate: int) -> float:
  """Sample-harmonics below Nyquist of frame-rate f0 [b, f] (linearly
  upsampled to n_samples, as the synthesizer does): K1 stops at a
  sample's first muted harmonic, so this is the work these inputs need."""
  f0 = np.asarray(f0_hz, np.float64).reshape(f0_hz.shape[0], -1)
  n_frames = f0.shape[1]
  src = np.arange(n_samples) * (n_frames / n_samples)
  lo = np.floor(src).astype(np.int64)
  w = src - lo
  hi = np.minimum(lo + 1, n_frames - 1)
  env = f0[:, lo] * (1 - w) + f0[:, hi] * w
  hmax = (sample_rate / 2.0) / np.maximum(env, 1e-20)
  return float(np.clip(np.ceil(hmax) - 1, 0, n_harmonics).sum())


def k1_bound_s(kernel: str, batch: int, n_samples: int, n_frames: int,
               n_harmonics: int, active: float) -> float:
  """Least seconds of a K1 kernel ('fwd', 'bwd_taps', 'bwd_phase'):
  float32 streams [b, n] (fwd: phase, f0 in, audio out; taps: phase, f0,
  g in; phase: phase, f0, g in, dphase out) plus the frame array
  [b, f, H]; 6 operations per audible sample-harmonic (8 for the phase
  kernel)."""
  streams = {'fwd': 3, 'bwd_taps': 3, 'bwd_phase': 4}[kernel]
  n_bytes = 4 * (streams * batch * n_samples + batch * n_frames * n_harmonics)
  ops = (8.0 if kernel == 'bwd_phase' else 6.0) * active
  return bound_s(n_bytes, ops, 'float32')


def k2_bound_s(part: str, seq_len: int, batch: int, hidden: int,
               dtype: str) -> float:
  """Least seconds of a K2 kernel: 'fwd' (xp, wh, bn, h0 in, ys out; one
  recurrent product and ~12 gate operations per unit per step), 'serial'
  (K2b's reverse-time pass: two products and ~30 gate operations per unit
  per step) or 'wgrad' (its weight-gradient pass: h^T dhp over T * B
  rows)."""
  three_h = 3 * hidden
  item = 2 if dtype == 'bfloat16' else 4
  rows = seq_len * batch
  weights = hidden * three_h * item
  small = 4 * (hidden + batch * hidden)
  tiles = 4 * hidden * -(-batch // 16)
  if part == 'serial':
    n_bytes = (rows * (4 * hidden + 2 * three_h * item + 2 * hidden * item) +
               weights + 2 * small + tiles)
    ops = rows * (2 * 2.0 * hidden * three_h + 30.0 * hidden)
  elif part == 'wgrad':
    n_bytes = (rows * item * (hidden + 2 * hidden + hidden) + tiles +
               4 * (hidden * three_h + hidden))
    ops = rows * 2.0 * hidden * three_h
  elif part == 'fwd':
    n_bytes = rows * three_h * item + weights + small + 4 * rows * hidden
    ops = rows * (2.0 * hidden * three_h + 12.0 * hidden)
  else:
    raise ValueError(f'unknown K2 part {part!r}')
  return bound_s(n_bytes, ops, dtype)


def k2_bwd_bound_s(seq_len: int, batch: int, hidden: int, dtype: str):
  """K2b's two passes (bf16 streams: the serial pass and the weight
  gradient)."""
  return (k2_bound_s('serial', seq_len, batch, hidden, dtype) +
          k2_bound_s('wgrad', seq_len, batch, hidden, dtype))


def share_pct(least_s: Sequence[float], device_s: float):
  """100 x the summed least time over the device time; None where the
  device time is missing."""
  if not device_s or device_s <= 0:
    return None
  return 100.0 * float(sum(least_s)) / device_s
