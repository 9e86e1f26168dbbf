"""'tones': training batches of gliding harmonic tones plus noise (a
seeded copy of chip_smoke.py's `training_batch`), made on the device, and
the filtered-noise draws that the steps take, one per batch."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.harness import traffic, weights


def make(tr: Dict, cfg: Dict, seed: int, device) -> Dict[str, List]:
  """{'batches': [{'audio' [b, n], 'f0_hz' [b, f, 1]}], 'noise': [{'noise'
  [b, n]}]} float32 on `device`: tr['pool'] batches of tr['batch'] rows of
  tr['seconds'] s, every row's pitch, vibrato and level (log-uniform over
  tr['gain_range'], as recordings differ in loudness) drawn apart."""
  sr = cfg['sample_rate']
  rate = traffic.frames_per_second(cfg)
  n = int(tr['seconds'] * sr)
  n_frames = int(tr['seconds'] * rate)
  hop = n // n_frames
  b = tr['batch']
  g = weights.generator(seed, weights.TRAFFIC_STREAM, device)
  gn = weights.generator(seed, weights.NOISE_STREAM, device)
  t = torch.arange(n_frames, device=device, dtype=torch.float64) / rate
  samples = torch.arange(n, device=device, dtype=torch.float64) / sr
  envelope = 0.5 + 0.4 * torch.sin(2 * np.pi * 0.7 * samples)
  out = {'batches': [], 'noise': []}
  lo, hi = (float(np.log(x)) for x in tr['gain_range'])
  for _ in range(tr['pool']):
    u = torch.rand((b, 3), generator=g, device=device, dtype=torch.float64)
    f0 = 110.0 * 2.0**(2.0 * u[:, :1] + 0.15 * torch.sin(
        2 * np.pi * (0.5 + u[:, 1:2]) * t))
    gain = torch.exp(lo + (hi - lo) * u[:, 2:])
    phase = 2 * np.pi * torch.cumsum(f0.repeat_interleave(hop, dim=1),
                                     dim=1) / sr
    audio = sum(0.25 / h * torch.sin(h * phase)
                for h in range(1, tr['harmonics'] + 1))
    audio = gain * (envelope * audio + tr['noise_level'] * torch.randn(
        (b, n), generator=g, device=device, dtype=torch.float64))
    out['batches'].append({'audio': audio.float(),
                           'f0_hz': f0.float()[..., None]})
    out['noise'].append({'noise': torch.rand(
        (b, n), generator=gn, device=device) * 2.0 - 1.0})
  return out
