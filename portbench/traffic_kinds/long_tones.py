"""'long_tones': long training batches of a vibrato tone under a loudness
arc (a seeded copy of examples/train_long_audio.py's), made on the
device, and their filtered-noise draws."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.harness import traffic, weights


def make(tr: Dict, cfg: Dict, seed: int, device) -> Dict[str, List]:
  """{'batches': [{'audio' [b, n], 'f0_hz', 'ld_scaled', 'f0_scaled'
  [b, f, 1]}], 'noise': [{'noise' [b, n]}]} float32 on `device`: a seeded
  copy of examples/train_long_audio.py's batch (a vibrato tone under a slow
  loudness arc over a noise floor), tr['pool'] batches of tr['batch'] rows
  of tr['seconds'] s, every row's pitch, vibrato and arc drawn apart."""
  sr = cfg['sample_rate']
  rate = traffic.frames_per_second(cfg)
  seconds = tr['seconds']
  n_frames = int(seconds * rate)
  hop = sr // rate
  n = n_frames * hop
  b = tr['batch']
  g = weights.generator(seed, weights.TRAFFIC_STREAM, device)
  gn = weights.generator(seed, weights.NOISE_STREAM, device)
  t = torch.arange(n, device=device, dtype=torch.float64) / sr
  out = {'batches': [], 'noise': []}
  for _ in range(tr['pool']):
    u = torch.rand((b, 3), generator=g, device=device, dtype=torch.float64)
    f0 = 110.0 * 2.0**(2.0 * u[:, :1]) * (1 + 0.005 * torch.sin(
        2 * np.pi * (4.0 + 2.0 * u[:, 1:2]) * t))
    phase = 2 * np.pi * torch.cumsum(f0, dim=1) / sr
    env = 0.5 + 0.4 * torch.sin(2 * np.pi * (t / seconds + u[:, 2:]))
    audio = 0.4 * env * torch.sin(phase) + tr['noise_level'] * torch.randn(
        (b, n), generator=g, device=device, dtype=torch.float64)
    frames = lambda x: x[:, ::hop, None].float()
    midi = 12.0 * torch.log2(f0[:, ::hop] / 440.0) + 69.0
    out['batches'].append({'audio': audio.float(), 'f0_hz': frames(f0),
                           'ld_scaled': frames(env),
                           'f0_scaled': (midi / 127.0)[..., None].float()})
    out['noise'].append({'noise': torch.rand(
        (b, n), generator=gn, device=device) * 2.0 - 1.0})
  return out
