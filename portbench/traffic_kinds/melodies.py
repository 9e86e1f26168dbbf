"""'melodies': single rendering requests of vibrato melodies (a seeded
and longer copy of chip_smoke.py's `requests`), with clip lengths drawn
in fixed blocks: each block holds every length its stated number of
times, in an order drawn from the seed; and one noise draw per request of
the pool, made on the device."""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch

from portbench.harness import traffic, weights

SCHEDULE_STREAM = 5


class Melodies:
  """The requests of a 'melodies' mix: `pool[length]` holds
  tr['pool_per_length'] requests of each length, `noise[length]` their
  noise draws, and `schedule()` the (length, index) of each request in
  turn."""

  def __init__(self, tr: Dict, cfg: Dict, seed: int, device):
    self.lengths = [int(x) for x in tr['lengths_s']]
    self.block = [int(x) for x in tr['block']]
    rate = traffic.frames_per_second(cfg)
    sr = cfg['sample_rate']
    rng = np.random.default_rng(weights.stream_seed(
        seed, weights.TRAFFIC_STREAM))
    gn = weights.generator(seed, weights.NOISE_STREAM, device)
    self.pool: Dict[int, List[Dict[str, np.ndarray]]] = {}
    self.noise: Dict[int, List[torch.Tensor]] = {}
    for length in self.lengths:
      t = np.arange(length * rate) / rate
      self.pool[length], self.noise[length] = [], []
      for _ in range(tr['pool_per_length']):
        base, vib, ph = rng.random(3)
        f0 = 110.0 * 2.0**(2.0 * base + tr['vibrato_octaves'] * np.sin(
            2 * np.pi * (3.0 + 3.0 * vib) * t))
        ld = (-30.0 + 10.0 * np.sin(2 * np.pi * (0.5 * t + ph)) -
              5.0 * rng.random(t.shape[0]))
        self.pool[length].append({'f0_hz': f0.astype(np.float32),
                                  'loudness_db': ld.astype(np.float32)})
        self.noise[length].append(
            torch.rand((1, length * sr), generator=gn, device=device) * 2.0 -
            1.0)
    self._seed = weights.stream_seed(seed, SCHEDULE_STREAM)

  def schedule(self) -> Iterator:
    """(length, pool index) of every request, endlessly."""
    rng = np.random.default_rng(self._seed)
    used = {length: 0 for length in self.lengths}
    block = np.repeat(self.lengths, self.block)
    while True:
      for length in rng.permutation(block):
        length = int(length)
        yield length, used[length] % len(self.pool[length])
        used[length] += 1


make = Melodies
