"""The one entry of the benchmark's traffic: a traffic file's 'kind'
names its generator, portbench/traffic_kinds/<kind>.py, its other keys
the parameters, the run's seed the draws. Every seed gives the same sizes;
only the contents and the order differ.
"""

from __future__ import annotations

import importlib
from typing import Dict

from portbench.harness import cells


def frames_per_second(cfg) -> int:
  return cfg['time_steps'] * cfg['sample_rate'] // cfg['n_samples']


def make(tr: Dict, cfg: Dict, seed: int, device):
  """What portbench/traffic_kinds/<tr['kind']>.py makes of this traffic."""
  kind = tr['kind']
  if not (cells.BENCH_DIR / 'traffic_kinds' / f'{kind}.py').is_file():
    raise ValueError(f'no traffic kind {kind!r}: portbench/traffic_kinds/'
                     f'{kind}.py is missing')
  module = importlib.import_module(f'portbench.traffic_kinds.{kind}')
  return module.make(tr, cfg, seed, device)
