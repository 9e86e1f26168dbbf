"""Finds a cell, its configuration, its traffic, its driver and its
per-layer metrics by name, from BENCHMARK.json and the files under
portbench/.

    BENCHMARK.json                  the cells, the metrics and their bounds
    portbench/workloads/<cell>.json the cell: driver, limits of `correct`,
                                    the driver's settings
    portbench/configs/<config>.json the configuration as it is run
    portbench/traffic/<traffic>.json the traffic mix's parameters
    portbench/traffic_kinds/<kind>.py the generator of a traffic kind
    portbench/reference/<reference>.py a configuration's plain reference
    portbench/drivers/<driver>.py   the entry that the window drives
    portbench/metrics/<metric>.py   one reader per per-layer metric
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
  """One entry of BENCHMARK.json's workloads, with its files read."""

  name: str
  chips: int
  config: Dict[str, Any]
  traffic: Dict[str, Any]
  driver: str
  limits: Dict[str, float]
  settings: Dict[str, Any]
  end_to_end: List[Dict[str, Any]]
  per_layer: List[Dict[str, Any]]


def read_json(path: Path) -> Any:
  with open(path) as f:
    return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
  return read_json(root / 'BENCHMARK.json')


def _reports(metric: Dict[str, Any], cell: str) -> bool:
  return cell in metric.get('workloads', [cell])


def load(name: str, root: Path = ROOT) -> Cell:
  """The cell `name`; raises KeyError if BENCHMARK.json has no such cell."""
  bench = benchmark(root)
  entries = {w['name']: w for w in bench['workloads']}
  if name not in entries:
    raise KeyError(f'no workload {name!r} in BENCHMARK.json; it has '
                   f'{sorted(entries)}')
  entry = entries[name]
  cell_file = read_json(BENCH_DIR / 'workloads' / f'{name}.json')
  config = read_json(BENCH_DIR / 'configs' / f'{entry["config"]}.json')
  traffic = read_json(BENCH_DIR / 'traffic' / f'{entry["traffic"]}.json')
  return Cell(
      name=name, chips=int(entry['chips']), config=config, traffic=traffic,
      driver=cell_file['driver'], limits=dict(cell_file['limits']),
      settings={k: v for k, v in cell_file.items()
                if k not in ('driver', 'limits')},
      end_to_end=[m for m in bench['end_to_end'] if _reports(m, name)],
      per_layer=[m for m in bench['per_layer'] if _reports(m, name)])


def reference_cfg(config: Dict[str, Any]) -> Dict[str, Any]:
  """What the drivers, the reference and the traffic read of a
  configuration: the model's sizes (the preset's arguments) and its
  settings (the optimiser, the loss's FFT sizes, sizes the preset fixes),
  in one dict."""
  return dict(config['model'], **config['settings'])


def _module(path: Path, name: str):
  spec = importlib.util.spec_from_file_location(name, path)
  if spec is None or spec.loader is None:
    raise ImportError(f'cannot load {path}')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def driver(name: str):
  """portbench/drivers/<name>.py."""
  return _module(BENCH_DIR / 'drivers' / f'{name}.py',
                 f'portbench.drivers.{name}')


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
  """`read` of portbench/metrics/<name>.py: record -> number or None."""
  module = _module(BENCH_DIR / 'metrics' / f'{name}.py',
                   'portbench.metrics.' + name.replace('.', '_'))
  return module.read
