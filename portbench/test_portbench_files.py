"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, driver and per-layer metric is found by name, and the names
and units keep to the benchmark's contract."""

import importlib
import re

import pytest

from portbench.harness import cells, traffic

BENCH = cells.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


@pytest.mark.parametrize('workload', [w['name'] for w in BENCH['workloads']])
def test_cell_found_by_name(workload):
  cell = cells.load(workload)
  assert cell.chips in (1, 4)
  assert hasattr(cells.driver(cell.driver), 'Run')
  assert cell.limits, 'a cell states the limits of its comparison'
  e2e = {m['name'] for m in cell.end_to_end}
  assert 'setup_s' in e2e and len(e2e) >= 2
  assert cell.per_layer


@pytest.mark.parametrize('metric', [m['name'] for m in BENCH['per_layer']])
def test_metric_reader_found_by_name(metric):
  assert callable(cells.metric_reader(metric))


def test_names_and_units():
  names = ([m['name'] for m in METRICS] +
           [w['name'] for w in BENCH['workloads']] +
           [c['name'] for c in BENCH['configs']])
  assert len(names) == len(set(names))
  assert all(NAME.match(n) for n in names)
  assert all(UNIT.match(m['unit']) for m in METRICS)
  assert all(m['better'] in ('lower', 'higher') for m in METRICS)


def test_every_per_layer_metric_moves_what_its_cells_report():
  for m in BENCH['per_layer']:
    moved = next(e for e in BENCH['end_to_end'] if e['name'] == m['moves'])
    for w in m['workloads']:
      assert w in moved.get('workloads', [w])


def test_configs_are_the_files_they_name():
  for c in BENCH['configs']:
    assert c['file'] == f'portbench/configs/{c["name"]}.json'
    assert cells.read_json(cells.ROOT / c['file'])['name'] == c['name']


def test_bounds():
  for m in BENCH['end_to_end']:
    assert 0.01 <= m['bound'] <= 0.25


@pytest.mark.parametrize('config', [c['name'] for c in BENCH['configs']])
def test_reference_module_found_by_config(config):
  """What the harness reads of a configuration lies in the reference
  module that its file names: leaves, layers, the GRU's width and the
  step's operations."""
  spec = cells.read_json(cells.BENCH_DIR / 'configs' / f'{config}.json')
  module = importlib.import_module(f'portbench.reference.{spec["reference"]}')
  cfg = cells.reference_cfg(spec)
  assert module.param_spec(cfg)
  assert set(module.LAYERS) == {'nn', 'proc', 'losses'}
  assert module.rnn_hidden(cfg) > 0
  assert module.step_flops(cfg, 2, 10) == 3 * module.step_flops(
      cfg, 2, 10, passes=1) > 0


def test_traffic_kind_found_by_name():
  for w in BENCH['workloads']:
    kind = cells.load(w['name']).traffic['kind']
    module = importlib.import_module(f'portbench.traffic_kinds.{kind}')
    assert callable(module.make)
  with pytest.raises(ValueError, match='no traffic kind'):
    traffic.make({'kind': 'no_such_kind'}, {}, 0, None)
