#!/usr/bin/env python3
"""The benchmark of ddsp_torch: one run of one cell.

    python3 portbench/run.py --workload solo.train --seed 7 --seconds 10 \
        --trace 0

From the root of a checkout, on a machine with an NVIDIA GPU. The run
builds the cell from its files, makes the weights and the inputs from the
seed on the card, warms up the cell's shapes (set-up), drives the cell's
entry for --seconds (the window), then checks what the timed path produced
against the plain reference and prints one JSON line: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics from a
short traced window after the timed one. It exits non-zero, printing no
result, without a card, or if a JAX module was loaded.
"""

import time

T_START = time.time()

# pylint: disable=g-import-not-at-top,wrong-import-position
import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from portbench.harness import cells, check, runtime, trace


def execute(cell: cells.Cell, seed: int, seconds: float, traced: bool,
            device, t_start: float = T_START):
  """Set-up, window, optional traced window, check: the result dict."""
  run = cells.driver(cell.driver).Run(cell, seed, device)
  run.setup()
  window = run.window(seconds)
  metrics, device_extra, breakdown = {}, {}, None
  if traced:
    path = trace.trace_path(cell.name)
    try:
      record = run.traced(path)
    finally:
      trace.maybe_remove(path)
    tr = record.get('trace')
    for m in cell.per_layer:
      value = cells.metric_reader(m['name'])(record)
      if value is not None:
        metrics[m['name']] = {'value': value, 'unit': m['unit']}
    if tr is not None:
      device_extra = {'busy_s': tr.busy_s(), 'window_s': tr.window_s}
      breakdown = {'device_ops': tr.device_ops(), 'idle_gaps': tr.idle_gaps()}
  else:
    values = dict(window['metrics'], setup_s=window['start'] - t_start)
    for m in cell.end_to_end:
      metrics[m['name']] = {'value': values[m['name']], 'unit': m['unit']}
  peak = run.memory_peak_bytes()
  run.release()
  gc.collect()
  values = run.check()
  result = {'correct': check.verdict(values, cell.limits),
            'attempted': window['attempted'], 'failed': window['failed'],
            'metrics': metrics, 'device': dict(
                runtime.device(cell.chips, peak) if device.type == 'cuda'
                else {'platform': 'cpu', 'count': 0,
                      'memory_peak_bytes': peak}, **device_extra)}
  if breakdown is not None:
    result['breakdown'] = breakdown
  result['checks'] = check.report(values, cell.limits)
  return result


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--seconds', type=float, required=True)
  parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
  args = parser.parse_args(argv)
  cell = cells.load(args.workload)
  runtime.fix_cache_dirs(ROOT)
  import torch
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f'{cell.name} needs {cell.chips} CUDA device(s); this machine has '
          f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}.'
          ' No result.', file=sys.stderr)
    return 2
  result = execute(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device('cuda', 0))
  loaded = runtime.forbidden_modules()
  if loaded:
    print(f'JAX modules were loaded: {loaded}. No result.', file=sys.stderr)
    return 3
  runtime.print_result(result)
  return 0


if __name__ == '__main__':
  sys.exit(main())
