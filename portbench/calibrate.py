#!/usr/bin/env python3
"""The readings that a cell's limits of `correct` are set from.

    python3 portbench/calibrate.py --workload solo.train \
        --seeds 11 12 13 --control-seeds 11 12 13 --faults half_batch \
        --out build/calibrate.jsonl

For each seed of --seeds, the program's numbers against the reference
(the lower readings); for each of --control-seeds, the control's: the
reference computed in the precision below the configuration's (float8
e4m3 for bfloat16), in the program's place (the upper readings); for each
of --faults, the program with that fault planted (harness/faults.py) on
the control seeds. One JSON line per reading goes to --out and to standard output.
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# pylint: disable=g-import-not-at-top,wrong-import-position
from portbench.harness import cells, runtime
from portbench.harness.faults import FAULTS


def reading(cell, seed, device, kind, seconds):
  run = cells.driver(cell.driver).Run(cell, seed, device)
  run.setup()
  run.window(seconds)
  run.release()
  return run.readings(kind)


def main(argv=None) -> int:
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--workload', required=True)
  parser.add_argument('--seeds', type=int, nargs='*', default=[])
  parser.add_argument('--control-seeds', type=int, nargs='*', default=[])
  parser.add_argument('--faults', nargs='*', default=[],
                      choices=sorted(FAULTS))
  parser.add_argument('--seconds', type=float, default=1.0,
                      help='window of each reading (answers to compare)')
  parser.add_argument('--out', default='build/calibrate.jsonl')
  args = parser.parse_args(argv)
  cell = cells.load(args.workload)
  runtime.fix_cache_dirs(ROOT)
  import torch
  if not torch.cuda.is_available():
    print('calibrate needs a CUDA device.', file=sys.stderr)
    return 2
  device = torch.device('cuda', 0)
  Path(args.out).parent.mkdir(parents=True, exist_ok=True)
  plan = [('program', s) for s in args.seeds]
  plan += [('control', s) for s in args.control_seeds]
  with open(args.out, 'a') as out:
    for kind, seed in plan:
      values = reading(cell, seed, device, kind, args.seconds)
      line = json.dumps({'workload': cell.name, 'kind': kind, 'seed': seed,
                         'values': values, 'device': runtime.device(1, 0)})
      print(line, flush=True)
      out.write(line + '\n')
    for fault in args.faults:
      with FAULTS[fault]():
        for seed in args.control_seeds:
          values = reading(cell, seed, device, 'program', args.seconds)
          line = json.dumps({'workload': cell.name, 'kind': fault,
                             'seed': seed, 'values': values})
          print(line, flush=True)
          out.write(line + '\n')
  return 0


if __name__ == '__main__':
  sys.exit(main())
