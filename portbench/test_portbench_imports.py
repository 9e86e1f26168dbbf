"""Nothing that the benchmark runs loads JAX, jaxlib, flax or the JAX
package, and the reference imports nothing of the program; top-level
module names are compared whole ('ddsp_torch' is not 'ddsp_tpu')."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench.harness import cells

BENCH = cells.BENCH_DIR


def test_a_run_loads_no_jax_module():
  """Imports every module a run imports, in a fresh interpreter."""
  code = '\n'.join([
      'import sys',
      f'sys.path.insert(0, {str(cells.ROOT)!r})',
      'import portbench.run, portbench.calibrate',
      'from portbench.harness import cells, runtime, faults, stats',
      'import portbench.reference.plain, portbench.reference.solo_instrument',
      'import portbench.reference.inverse_synthesis',
      'for w in cells.benchmark()["workloads"]:',
      '  cells.driver(cells.load(w["name"]).driver)',
      'for m in cells.benchmark()["per_layer"]:',
      '  cells.metric_reader(m["name"])',
      'import ddsp_torch.train, ddsp_torch.utils, ddsp_torch.infer',
      'import ddsp_torch.parallel',
      'print(runtime.forbidden_modules())',
  ])
  out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, check=True, timeout=300).stdout
  assert out.strip().splitlines()[-1] == '[]'


def _imported(path: Path):
  tree = ast.parse(path.read_text())
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      yield from (a.name for a in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      yield node.module


def test_reference_imports_nothing_of_the_program():
  for path in sorted((BENCH / 'reference').glob('*.py')):
    tops = {name.split('.')[0] for name in _imported(path)}
    assert not tops & {'ddsp_torch', 'ddsp_tpu', 'jax', 'jaxlib', 'flax'}, (
        path, tops)


def test_no_benchmark_file_imports_jax():
  for path in sorted(BENCH.rglob('*.py')):
    tops = {name.split('.')[0] for name in _imported(path)}
    assert not tops & {'ddsp_tpu', 'jax', 'jaxlib', 'flax'}, (path, tops)
