"""Build the CUDA sources in csrc/ with nvcc and load them with ctypes.

Each source has a plain C interface (pointers and the stream as void*), so
it compiles with nvcc alone in seconds, without PyTorch's headers. Libraries
are built at first use into build/ddsp_torch_kernels/ at the repository
root, named by a hash of their source, the nvcc flags and the nvcc binary,
so a change to any of them rebuilds and a stale library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parents[1] / 'csrc'
# build/ at the repository root, beside the package, never inside it.
BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build'
BUILD_DIR = BUILD_ROOT / 'ddsp_torch_kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
  for cand in (os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                            'bin', 'nvcc'), shutil.which('nvcc')):
    if cand and os.path.exists(cand):
      return cand
  raise RuntimeError('nvcc not found: the CUDA kernels of ddsp_torch are '
                     'built from csrc/ on a machine with the CUDA toolkit.')


def hashed_library(source: Path, compiler: str, flags: Sequence[str],
                   build_dir: Path, stem: str) -> Path:
  """build_dir/lib<stem>_<hash>.so: where `source` builds with `compiler`
  and `flags`, named by a hash of the source, the flags and the compiler
  binary (its real path, size and mtime)."""
  sha = hashlib.sha1(Path(source).read_bytes())
  stat = os.stat(compiler)
  sha.update(f'{" ".join(flags)}|{os.path.realpath(compiler)}|'
             f'{stat.st_size}|{stat.st_mtime_ns}'.encode())
  return build_dir / f'lib{stem}_{sha.hexdigest()[:12]}.so'


def library_path(name: str, nvcc: str) -> Path:
  """Where csrc/<name>.cu builds with `nvcc` and NVCC_FLAGS."""
  return hashed_library(CSRC_DIR / f'{name}.cu', nvcc, NVCC_FLAGS, BUILD_DIR,
                        name)


def build(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
  """Compile the named sources, all nvcc processes at once.

  Returns {name: (library path, compiler output)}; the output holds
  ptxas's register and shared-memory report. Raises if any build fails.
  """
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = _nvcc()
  procs = {}
  done = {}
  for name in names:
    out = library_path(name, nvcc)
    if out.exists():
      done[name] = (out, '')
      continue
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
    procs[name] = (out, tmp, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  failed = []
  for name, (out, tmp, proc) in procs.items():
    log, _ = proc.communicate()
    if proc.returncode != 0:
      failed.append(f'{name}.cu (exit {proc.returncode}):\n{log}')
      continue
    os.replace(tmp, out)
    done[name] = (out, log)
  if failed:
    raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
  return done


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
  """The loaded library for csrc/<name>.cu, built first if needed.

  `signatures` maps each C entry point to its argtypes; every entry returns
  a cudaError_t as int. They are set once, when the library is loaded.
  """
  if name not in _LIBS:
    path, _ = build([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in signatures.items():
      fn = getattr(lib, fn_name)
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
    _LIBS[name] = lib
  return _LIBS[name]


def check(status: int, what: str) -> None:
  """Raise on a nonzero cudaError_t returned by a C entry point."""
  if status != 0:
    raise RuntimeError(f'{what} failed with cudaError_t {status}')
