"""Native (C) host code, loaded with ctypes: the TFRecord codec.

Port of ddsp_tpu/native/__init__.py with its own copy of
tfrecord_codec.c (CRC32C, record framing and checking), the hot part of
writing and verifying datasets. This is host code, not a device kernel.

The library is built at first use with the system C compiler into
build/ddsp_torch_native/ at the repository root, named by a hash of the
source, the flags and the compiler binary (kernels/_build.py's
hashed_library, as the CUDA kernels are), so a changed source is rebuilt
and a stale library never loads; nothing is written into the package. Every
caller must handle `load_codec()` returning None: the pure-Python CRC of
ddsp_torch/data/tfrecord.py is the fallback. `codec_name()` says which
one runs, and the first load logs it.
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from ddsp_torch.kernels._build import BUILD_ROOT, hashed_library

logger = logging.getLogger('ddsp_torch')

SOURCE = Path(__file__).resolve().parent / 'tfrecord_codec.c'
BUILD_DIR = BUILD_ROOT / 'ddsp_torch_native'
CFLAGS = ('-O3', '-shared', '-fPIC')

_codec = None
_codec_failed = False


def _compiler() -> Optional[str]:
  for cc in ('cc', 'gcc', 'clang'):
    path = shutil.which(cc)
    if path:
      return path
  return None


def library_path(cc: str) -> Path:
  """Where tfrecord_codec.c builds with `cc` and CFLAGS."""
  return hashed_library(SOURCE, cc, CFLAGS, BUILD_DIR, 'tfrecord_codec')


def _build() -> Path:
  cc = _compiler()
  if cc is None:
    raise OSError('no C compiler (cc, gcc or clang) on PATH')
  out = library_path(cc)
  if out.exists():
    return out
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f'.{os.getpid()}.tmp')
  try:
    subprocess.run([cc, *CFLAGS, str(SOURCE), '-o', str(tmp)], check=True,
                   capture_output=True, timeout=120)
  except subprocess.SubprocessError as e:
    raise OSError(f'{cc} failed to build {SOURCE.name}: {e}') from e
  os.replace(tmp, out)
  return out


def load_codec() -> Optional[ctypes.CDLL]:
  """Load (building if needed) the native codec; None if unavailable."""
  global _codec, _codec_failed
  if _codec is not None or _codec_failed:
    return _codec
  try:
    path = _build()
    lib = ctypes.CDLL(str(path))
    lib.ddsp_crc32c.restype = ctypes.c_uint32
    lib.ddsp_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ddsp_masked_crc.restype = ctypes.c_uint32
    lib.ddsp_masked_crc.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ddsp_frame_record.restype = ctypes.c_size_t
    lib.ddsp_frame_record.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      ctypes.c_char_p]
    lib.ddsp_check_record.restype = ctypes.c_longlong
    lib.ddsp_check_record.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    _codec = lib
    logger.info('TFRecord codec: native (%s).', path)
  except OSError as e:
    logger.info('TFRecord codec: pure Python (native codec unavailable: '
                '%s).', e)
    _codec_failed = True
  return _codec


def codec_name() -> str:
  """'native' or 'python': the CRC and framing code that runs."""
  return 'native' if load_codec() is not None else 'python'


def crc32c(data: bytes) -> Optional[int]:
  lib = load_codec()
  if lib is None:
    return None
  return int(lib.ddsp_crc32c(data, len(data)))


def masked_crc(data: bytes) -> Optional[int]:
  lib = load_codec()
  if lib is None:
    return None
  return int(lib.ddsp_masked_crc(data, len(data)))


def frame_record(payload: bytes) -> Optional[bytes]:
  """Frame one TFRecord (length + masked CRCs) natively."""
  lib = load_codec()
  if lib is None:
    return None
  out = ctypes.create_string_buffer(12 + len(payload) + 4)
  n = lib.ddsp_frame_record(payload, len(payload), out)
  return out.raw[:n]


def check_record(framed: bytes) -> Optional[int]:
  """Verify one framed record (both masked CRCs) in a single native call.

  Returns the payload length on success, a negative error code on
  failure (-1 truncated, -2 length-CRC, -3 data-CRC), or None when the
  native codec is unavailable (caller falls back to pure Python).
  """
  lib = load_codec()
  if lib is None:
    return None
  return int(lib.ddsp_check_record(framed, len(framed)))
