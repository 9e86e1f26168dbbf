"""PCM-to-float audio conversion (port of ddsp_tpu/utils/audio_io.py).

One definition of the WAV dtype normalization and stereo downmix, used by
the dataset preparation's loader (data/prepare.py).
"""

from __future__ import annotations

import numpy as np


def pcm_to_float_mono(data: np.ndarray) -> np.ndarray:
  """int/uint/float PCM array -> float32 in [-1, 1], stereo averaged."""
  data = np.asarray(data)
  if data.dtype.kind == 'i':
    data = data.astype(np.float32) / np.iinfo(data.dtype).max
  elif data.dtype.kind == 'u':
    info = np.iinfo(data.dtype)
    data = (data.astype(np.float32) - info.max / 2) / (info.max / 2)
  else:
    data = data.astype(np.float32)
  if data.ndim == 2:  # channels -> mono
    data = data.mean(axis=1)
  return data
