"""Audio summaries for evaluation samples.

Port of ddsp_tpu/eval/summaries.py: `write_wav` only, which the export of a
reverb impulse response needs (infer/export.py). The rest of the module
comes with the eval package (ROADMAP.md queue 1 item 5).
"""

from __future__ import annotations

import os
import wave

import numpy as np


def write_wav(path: str, audio: np.ndarray, sample_rate: int = 16000):
  """Write mono float audio in [-1, 1] to a 16-bit wav file."""
  audio = np.asarray(audio).squeeze()
  peak = np.max(np.abs(audio)) or 1.0
  if peak > 1.0:
    audio = audio / peak
  pcm = (np.clip(audio, -1.0, 1.0) * 32767).astype(np.int16)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  with wave.open(path, 'wb') as w:
    w.setnchannels(1)
    w.setsampwidth(2)
    w.setframerate(sample_rate)
    w.writeframes(pcm.tobytes())
