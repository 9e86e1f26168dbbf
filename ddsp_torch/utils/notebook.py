"""Notebook audio helpers: play, record, upload and WAV conversion.

Port of ddsp_tpu/utils/notebook.py (numpy and scipy's wavfile). Outside a
notebook they degrade as the JAX ones do: `play` writes a wav file and
prints its path; `record` and `upload` raise, naming the frontend they
need (browser APIs, as the reference's Colab javascript uses).
"""

from __future__ import annotations

import io
import os
import tempfile
from typing import Optional

import numpy as np

from ddsp_torch.utils.audio_io import pcm_to_float_mono

DEFAULT_SAMPLE_RATE = 16000


def normalize_audio(audio: np.ndarray,
                    normalize_db: Optional[float] = 0.1) -> np.ndarray:
  """Peak-normalize audio to `normalize_db` headroom (None = no-op)."""
  audio = np.asarray(audio, np.float32)
  if normalize_db is not None:
    peak = np.max(np.abs(audio)) + 1e-9
    audio = audio / peak * (10 ** (-abs(normalize_db) / 20.0))
  return audio


def audio_to_wav_bytes(audio: np.ndarray,
                       sample_rate: int = DEFAULT_SAMPLE_RATE) -> bytes:
  """float32 [-1, 1] audio -> 16-bit PCM WAV bytes (the first row of a
  batch)."""
  from scipy.io import wavfile  # pylint: disable=g-import-not-at-top
  audio = np.asarray(audio, np.float32)
  if audio.ndim == 2:
    audio = audio[0]
  pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
  buf = io.BytesIO()
  wavfile.write(buf, sample_rate, pcm)
  return buf.getvalue()


def audio_bytes_to_np(wav_data: bytes,
                      sample_rate: int = DEFAULT_SAMPLE_RATE,
                      normalize_db: Optional[float] = None) -> np.ndarray:
  """WAV bytes -> float32 mono audio, linearly resampled to `sample_rate`
  where the file's rate differs."""
  from scipy.io import wavfile  # pylint: disable=g-import-not-at-top
  file_rate, data = wavfile.read(io.BytesIO(wav_data))
  data = pcm_to_float_mono(data)
  if file_rate != sample_rate:
    n_out = int(round(len(data) * sample_rate / file_rate))
    x_old = np.linspace(0.0, 1.0, len(data), endpoint=False)
    x_new = np.linspace(0.0, 1.0, n_out, endpoint=False)
    data = np.interp(x_new, x_old, data).astype(np.float32)
  if normalize_db is not None:
    data = normalize_audio(data, normalize_db)
  return data


def _in_notebook() -> bool:
  try:
    from IPython import get_ipython  # pylint: disable=g-import-not-at-top
  except ImportError:
    return False
  shell = get_ipython()
  return shell is not None and shell.__class__.__name__ != (
      'TerminalInteractiveShell')


def play(audio: np.ndarray,
         sample_rate: int = DEFAULT_SAMPLE_RATE,
         autoplay: bool = False,
         out_path: Optional[str] = None):
  """Play audio in a notebook; elsewhere write a wav and print its path.

  Returns the IPython display handle in a notebook, else the wav path.
  """
  audio = np.asarray(audio, np.float32)
  if audio.ndim == 2:
    audio = audio[0]
  try:
    from IPython import display as ipd  # pylint: disable=g-import-not-at-top
    if ipd.display is not None and _in_notebook():
      return ipd.display(ipd.Audio(data=audio, rate=sample_rate,
                                   autoplay=autoplay))
  except ImportError:
    pass
  if out_path is None:
    fd, out_path = tempfile.mkstemp(suffix='.wav', prefix='ddsp_torch_play_')
    os.close(fd)
  with open(out_path, 'wb') as f:
    f.write(audio_to_wav_bytes(audio, sample_rate))
  print(f'[ddsp_torch] no notebook frontend; audio written to {out_path}')
  return out_path


def record(seconds: float = 3.0,
           sample_rate: int = DEFAULT_SAMPLE_RATE,
           normalize_db: float = 0.1) -> np.ndarray:
  """Record from the browser microphone (notebook frontends only)."""
  del seconds, sample_rate, normalize_db
  raise RuntimeError(
      'record() needs a browser frontend with microphone access (the '
      'reference implements it with Colab javascript). In a headless '
      'environment, load audio from disk instead: '
      "audio_bytes_to_np(open(path, 'rb').read()).")


def upload(sample_rate: int = DEFAULT_SAMPLE_RATE,
           normalize_db: Optional[float] = None) -> np.ndarray:
  """Upload audio through the notebook's file picker (Colab only)."""
  try:
    from google.colab import files  # pylint: disable=g-import-not-at-top
  except ImportError as e:
    raise RuntimeError(
        'upload() needs the Colab frontend; in other environments load '
        "audio from disk: audio_bytes_to_np(open(path, 'rb').read()).") \
        from e
  uploaded = files.upload()
  return audio_bytes_to_np(next(iter(uploaded.values())),
                           sample_rate=sample_rate,
                           normalize_db=normalize_db)
