"""Preprocessors: scale and resample conditioning features.

Port of F0LoudnessPreprocessor and its helpers from
ddsp_tpu/nn/preprocessing.py.
"""

from __future__ import annotations

import torch

from ddsp_torch.nn.layers import DictModule
from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import spectral
from ddsp_torch.ops.resample import resample

F0_RANGE = spectral.F0_RANGE  # 127.0 MIDI
DB_RANGE = ops_core.DB_RANGE  # 80.0 dB


def at_least_3d(x) -> torch.Tensor:
  """Adds time, batch, then channel dimensions as needed."""
  x = torch.as_tensor(x)
  if x.ndim == 0:
    x = x[None]
  if x.ndim == 1:
    x = x[None, :]
  if x.ndim == 2:
    x = x[:, :, None]
  return x


def scale_db(db: torch.Tensor) -> torch.Tensor:
  """Scales [-DB_RANGE, 0] to [0, 1]."""
  return (db / DB_RANGE) + 1.0


def scale_f0_hz(f0_hz: torch.Tensor) -> torch.Tensor:
  """Scales [0, Nyquist] Hz to [0, 1.0] MIDI-scaled."""
  return ops_core.hz_to_midi(f0_hz) / F0_RANGE


class F0LoudnessPreprocessor(DictModule):
  """Resamples and scales 'f0_hz' and 'loudness_db' to `time_steps` frames.

  Attributes:
    time_steps: Resample features to this many frames.
    frame_rate: Frame rate of the loudness computed from the audio.
    sample_rate: Audio sample rate.
    compute_loudness_fresh: Recompute loudness from 'audio' instead of
      using the dataset's 'loudness_db' (which may then be absent).
  """

  input_keys = ('loudness_db', 'f0_hz', 'audio')
  output_keys = ('f0_hz', 'loudness_db', 'f0_scaled', 'ld_scaled')

  def __init__(self, time_steps: int = 1000, frame_rate: int = 250,
               sample_rate: int = 16000, compute_loudness_fresh: bool = True):
    super().__init__()
    self.time_steps = time_steps
    self.frame_rate = frame_rate
    self.sample_rate = sample_rate
    self.compute_loudness_fresh = compute_loudness_fresh

  def forward(self, *args):
    if len(args) == 1 and isinstance(args[0], dict):
      features = args[0]
      args = (features.get('loudness_db'), features['f0_hz'],
              features.get('audio'))
    return super().forward(*args)

  def compute(self, loudness_db, f0_hz, audio=None):
    if self.compute_loudness_fresh:
      if audio is None:
        raise ValueError(
            'F0LoudnessPreprocessor(compute_loudness_fresh=True) requires '
            "'audio' in the features.")
      loudness_db = spectral.compute_loudness(
          audio, sample_rate=self.sample_rate, frame_rate=self.frame_rate)
    elif loudness_db is None:
      raise ValueError("F0LoudnessPreprocessor requires 'loudness_db' when "
                       'compute_loudness_fresh=False.')
    f0_hz = self.resample(f0_hz)
    loudness_db = self.resample(loudness_db)
    return f0_hz, loudness_db, scale_f0_hz(f0_hz), scale_db(loudness_db)

  def resample(self, x: torch.Tensor) -> torch.Tensor:
    return resample(at_least_3d(x), self.time_steps)
