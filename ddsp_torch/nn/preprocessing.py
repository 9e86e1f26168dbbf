"""Preprocessors: scale and resample conditioning features.

Port of F0LoudnessPreprocessor and its helpers from
ddsp_tpu/nn/preprocessing.py.
"""

from __future__ import annotations

import torch

from ddsp_torch.nn.layers import DictModule
from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops.resample import resample

F0_RANGE = 127.0  # MIDI
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

  compute_loudness_fresh=True (loudness recomputed from the audio) needs
  ops/spectral.compute_loudness, which belongs to the training slice of the
  port; serving always passes False.
  """

  output_keys = ('f0_hz', 'loudness_db', 'f0_scaled', 'ld_scaled')

  def __init__(self, time_steps: int = 1000, frame_rate: int = 250,
               sample_rate: int = 16000, compute_loudness_fresh: bool = True):
    super().__init__()
    self.time_steps = time_steps
    self.frame_rate = frame_rate
    self.sample_rate = sample_rate
    self.compute_loudness_fresh = compute_loudness_fresh
    self.input_keys = ('f0_hz', 'audio') if compute_loudness_fresh else (
        'loudness_db', 'f0_hz')

  def compute(self, *inputs):
    if self.compute_loudness_fresh:
      raise NotImplementedError(
          'F0LoudnessPreprocessor(compute_loudness_fresh=True) needs '
          'ops/spectral.compute_loudness, which the training slice of '
          'ddsp_torch ports; serving uses compute_loudness_fresh=False.')
    loudness_db, f0_hz = inputs
    f0_hz = self.resample(f0_hz)
    loudness_db = self.resample(loudness_db)
    return f0_hz, loudness_db, scale_f0_hz(f0_hz), scale_db(loudness_db)

  def resample(self, x: torch.Tensor) -> torch.Tensor:
    return resample(at_least_3d(x), self.time_steps)
