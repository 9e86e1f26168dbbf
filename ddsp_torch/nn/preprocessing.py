"""Preprocessors: scale and resample conditioning features.

Port of F0LoudnessPreprocessor, F0PowerPreprocessor,
OnlineF0PowerPreprocessor and their helpers from
ddsp_tpu/nn/preprocessing.py. On-the-fly f0 (CREPE) is not ported yet:
OnlineF0PowerPreprocessor(compute_f0=True) raises.
"""

from __future__ import annotations

import torch

from ddsp_torch.nn.layers import DictModule
from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import spectral
from ddsp_torch.ops.resample import resample

F0_RANGE = spectral.F0_RANGE  # 127.0 MIDI
DB_RANGE = ops_core.DB_RANGE  # 80.0 dB
# The JAX package preprocesses online features at CREPE's rate
# (ddsp_tpu/ops/crepe.py CREPE_SAMPLE_RATE).
ONLINE_SAMPLE_RATE = 16000


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


def inv_scale_db(db_scaled: torch.Tensor) -> torch.Tensor:
  """Scales [0, 1] to [-DB_RANGE, 0]."""
  return (db_scaled - 1.0) * DB_RANGE


def scale_f0_hz(f0_hz: torch.Tensor) -> torch.Tensor:
  """Scales [0, Nyquist] Hz to [0, 1.0] MIDI-scaled."""
  return ops_core.hz_to_midi(f0_hz) / F0_RANGE


def inv_scale_f0_hz(f0_scaled: torch.Tensor) -> torch.Tensor:
  """Scales [0, 1.0] MIDI-scaled to [0, Nyquist] Hz."""
  return ops_core.midi_to_hz(f0_scaled * F0_RANGE)


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


class F0PowerPreprocessor(F0LoudnessPreprocessor):
  """Resamples and scales 'f0_hz', and 'power_db' (computed from 'audio'
  when the features do not carry it).

  Attributes (besides F0LoudnessPreprocessor's):
    frame_size: Frame size of the power computed from the audio.
  """

  input_keys = ('f0_hz', 'power_db', 'audio')
  output_keys = ('f0_hz', 'pw_db', 'f0_scaled', 'pw_scaled')

  def __init__(self, time_steps: int = 1000, frame_rate: int = 250,
               sample_rate: int = 16000, frame_size: int = 64,
               compute_loudness_fresh: bool = True):
    super().__init__(time_steps, frame_rate, sample_rate,
                     compute_loudness_fresh)
    self.frame_size = frame_size

  def forward(self, *args):
    if len(args) == 1 and isinstance(args[0], dict):
      features = args[0]
      args = (features['f0_hz'], features.get('power_db'),
              features.get('audio'))
    return DictModule.forward(self, *args)

  def compute(self, f0_hz, power_db=None, audio=None):
    f0_hz = self.resample(f0_hz)
    if power_db is not None:
      pw_db = power_db
    elif audio is not None:
      pw_db = spectral.compute_power(audio, sample_rate=self.sample_rate,
                                     frame_rate=self.frame_rate,
                                     frame_size=self.frame_size)
    else:
      raise ValueError('Power preprocessing requires either "power_db" or '
                       '"audio" keys to be provided in the dataset.')
    pw_db = self.resample(pw_db)
    return f0_hz, pw_db, scale_f0_hz(f0_hz), scale_db(pw_db)


class OnlineF0PowerPreprocessor(DictModule):
  """Computes power_db from the audio (and, in the JAX package, f0 with
  CREPE) at the frames' own rate, without resampling.

  Attributes:
    frame_rate: Output frame rate (Hz) at ONLINE_SAMPLE_RATE.
    frame_size: Analysis frame size.
    padding: 'center', 'same' or 'valid' framing.
    compute_power: Compute power_db from the audio (else the features
      carry 'power_db').
    compute_f0: Run CREPE for f0. Not ported: True raises
      NotImplementedError; with False the features carry 'f0_hz' and
      'f0_confidence'.

  Every output must have the frame count of the audio under this framing
  (spectral.get_framed_lengths); a mismatch raises.
  """

  input_keys = ('audio', 'f0_hz', 'f0_confidence', 'audio_16k', 'power_db')
  output_keys = ('f0_hz', 'pw_db', 'f0_scaled', 'pw_scaled', 'f0_confidence')

  def __init__(self, frame_rate: int = 250, frame_size: int = 1024,
               padding: str = 'center', compute_power: bool = True,
               compute_f0: bool = True):
    super().__init__()
    if compute_f0:
      raise NotImplementedError(
          'OnlineF0PowerPreprocessor(compute_f0=True) runs CREPE, which '
          'ddsp_torch has not ported yet (ROADMAP.md, queue 1 item 5: f0 '
          "and eval); pass compute_f0=False with 'f0_hz' and "
          "'f0_confidence' in the features.")
    self.frame_rate = frame_rate
    self.frame_size = frame_size
    self.padding = padding
    self.compute_power = compute_power
    self.sample_rate = ONLINE_SAMPLE_RATE
    self.hop_size = self.sample_rate // frame_rate

  def forward(self, *args):
    if len(args) == 1 and isinstance(args[0], dict):
      args = tuple(args[0].get(k) for k in self.input_keys)
    return super().forward(*args)

  def compute(self, audio, f0_hz=None, f0_confidence=None, audio_16k=None,
              power_db=None):
    if audio_16k is not None:
      audio = audio_16k
    pw_db = power_db
    if not self.compute_power and pw_db is None:
      raise ValueError('OnlineF0PowerPreprocessor needs compute_power=True '
                       "or a 'power_db' feature.")
    if self.compute_power:
      pw_db = spectral.compute_power(audio, sample_rate=self.sample_rate,
                                     frame_rate=self.frame_rate,
                                     frame_size=self.frame_size,
                                     padding=self.padding)
    if f0_hz is None or f0_confidence is None:
      raise ValueError('Preprocessor must either have `compute_f0=True`, or'
                       ' be supplied [audio, f0_hz, f0_confidence].')
    pw_db = at_least_3d(pw_db)
    f0_hz = at_least_3d(f0_hz)
    outputs = {'f0_hz': f0_hz, 'pw_db': pw_db, 'f0_scaled': scale_f0_hz(f0_hz),
               'pw_scaled': scale_db(pw_db)}
    n_t = audio.shape[1]
    time_steps, _ = spectral.get_framed_lengths(
        n_t, self.frame_size, self.hop_size, self.padding)
    for k, output in outputs.items():
      if output.shape[1] != time_steps:
        raise ValueError(
            f'OnlineF0PowerPreprocessor output ({k}) does not have '
            f'{time_steps} timesteps. Output shape: {tuple(output.shape)}. '
            f'Inputs: seconds ({n_t / self.sample_rate}), frame_rate '
            f'({self.frame_rate}), padding ("{self.padding}").')
    return (f0_hz, pw_db, outputs['f0_scaled'], outputs['pw_scaled'],
            f0_confidence)
