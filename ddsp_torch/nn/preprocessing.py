"""Preprocessors: scale and resample conditioning features.

Port of F0LoudnessPreprocessor, F0PowerPreprocessor,
OnlineF0PowerPreprocessor (with CREPE's f0, ops/crepe.py) and their helpers
from ddsp_tpu/nn/preprocessing.py.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ddsp_torch.nn.layers import DictModule
from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import spectral
from ddsp_torch.ops.crepe import CREPE_SAMPLE_RATE, PretrainedCrepe
from ddsp_torch.ops.resample import resample

F0_RANGE = spectral.F0_RANGE  # 127.0 MIDI
DB_RANGE = ops_core.DB_RANGE  # 80.0 dB
# Online features are computed at CREPE's rate.
ONLINE_SAMPLE_RATE = CREPE_SAMPLE_RATE


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

  def __init__(self, time_steps: int = 1000, frame_rate: int = 250,
               sample_rate: int = 16000, compute_loudness_fresh: bool = True,
               input_keys: Tuple[str, ...] = ('loudness_db', 'f0_hz',
                                              'audio'),
               output_keys: Tuple[str, ...] = ('f0_hz', 'loudness_db',
                                               'f0_scaled', 'ld_scaled')):
    super().__init__()
    self.time_steps = time_steps
    self.frame_rate = frame_rate
    self.sample_rate = sample_rate
    self.compute_loudness_fresh = compute_loudness_fresh
    self.input_keys = tuple(input_keys)
    self.output_keys = tuple(output_keys)

  def _input_keys(self) -> Sequence[str]:
    if self.compute_loudness_fresh:
      return self.input_keys
    return self.input_keys[:2]

  def _optional_input_keys(self) -> Sequence[str]:
    # A fresh loudness makes the dataset's unnecessary. The JAX module
    # looks 'audio' up strictly; here it is optional so that compute
    # raises the ValueError that names it.
    if self.compute_loudness_fresh:
      return (self.input_keys[0], self.input_keys[2])
    return (self.input_keys[0],)

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

  @staticmethod
  def invert_scaling(f0_scaled: torch.Tensor, ld_scaled: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled f0 and loudness back to Hz and dB."""
    return inv_scale_f0_hz(f0_scaled), inv_scale_db(ld_scaled)

  def resample(self, x: torch.Tensor) -> torch.Tensor:
    return resample(at_least_3d(x), self.time_steps)


class F0PowerPreprocessor(F0LoudnessPreprocessor):
  """Resamples and scales 'f0_hz', and 'power_db' (computed from 'audio'
  when the features do not carry it).

  Attributes (besides F0LoudnessPreprocessor's):
    frame_size: Frame size of the power computed from the audio.
  """

  def __init__(self, time_steps: int = 1000, frame_rate: int = 250,
               sample_rate: int = 16000, frame_size: int = 64,
               compute_loudness_fresh: bool = True,
               input_keys: Tuple[str, ...] = ('f0_hz', 'power_db', 'audio'),
               output_keys: Tuple[str, ...] = ('f0_hz', 'pw_db', 'f0_scaled',
                                               'pw_scaled')):
    super().__init__(time_steps, frame_rate, sample_rate,
                     compute_loudness_fresh, input_keys, output_keys)
    self.frame_size = frame_size

  def _input_keys(self) -> Sequence[str]:
    return self.input_keys

  def _optional_input_keys(self) -> Sequence[str]:
    return self.input_keys[1:]

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

  @staticmethod
  def invert_scaling(f0_scaled: torch.Tensor, pw_scaled: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scaled f0 and power back to Hz and dB."""
    return inv_scale_f0_hz(f0_scaled), inv_scale_db(pw_scaled)


class OnlineF0PowerPreprocessor(DictModule):
  """Computes power_db from the audio and f0 with CREPE, at the frames' own
  rate, without resampling.

  Attributes:
    frame_rate: Output frame rate (Hz) at ONLINE_SAMPLE_RATE.
    frame_size: Analysis frame size (CREPE expects 1024 at 16 kHz).
    padding: 'center', 'same' or 'valid' framing.
    compute_power: Compute power_db from the audio (else the features
      carry 'power_db').
    compute_f0: Run CREPE for f0 and its confidence (else the features
      carry 'f0_hz' and 'f0_confidence').
    crepe_model_capacity: CREPE size.
    crepe_weights_path: Optional .npz or .h5 weights (ops/crepe.py).
    viterbi: Viterbi-decode CREPE's activations.

  CREPE's weights are frozen constants, not parameters of this module: the
  network is held outside the module's state and runs on the audio's
  device (moved there at its first call). f0 carries no gradient. Every
  output must have the frame count of the audio under this framing
  (spectral.get_framed_lengths); a mismatch raises.
  """

  def __init__(self, frame_rate: int = 250, frame_size: int = 1024,
               padding: str = 'center', compute_power: bool = True,
               compute_f0: bool = True, crepe_model_capacity: str = 'tiny',
               crepe_weights_path: Optional[str] = None,
               viterbi: bool = False,
               input_keys: Tuple[str, ...] = ('audio', 'f0_hz',
                                              'f0_confidence', 'audio_16k',
                                              'power_db'),
               output_keys: Tuple[str, ...] = ('f0_hz', 'pw_db', 'f0_scaled',
                                               'pw_scaled', 'f0_confidence')):
    super().__init__()
    self.frame_rate = frame_rate
    self.frame_size = frame_size
    self.padding = padding
    self.compute_power = compute_power
    self.compute_f0 = compute_f0
    self.viterbi = viterbi
    self.input_keys = tuple(input_keys)
    self.output_keys = tuple(output_keys)
    # PretrainedCrepe is not a Module: no parameters, no state_dict keys.
    self.crepe = (PretrainedCrepe(
        model_capacity=crepe_model_capacity, weights_path=crepe_weights_path,
        hop_size=self.hop_size, device='cpu') if compute_f0 else None)

  @property
  def sample_rate(self) -> int:
    """Features are computed at CREPE's rate."""
    return ONLINE_SAMPLE_RATE

  @property
  def hop_size(self) -> int:
    return self.sample_rate // self.frame_rate

  def _optional_input_keys(self) -> Sequence[str]:
    return self.input_keys[1:]

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
    if self.compute_f0:
      if self.crepe.device != audio.device:
        self.crepe.to(audio.device)
      f0_hz, f0_confidence = self.crepe.predict_f0_and_confidence(
          audio, viterbi=self.viterbi, padding=self.padding)
    elif f0_hz is None or f0_confidence is None:
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
