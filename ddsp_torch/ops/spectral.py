"""Spectral ops: STFT, magnitudes, loudness, power, framing math.

Port of ddsp_tpu/ops/spectral.py: framing, STFT, magnitudes, mel and MFCC,
loudness, power, pad_or_trim_to_expected_length, the numpy STFT, and
compute_f0 through CREPE (ops/crepe.py). The parity target is the JAX
package's jnp.fft branch; its DFT-as-GEMM branches route around the TPU's
FFT and have no counterpart here.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ddsp_torch.ops import fftconv
from ddsp_torch.ops.core import (DB_RANGE, amplitude_to_db, power_to_db,
                                 safe_log, torch_float32)
from ddsp_torch.utils.device import DeviceLike, resolve_device

F0_RANGE = 127.0  # MIDI
_MEL_BREAK_FREQUENCY_HERTZ = 700.0
_MEL_HIGH_FREQUENCY_Q = 1127.0


def get_framed_lengths(input_length: int, frame_size: int, hop_size: int,
                       padding: str = 'center'):
  """Given strided framing, return (n_frames, padded_length).

  padding: 'valid' (no-op), 'same' (pad the end so n_frames = ceil(n_t /
  hop_size)), or 'center' (pad both ends so each frame timestamp is centered
  and n_frames = n_t / hop_size + 1).
  """

  def get_n_frames(length):
    return int(np.floor((length - frame_size) // hop_size)) + 1

  if padding == 'valid':
    padded_length = input_length
    n_frames = get_n_frames(input_length)
  elif padding == 'center':
    padded_length = input_length + frame_size
    n_frames = get_n_frames(padded_length)
  elif padding == 'same':
    n_frames = int(np.ceil(input_length / hop_size))
    padded_length = (n_frames - 1) * hop_size + frame_size
  else:
    raise ValueError(f'Invalid padding: {padding}')
  return n_frames, padded_length


def pad(x, frame_size: int, hop_size: int, padding: str = 'center',
        axis: int = 1, mode: str = 'constant',
        constant_values: float = 0) -> torch.Tensor:
  """Pad a tensor for strided framing (modes: constant, reflect, edge)."""
  x = torch_float32(x)
  if padding == 'valid':
    return x
  if hop_size > frame_size:
    raise ValueError(f'During padding, frame_size ({frame_size})'
                     f' must be greater than hop_size ({hop_size}).')
  if x.ndim <= 1:
    axis = 0
  axis = axis % x.ndim

  n_t = x.shape[axis]
  _, n_t_padded = get_framed_lengths(n_t, frame_size, hop_size, padding)
  if padding == 'same':
    pads = (0, int(n_t_padded - n_t))
  elif padding == 'center':
    pads = (int(frame_size // 2),) * 2  # Symmetric even padding like librosa.
  else:
    raise ValueError("`padding` must be one of ['center', 'same', 'valid'], "
                     f'received ({padding}).')

  mode = mode.lower()
  torch_mode = {'constant': 'constant', 'reflect': 'reflect',
                'edge': 'replicate'}.get(mode)
  if torch_mode is None:
    raise ValueError(f'Unsupported pad mode: {mode!r}.')
  # torch pads trailing axes of a [batch, channel, time] view.
  moved = x.movedim(axis, -1)
  flat = moved.reshape((1, -1, n_t))
  if torch_mode == 'constant':
    flat = torch.nn.functional.pad(flat, pads, value=float(constant_values))
  else:
    flat = torch.nn.functional.pad(flat, pads, mode=torch_mode)
  return flat.reshape(tuple(moved.shape[:-1]) + (-1,)).movedim(-1, axis)


def stft(audio, frame_size: int = 2048, overlap: float = 0.75,
         pad_end: bool = True) -> torch.Tensor:
  """Differentiable batched STFT with tf.signal.stft semantics.

  Periodic hann window, hop = frame_size * (1 - overlap), fft length = the
  enclosing power of 2 of frame_size, pad_end zero-pads so n_frames =
  ceil(T / hop).

  Args:
    audio: [batch, time] or [time] (or [batch, time, 1]).

  Returns:
    Complex STFT, [batch, n_frames, fft_size // 2 + 1].
  """
  audio = torch_float32(audio)
  if audio.ndim == 3:
    audio = audio.squeeze(-1)
  hop_size = int(frame_size * (1.0 - overlap))
  fft_size = int(2**np.ceil(np.log2(frame_size)))
  frames = fftconv.frame(audio, frame_size, hop_size, pad_end=pad_end)
  frames = frames * fftconv.hann_window(frame_size, device=audio.device)
  return torch.fft.rfft(frames, fft_size)


def compute_mag(audio, size: int = 2048, overlap: float = 0.75,
                pad_end: bool = True) -> torch.Tensor:
  """Magnitude spectrogram |stft|, float32."""
  return torch.abs(stft(audio, frame_size=size, overlap=overlap,
                        pad_end=pad_end)).to(torch.float32)


def compute_logmag(audio, size: int = 2048, overlap: float = 0.75,
                   pad_end: bool = True) -> torch.Tensor:
  """Log magnitude spectrogram."""
  return safe_log(compute_mag(audio, size, overlap, pad_end))


@functools.lru_cache(maxsize=None)
def linear_to_mel_matrix_np(num_mel_bins: int = 64,
                            num_spectrogram_bins: int = 1025,
                            sample_rate: int = 16000,
                            lower_edge_hertz: float = 0.0,
                            upper_edge_hertz: float = 8000.0) -> np.ndarray:
  """Mel filterbank matrix matching tf.signal.linear_to_mel_weight_matrix.

  HTK mel scale, triangular filters in the mel domain, with the DC bin
  dropped from the interpolation (first row is zero).
  """
  def hz_to_mel(f):
    return _MEL_HIGH_FREQUENCY_Q * np.log1p(f / _MEL_BREAK_FREQUENCY_HERTZ)

  nyquist = sample_rate / 2.0
  linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[1:]
  spectrogram_bins_mel = hz_to_mel(linear_freqs)[:, np.newaxis]

  band_edges_mel = np.linspace(
      hz_to_mel(lower_edge_hertz), hz_to_mel(upper_edge_hertz),
      num_mel_bins + 2)
  lower_edge_mel = band_edges_mel[np.newaxis, :-2]
  center_mel = band_edges_mel[np.newaxis, 1:-1]
  upper_edge_mel = band_edges_mel[np.newaxis, 2:]

  lower_slopes = (spectrogram_bins_mel - lower_edge_mel) / (
      center_mel - lower_edge_mel)
  upper_slopes = (upper_edge_mel - spectrogram_bins_mel) / (
      upper_edge_mel - center_mel)
  mel_weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))

  # Re-add the DC bin dropped above.
  return np.pad(mel_weights, [[1, 0], [0, 0]]).astype(np.float32)


def compute_mel(audio, lo_hz: float = 0.0, hi_hz: float = 8000.0,
                bins: int = 64, fft_size: int = 2048, overlap: float = 0.75,
                pad_end: bool = True,
                sample_rate: int = 16000) -> torch.Tensor:
  """Mel spectrogram."""
  mag = compute_mag(audio, fft_size, overlap, pad_end)
  mel_matrix = torch.as_tensor(
      linear_to_mel_matrix_np(bins, int(mag.shape[-1]), sample_rate, lo_hz,
                              hi_hz), device=mag.device)
  return torch.tensordot(mag, mel_matrix, dims=1)


def compute_logmel(audio, lo_hz: float = 80.0, hi_hz: float = 7600.0,
                   bins: int = 64, fft_size: int = 2048,
                   overlap: float = 0.75, pad_end: bool = True,
                   sample_rate: int = 16000) -> torch.Tensor:
  """Log mel spectrogram."""
  return safe_log(compute_mel(audio, lo_hz, hi_hz, bins, fft_size, overlap,
                              pad_end, sample_rate))


@functools.lru_cache(maxsize=None)
def _dct_ii_matrix_np(n: int) -> np.ndarray:
  """DCT-II matrix ([n_mels, n_mels]) applied as x @ M.

  tf.signal.mfccs_from_log_mel_spectrograms scales the unnormalized DCT-II
  by 1/sqrt(2N): like 'ortho' but without the extra 1/sqrt(2) on the DC
  coefficient.
  """
  k = np.arange(n)[np.newaxis, :]
  i = np.arange(n)[:, np.newaxis]
  m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
  return m.astype(np.float32)


def compute_mfcc(audio, lo_hz: float = 20.0, hi_hz: float = 8000.0,
                 fft_size: int = 1024, mel_bins: int = 128,
                 mfcc_bins: int = 13, overlap: float = 0.75,
                 pad_end: bool = True,
                 sample_rate: int = 16000) -> torch.Tensor:
  """Mel-frequency cepstral coefficients: the DCT-II of the log mel
  spectrogram as tf.signal.mfccs_from_log_mel_spectrograms scales it,
  truncated to mfcc_bins."""
  logmel = compute_logmel(audio, lo_hz=lo_hz, hi_hz=hi_hz, bins=mel_bins,
                          fft_size=fft_size, overlap=overlap,
                          pad_end=pad_end, sample_rate=sample_rate)
  dct_m = torch.as_tensor(_dct_ii_matrix_np(mel_bins), device=logmel.device)
  return torch.tensordot(logmel, dct_m, dims=1)[..., :mfcc_bins]


def compute_rms_energy(audio, sample_rate: int = 16000,
                       frame_rate: int = 250, frame_size: int = 512,
                       padding: str = 'center') -> torch.Tensor:
  """Root-mean-squared energy of audio, framed at frame_rate."""
  audio = torch_float32(audio)
  hop_size = sample_rate // frame_rate
  audio = pad(audio, frame_size, hop_size, padding=padding)
  audio_frames = fftconv.frame(audio, frame_size, hop_size, pad_end=False)
  return torch.mean(audio_frames**2.0, dim=-1)**0.5


def compute_power(audio, sample_rate: int = 16000, frame_rate: int = 250,
                  frame_size: int = 512, ref_db: float = 0.0,
                  range_db: float = DB_RANGE,
                  padding: str = 'center') -> torch.Tensor:
  """Power of audio in dB."""
  rms_energy = compute_rms_energy(audio, sample_rate, frame_rate, frame_size,
                                  padding=padding)
  return amplitude_to_db(rms_energy, ref_db=ref_db, range_db=range_db)


@functools.lru_cache(maxsize=None)
def a_weighting_np(frequencies: tuple, min_db: Optional[float] = -80.0):
  """A-weighting curve in dB for the given frequencies (IEC 61672).

  The formula of librosa.A_weighting.
  """
  f_sq = np.asarray(frequencies, dtype=np.float64)**2.0
  const = np.array([12194.217, 20.598997, 107.65265, 737.86223])**2.0
  with np.errstate(divide='ignore'):
    weights = 2.0 + 20.0 * (
        np.log10(const[0])
        + 2 * np.log10(f_sq)
        - np.log10(f_sq + const[0])
        - np.log10(f_sq + const[1])
        - 0.5 * np.log10(f_sq + const[2])
        - 0.5 * np.log10(f_sq + const[3]))
  if min_db is not None:
    weights = np.maximum(min_db, weights)
  return weights.astype(np.float32)


def fft_frequencies(sample_rate: int, n_fft: int) -> np.ndarray:
  """Center frequencies of rfft bins."""
  return np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)


def compute_loudness(audio, sample_rate: int = 16000, frame_rate: int = 250,
                     n_fft: int = 512, range_db: float = DB_RANGE,
                     ref_db: float = 0.0,
                     padding: str = 'center') -> torch.Tensor:
  """Perceptual loudness (A-weighted power) in dB. Differentiable.

  Args:
    audio: [batch_size, audio_length] or [audio_length].
    sample_rate: Audio sample rate in Hz.
    frame_rate: Rate of loudness frames in Hz.
    n_fft: FFT window size.
    range_db: Dynamic range of loudness in decibels.
    ref_db: Reference maximum perceptual loudness.
    padding: 'same', 'valid', or 'center'.

  Returns:
    Loudness in decibels, [batch_size, n_frames] or [n_frames].
  """
  frame_size = n_fft
  hop_size = sample_rate // frame_rate
  audio = pad(audio, frame_size, hop_size, padding=padding)
  is_1d = audio.ndim == 1
  if is_1d:
    audio = audio[None, :]

  # stft transforms on the enclosing power-of-two grid, so the A-weights
  # are taken on those bin centers (a non-power-of-two n_fft just samples
  # the spectrum more densely).
  fft_size = int(2**np.ceil(np.log2(frame_size)))
  frequencies = tuple(fft_frequencies(sample_rate, fft_size).tolist())
  # Weight in linear scale; a_weighting_np gives decibels.
  weighting = torch.as_tensor(10**(a_weighting_np(frequencies) / 10),
                              device=audio.device)

  overlap = 1 - hop_size / frame_size
  s = stft(audio, frame_size=frame_size, overlap=overlap, pad_end=False)
  power = (s.real**2 + s.imag**2) * weighting
  avg_power = torch.mean(power, dim=-1)
  loudness = power_to_db(avg_power, ref_db=ref_db, range_db=range_db)
  return loudness[0] if is_1d else loudness


def pad_or_trim_to_expected_length(vector, expected_len: int,
                                   pad_value: float = 0.0,
                                   len_tolerance: int = 20) -> torch.Tensor:
  """Make vector [(batch,) length] expected_len long: pad the end with
  pad_value or trim it. Raises if the lengths differ by more than
  len_tolerance."""
  vector = torch.as_tensor(vector)
  original_len = vector.shape[-1]
  if abs(original_len - expected_len) > len_tolerance:
    raise ValueError(f'Vector length {original_len} differs from expected '
                     f'length {expected_len} beyond tolerance '
                     f'{len_tolerance}.')
  is_1d = vector.ndim == 1
  if is_1d:
    vector = vector[None, :]
  if original_len < expected_len:
    vector = torch.nn.functional.pad(
        vector, (0, expected_len - original_len), value=pad_value)
  elif original_len > expected_len:
    vector = vector[..., :expected_len]
  return vector[0] if is_1d else vector


# CREPE networks built by compute_f0, by (capacity, device).
_CREPE_CACHE = {}


def reset_crepe():
  """Drop the cached CREPE networks (force a rebuild and a weight reload)."""
  _CREPE_CACHE.clear()


def _get_crepe(model_capacity: str, device: torch.device):
  from ddsp_torch.ops.crepe import PretrainedCrepe  # pylint: disable=g-import-not-at-top
  key = (model_capacity, device)
  if key not in _CREPE_CACHE:
    _CREPE_CACHE[key] = PretrainedCrepe(model_capacity=model_capacity,
                                        device=device)
  return _CREPE_CACHE[key]


def compute_f0(audio, frame_rate: int, viterbi: bool = True,
               padding: str = 'center', model_capacity: str = 'tiny',
               device: DeviceLike = None):
  """Fundamental frequency by CREPE (ops/crepe.py) on `device`.

  Args:
    audio: One example [n_samples] or a batch [batch, n_samples] at 16 kHz
      (numpy or a tensor).
    frame_rate: Rate of f0 frames in Hz.
    viterbi: Viterbi-decode the activations.
    padding: 'same', 'valid', or 'center'.
    model_capacity: CREPE model size.
    device: Where CREPE runs: CUDA unless the caller says otherwise (raises
      without a GPU).

  Returns:
    f0_hz, f0_confidence: numpy float32, [(batch,) n_frames]; NaN
    confidences become 0.
  """
  device = resolve_device(device)
  crepe_model = _get_crepe(model_capacity, device)
  hop_size = crepe_model.sample_rate // frame_rate
  was_1d = np.ndim(audio) == 1
  audio = torch_float32(audio).to(device)
  audio = audio[None] if was_1d else audio
  f0_hz, f0_confidence = crepe_model.predict_f0_and_confidence(
      audio, viterbi=viterbi, padding=padding, hop_size=hop_size)
  f0_hz = f0_hz.cpu().numpy().astype(np.float32)
  f0_confidence = np.nan_to_num(
      f0_confidence.cpu().numpy().astype(np.float32))
  if was_1d:
    f0_hz, f0_confidence = f0_hz[0], f0_confidence[0]
  return f0_hz, f0_confidence


def stft_np(audio, frame_size: int = 2048, overlap: float = 0.75,
            pad_end: bool = True):
  """Non-differentiable numpy STFT with stft()'s frames and window
  (periodic hann, hop = frame_size * (1 - overlap))."""
  audio = np.asarray(audio, np.float32)
  is_1d = audio.ndim == 1
  if is_1d:
    audio = audio[np.newaxis, :]
  hop_size = int(frame_size * (1.0 - overlap))
  if pad_end:
    n_frames = int(np.ceil(audio.shape[1] / hop_size))
    n_pad = max(0, (n_frames - 1) * hop_size + frame_size - audio.shape[1])
    audio = np.pad(audio, ((0, 0), (0, n_pad)))
  n_frames = 1 + (audio.shape[1] - frame_size) // hop_size
  idx = (np.arange(n_frames)[:, None] * hop_size +
         np.arange(frame_size)[None, :])
  frames = audio[:, idx]
  denom = frame_size if frame_size % 2 == 0 else frame_size - 1
  window = 0.5 - 0.5 * np.cos(
      2.0 * np.pi * np.arange(frame_size) / max(denom, 1))
  fft_size = int(2**np.ceil(np.log2(frame_size)))
  s = np.fft.rfft(frames * window, fft_size)
  return s[0] if is_1d else s
