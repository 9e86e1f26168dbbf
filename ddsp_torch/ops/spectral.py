"""Spectral ops: STFT, magnitudes, loudness, power, framing math.

Port of the parts of ddsp_tpu/ops/spectral.py that the training path uses:
get_framed_lengths, pad, stft, compute_mag, compute_logmag,
compute_rms_energy, compute_power, a_weighting_np, fft_frequencies and
compute_loudness. The parity target is the JAX package's jnp.fft branch;
its DFT-as-GEMM branches route around the TPU's FFT and have no counterpart
here. compute_mel, compute_mfcc and compute_f0 belong to the encoder and
eval slices.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ddsp_torch.ops import fftconv
from ddsp_torch.ops.core import (DB_RANGE, amplitude_to_db, power_to_db,
                                 safe_log, torch_float32)

F0_RANGE = 127.0  # MIDI


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
