"""Time-varying FFT convolution and FIR filter design, on torch.fft.

Port of the parts of ddsp_tpu/ops/fftconv.py the serving path uses. The
parity target is the JAX package's jnp.fft branch (its off-TPU route); the
DFT-as-GEMM routes of ddsp_tpu/ops/fft_matmul.py are XLA routing for the
TPU and have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ddsp_torch.ops.core import torch_float32


def hann_window(window_size: int, device=None) -> torch.Tensor:
  """Periodic hann window (tf.signal.hann_window(periodic=True))."""
  denom = window_size if window_size % 2 == 0 else window_size - 1
  t = torch.arange(window_size, dtype=torch.float32, device=device)
  return 0.5 - 0.5 * torch.cos(2.0 * np.pi * t / max(denom, 1))


def get_fft_size(frame_size: int, ir_size: int) -> int:
  """Next power of 2 that holds a frame convolved with an IR."""
  return int(2**np.ceil(np.log2(ir_size + frame_size - 1)))


def frame(signal: torch.Tensor, frame_length: int,
          frame_step: int) -> torch.Tensor:
  """Overlapping frames of the last axis, [..., n_frames, frame_length].

  tf.signal.frame with pad_end=True: the end is zero-padded so that
  n_frames = ceil(T / frame_step).
  """
  n = signal.shape[-1]
  n_frames = -(-n // frame_step)
  pad_len = max(0, (n_frames - 1) * frame_step + frame_length - n)
  if pad_len:
    signal = torch.nn.functional.pad(signal, (0, pad_len))
  return signal.unfold(-1, frame_length, frame_step)


def overlap_and_add(frames: torch.Tensor, frame_step: int) -> torch.Tensor:
  """Signal from overlapping frames [..., n_frames, frame_length].

  Pad-and-fold: frames become k hop-sized chunks and the k shifted
  diagonals are summed.
  """
  *batch_shape, n_frames, frame_length = frames.shape
  out_length = (n_frames - 1) * frame_step + frame_length
  k = -(-frame_length // frame_step)
  if k * frame_step != frame_length:
    frames = torch.nn.functional.pad(frames,
                                     (0, k * frame_step - frame_length))
  chunks = frames.reshape(tuple(batch_shape) + (n_frames, k, frame_step))
  out = frames.new_zeros(tuple(batch_shape) + (n_frames + k - 1, frame_step))
  for j in range(k):
    out[..., j:j + n_frames, :] += chunks[..., :, j, :]
  out = out.reshape(tuple(batch_shape) + ((n_frames + k - 1) * frame_step,))
  return out[..., :out_length]


def crop_and_compensate_delay(audio: torch.Tensor, audio_size: int,
                              ir_size: int, padding: str,
                              delay_compensation: int) -> torch.Tensor:
  """Crop convolution output to 'same' or 'valid' size, removing delay.

  delay_compensation < 0 takes the group delay of a windowed linear-phase
  filter from frequency_impulse_response, (ir_size - 1) // 2 - 1.
  """
  if padding == 'valid':
    crop_size = ir_size + audio_size - 1
  elif padding == 'same':
    crop_size = audio_size
  else:
    raise ValueError(f"Padding must be 'valid' or 'same', instead of "
                     f'{padding}.')
  total_size = int(audio.shape[-1])
  crop = total_size - crop_size
  start = ((ir_size - 1) // 2 - 1 if delay_compensation < 0
           else delay_compensation)
  end = crop - start
  if end <= 0:
    # The window runs past the computed convolution, whose remaining
    # samples are zero.
    return torch.nn.functional.pad(audio[:, start:total_size], (0, -end))
  return audio[:, start:-end]


def fft_convolve(audio: torch.Tensor, impulse_response: torch.Tensor,
                 padding: str = 'same',
                 delay_compensation: int = -1) -> torch.Tensor:
  """Filter audio [batch, n] with IRs [batch, ir] (LTI) or
  [batch, n_frames, ir] (LTV, one IR per non-overlapping audio frame).

  A batch-1 IR is shared by every audio row (broadcast in the frequency
  domain).
  """
  audio = torch_float32(audio)
  impulse_response = torch_float32(impulse_response)
  batch_size, audio_size = audio.shape
  if impulse_response.ndim == 2:
    impulse_response = impulse_response[:, None, :]
  batch_size_ir, n_ir_frames, ir_size = impulse_response.shape
  if batch_size_ir not in (1, batch_size):
    raise ValueError(f'Batch size of audio ({batch_size}) and impulse '
                     f'response ({batch_size_ir}) must be the same.')
  if padding not in ('valid', 'same'):
    raise ValueError(f"Padding must be 'valid' or 'same', instead of "
                     f'{padding}.')

  frame_size = int(np.ceil(audio_size / n_ir_frames))
  audio_frames = frame(audio, frame_size, frame_size)
  n_audio_frames = int(audio_frames.shape[1])
  if n_audio_frames != n_ir_frames:
    raise ValueError(
        f'Number of Audio frames ({n_audio_frames}) and impulse response '
        f'frames ({n_ir_frames}) do not match. For small hop size = '
        'ceil(audio_size / n_ir_frames), number of impulse response frames '
        'must be a multiple of the audio size.')

  fft_size = get_fft_size(frame_size, ir_size)
  audio_fft = torch.fft.rfft(audio_frames, fft_size)
  ir_fft = torch.fft.rfft(impulse_response, fft_size)
  audio_frames_out = torch.fft.irfft(audio_fft * ir_fft, fft_size)
  audio_out = overlap_and_add(audio_frames_out, frame_size)
  return crop_and_compensate_delay(audio_out, audio_size, ir_size, padding,
                                   delay_compensation)


def apply_window_to_impulse_response(impulse_response: torch.Tensor,
                                     window_size: int = 0) -> torch.Tensor:
  """Hann-window zero-phase IRs [batch, n_frames, ir] and make them causal.

  window_size < 1 means the IR size; a smaller window crops the IR.
  """
  impulse_response = torch_float32(impulse_response)
  ir_size = int(impulse_response.shape[-1])
  if window_size <= 0 or window_size > ir_size:
    window_size = ir_size
  window = hann_window(window_size, device=impulse_response.device)

  padding = ir_size - window_size
  if padding > 0:
    half_idx = (window_size + 1) // 2
    window = torch.cat([window[half_idx:], window.new_zeros(padding),
                        window[:half_idx]])
  else:
    window = torch.fft.fftshift(window, dim=-1)

  impulse_response = window * impulse_response
  if padding > 0:
    first_half_start = (ir_size - (half_idx - 1)) + 1
    second_half_end = half_idx + 1
    return torch.cat([impulse_response[..., first_half_start:],
                      impulse_response[..., :second_half_end]], dim=-1)
  return torch.fft.fftshift(impulse_response, dim=-1)


def frequency_impulse_response(magnitudes: torch.Tensor,
                               window_size: int = 0) -> torch.Tensor:
  """Windowed causal FIRs from frequency magnitudes [..., n_freqs].

  Frequency sampling: the zero-phase IR is the inverse real FFT of the
  magnitudes (bins 0 .. Nyquist), then windowed.
  """
  magnitudes = torch_float32(magnitudes)
  impulse_response = torch.fft.irfft(magnitudes.to(torch.complex64))
  return apply_window_to_impulse_response(impulse_response, window_size)


def frequency_filter(audio: torch.Tensor, magnitudes: torch.Tensor,
                     window_size: int = 0,
                     padding: str = 'same') -> torch.Tensor:
  """Filter audio with a (time-varying) FIR designed by frequency sampling.

  magnitudes: [batch, n_frames, n_freqs] or [batch, n_freqs].
  """
  impulse_response = frequency_impulse_response(magnitudes,
                                                 window_size=window_size)
  return fft_convolve(audio, impulse_response, padding=padding)
