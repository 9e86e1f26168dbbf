"""Time-varying FFT convolution and FIR filter design, on torch.fft.

Port of ddsp_tpu/ops/fftconv.py. The parity target is the JAX package's jnp.fft branch (its off-TPU route); the
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


def get_fft_size(frame_size: int, ir_size: int,
                 power_of_2: bool = True) -> int:
  """Size of an efficient FFT that holds a frame convolved with an IR: the
  next power of 2, or with power_of_2=False the next 5-smooth size
  (scipy's next_fast_len for a real transform, as the JAX package's
  scipy.fftpack next_fast_len)."""
  convolved_frame_size = ir_size + frame_size - 1
  if power_of_2:
    return int(2**np.ceil(np.log2(convolved_frame_size)))
  import scipy.fft  # pylint: disable=g-import-not-at-top
  return int(scipy.fft.next_fast_len(convolved_frame_size, real=True))


def frame(signal: torch.Tensor, frame_length: int, frame_step: int,
          pad_end: bool = False, pad_value: float = 0.0,
          axis: int = -1) -> torch.Tensor:
  """Overlapping frames along `axis`: that axis becomes (n_frames,
  frame_length), [..., n_frames, frame_length, ...].

  tf.signal.frame: with pad_end=True the end is padded with pad_value so
  that n_frames = ceil(T / frame_step); with pad_end=False
  n_frames = 1 + (T - frame_length) // frame_step (0 when T is shorter
  than a frame).
  """
  axis = axis % signal.ndim
  n = signal.shape[axis]
  if pad_end:
    n_frames = -(-n // frame_step)
    pad_len = max(0, (n_frames - 1) * frame_step + frame_length - n)
    if pad_len:
      pads = (0, 0) * (signal.ndim - 1 - axis) + (0, pad_len)
      signal = torch.nn.functional.pad(signal, pads, value=pad_value)
  elif n < frame_length:
    shape = list(signal.shape)
    shape[axis:axis + 1] = [0, frame_length]
    return signal.new_zeros(shape)
  return signal.unfold(axis, frame_length, frame_step).movedim(-1, axis + 1)


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
  audio_frames = frame(audio, frame_size, frame_size, pad_end=True)
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


def _window_size(ir_size: int, window_size: int) -> int:
  """The window of an IR of ir_size samples: window_size < 1, or past the
  IR, means the IR's size."""
  return ir_size if window_size <= 0 or window_size > ir_size else window_size


def designed_ir_size(n_freqs: int, window_size: int) -> int:
  """Length of the IR that frequency_impulse_response makes of n_freqs
  magnitudes: the inverse real FFT's 2 * (n_freqs - 1) samples, cropped to
  2 * ((window + 1) // 2) - 1 by a smaller window
  (apply_window_to_impulse_response's crop)."""
  ir_size = 2 * (n_freqs - 1)
  window_size = _window_size(ir_size, window_size)
  if ir_size - window_size > 0:
    return 2 * ((window_size + 1) // 2) - 1
  return ir_size


def apply_window_to_impulse_response(impulse_response: torch.Tensor,
                                     window_size: int = 0,
                                     causal: bool = False) -> torch.Tensor:
  """Hann-window zero-phase IRs [batch, n_frames, ir] and make them causal.

  window_size < 1 means the IR size; a smaller window crops the IR
  (`designed_ir_size`). causal=True takes IRs already in causal form (the
  peak in the middle) and shifts them to zero phase first.
  """
  impulse_response = torch_float32(impulse_response)
  if causal:
    impulse_response = torch.fft.fftshift(impulse_response, dim=-1)
  ir_size = int(impulse_response.shape[-1])
  window_size = _window_size(ir_size, window_size)
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


def sinc(x, threshold: float = 1e-20) -> torch.Tensor:
  """Normalized zero-phase sinc, sin(pi x) / (pi x), 1 at zero."""
  x = torch_float32(x)
  x = torch.where(torch.abs(x) < threshold, torch.full_like(x, threshold), x)
  x = np.pi * x
  return torch.sin(x) / x


def sinc_impulse_response(cutoff_frequency, window_size: int = 512,
                          sample_rate=None,
                          high_pass: bool = False) -> torch.Tensor:
  """Hamming-windowed sinc low-pass IRs of unity gain, [batch, n_time,
  (window_size // 2) * 2 + 1], for cutoffs [batch, n_time, 1] in Hz (with
  a sample_rate) or as a ratio of Nyquist; high_pass inverts them."""
  cutoff_frequency = torch_float32(cutoff_frequency)
  if sample_rate is not None:
    cutoff_frequency = cutoff_frequency * 2.0 / float(sample_rate)
  half_size = window_size // 2
  full_size = half_size * 2 + 1
  dev = cutoff_frequency.device
  idx = torch.arange(-half_size, half_size + 1, dtype=torch.float32,
                     device=dev)
  impulse_response = sinc(cutoff_frequency * idx)
  # Periodic Hamming window; an odd size takes the denominator N - 1, as
  # hann_window does.
  denom = full_size if full_size % 2 == 0 else full_size - 1
  n = torch.arange(full_size, dtype=torch.float32, device=dev)
  window = 0.54 - 0.46 * torch.cos(2.0 * np.pi * n / denom)
  impulse_response = window * impulse_response
  impulse_response = impulse_response / torch.abs(
      torch.sum(impulse_response, dim=-1, keepdim=True))
  if high_pass:
    pass_through = torch.zeros_like(impulse_response)
    pass_through[..., half_size] = 1.0
    impulse_response = pass_through - impulse_response
  return impulse_response


def sinc_filter(audio: torch.Tensor, cutoff_frequency,
                window_size: int = 512, sample_rate=None,
                padding: str = 'same',
                high_pass: bool = False) -> torch.Tensor:
  """Filter audio with a (time-varying) sinc low-pass or high-pass."""
  impulse_response = sinc_impulse_response(cutoff_frequency,
                                           window_size=window_size,
                                           sample_rate=sample_rate,
                                           high_pass=high_pass)
  return fft_convolve(audio, impulse_response, padding=padding)
