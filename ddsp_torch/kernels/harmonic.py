"""Kernel K1: fused harmonic synthesis from the fundamental phase (forward).

Wraps csrc/harmonic.cu, which replaces
ddsp_tpu/ops/pallas_kernels/harmonic.py:_fwd_kernel. Beside it,
`harmonic_synthesis_plain` is the plain PyTorch version of the same function
(the jnp formula of ddsp_tpu/ops/oscillator.py:336-344): the CPU tests hold it
against the JAX package, and chip_smoke.py holds the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

from ddsp_torch.kernels import _build
from ddsp_torch.ops.resample import resample

KERNEL_METHODS = ('window', 'linear')

# Kernel launches so far; a run reads it to show its path went through K1.
launches = 0


def harmonic_synthesis_plain(phase0: torch.Tensor, f0_env: torch.Tensor,
                             ham: torch.Tensor, sample_rate: int = 16000,
                             amp_resample_method: str = 'window'):
  """audio[b, n] = sum_h [f0[n] h < sr/2] A_h[n] sin(h phase0[n]).

  phase0, f0_env: [batch, n_samples]; ham: frame amplitudes
  [batch, n_frames, n_harmonics]. Materializes [batch, n_samples, H].
  """
  n_samples = phase0.shape[1]
  n_harmonics = ham.shape[-1]
  amplitude_envelopes = resample(ham, n_samples, method=amp_resample_method)
  f_ratios = torch.linspace(1.0, float(n_harmonics), n_harmonics,
                            device=ham.device)
  amplitude_envelopes = torch.where(
      f0_env[..., None] * f_ratios >= sample_rate / 2.0,
      torch.zeros_like(amplitude_envelopes), amplitude_envelopes)
  wavs = torch.sin(phase0[..., None] * f_ratios)
  return torch.sum(amplitude_envelopes * wavs, dim=-1)


def _check(phase0, f0_env, ham, amp_resample_method):
  if amp_resample_method not in KERNEL_METHODS:
    raise ValueError(f'K1 supports {KERNEL_METHODS}, not '
                     f'{amp_resample_method!r}.')
  if phase0.ndim != 2 or f0_env.shape != phase0.shape or ham.ndim != 3:
    raise ValueError('K1 takes phase0/f0_env [batch, n_samples] and ham '
                     f'[batch, n_frames, H]; got {tuple(phase0.shape)}, '
                     f'{tuple(f0_env.shape)}, {tuple(ham.shape)}.')
  batch, n_samples = phase0.shape
  if batch > 65535:
    raise ValueError(f'K1 takes at most 65535 batch rows, not {batch}.')
  if ham.shape[0] != batch or n_samples % ham.shape[1] != 0:
    raise ValueError(f'ham {tuple(ham.shape)} does not match phase0 '
                     f'{tuple(phase0.shape)} (n_samples % n_frames must be 0).')
  for name, t in (('phase0', phase0), ('f0_env', f0_env), ('ham', ham)):
    if t.dtype != torch.float32:
      raise TypeError(f'K1 takes float32 {name}, not {t.dtype}.')
    if t.device != phase0.device:
      raise ValueError(f'{name} is on {t.device}, phase0 on {phase0.device}.')


_SIGNATURES = {
    'ddsp_harmonic_fwd': [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def _launch(phase0, f0_env, ham, sample_rate, amp_resample_method):
  global launches
  fn = _build.load('harmonic', _SIGNATURES).ddsp_harmonic_fwd
  phase0, f0_env, ham = (t.contiguous() for t in (phase0, f0_env, ham))
  batch, n_samples = phase0.shape
  out = torch.empty_like(phase0)
  with torch.cuda.device(phase0.device):
    stream = torch.cuda.current_stream().cuda_stream
    status = fn(phase0.data_ptr(), f0_env.data_ptr(), ham.data_ptr(),
                out.data_ptr(), batch, n_samples, ham.shape[1], ham.shape[2],
                sample_rate / 2.0, int(amp_resample_method == 'linear'),
                stream)
  _build.check(status, 'ddsp_harmonic_fwd')
  launches += 1
  return out


def fused_harmonic_synthesis(phase0: torch.Tensor, f0_env: torch.Tensor,
                             ham: torch.Tensor, sample_rate: int = 16000,
                             amp_resample_method: str = 'window'):
  """Fused audio synthesis from fundamental phase and frame amplitudes.

  Args:
    phase0: Accumulated fundamental phase (radians), [batch, n_samples].
    f0_env: Fundamental frequency envelope (Hz), [batch, n_samples]; used
      for the Nyquist mask only.
    ham: Frame harmonic amplitudes (amplitudes * harmonic distribution),
      [batch, n_frames, n_harmonics], n_samples % n_frames == 0.
    sample_rate: Hz.
    amp_resample_method: 'window' (hann) or 'linear' 2-tap upsampling.

  Returns:
    audio [batch, n_samples] float32. A CUDA input launches K1; a CPU input
    takes the plain version.
  """
  _check(phase0, f0_env, ham, amp_resample_method)
  if phase0.device.type == 'cpu':
    return harmonic_synthesis_plain(phase0, f0_env, ham, sample_rate,
                                    amp_resample_method)
  if phase0.device.type != 'cuda':
    raise ValueError(f'K1 runs on CUDA or the CPU, not {phase0.device}.')
  return _launch(phase0, f0_env, ham, sample_rate, amp_resample_method)
