"""Kernel family K1: fused harmonic synthesis from the fundamental phase.

Wraps csrc/harmonic.cu, which replaces the three Pallas kernels of
ddsp_tpu/ops/pallas_kernels/harmonic.py: _fwd_kernel (K1f), _bwd_taps_kernel
(K1t) and _bwd_phase_kernel (K1p). `HarmonicSynthesis` is the
torch.autograd.Function around them: a CUDA tensor launches the kernels in
both directions, a CPU tensor takes the plain PyTorch versions beside them
(`harmonic_synthesis_plain`, `harmonic_bwd_taps_plain` + `fold_taps`,
`harmonic_bwd_phase_plain`). The CPU tests hold the plain versions against
the JAX package, and chip_smoke.py holds each kernel against its plain
version.

On an H100 the K1 kernels are bound by instruction issue, not by bytes or
fp32 operations (csrc/harmonic.cu says how). K1f splits each hop over
threads that take several samples of it (4 at a training batch, 1 for one
request; the C entry picks from the batch and the card's SMs), so one
float4 of amplitudes feeds them all, and counts each sample's audible
harmonics once. K1t keeps the sine chains and a 4-harmonic x 2-tap tile
of sums in registers, reduces each hop's partials by warp shuffles and a
fixed-order pass through shared memory, and folds the taps onto frames
itself: it writes dham [B, F, H], with no [B, F, 2, H] intermediate, the
same from run to run. Any number of
harmonics runs on the kernels: where K1t's partials outgrow shared memory
it splits the harmonics over blocks. All kernels wrap the phase mod 2 pi to
within one float32 rounding; the plain backward versions wrap it in
float64, which agrees with that. The Pallas kernels wrap by float32(2 pi)
instead, so on a long unwrapped phase the port's backward departs from
theirs by design (ROADMAP.md section 3 gives the size).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ddsp_torch.kernels import _build
from ddsp_torch.ops.resample import resample

KERNEL_METHODS = ('window', 'linear')

# Kernel launches so far, per kernel; a run reads them to show which
# kernels its path went through.
launches: Dict[str, int] = {'fwd': 0, 'bwd_taps': 0, 'bwd_phase': 0}


def reset_launches() -> None:
  for key in launches:
    launches[key] = 0


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


def _sample_terms(phase0, f0_env, n_harmonics, sample_rate, trig):
  """mask * trig(h * wrapped phase), [batch, n_samples, H]: the forward's
  wrapped phase and its mask rule h >= nyquist / max(f0, 1e-20)."""
  ratios = torch.linspace(1.0, float(n_harmonics), n_harmonics,
                          device=phase0.device)
  # Wrapped in float64: float32's `%` would wrap by float32(2 pi), which
  # is 1.75e-7 off, and a training step's cumsum phase makes ~1e3 turns.
  phase = torch.remainder(phase0.double(), 2.0 * np.pi).float()
  # A true division (scalar / tensor would multiply by a reciprocal, which
  # rounds differently and flips the mask where hmax is an integer).
  hmax = torch.full_like(f0_env, sample_rate / 2.0) / torch.clamp(f0_env,
                                                                  min=1e-20)
  terms = trig(phase[..., None] * ratios)
  return torch.where(hmax[..., None] <= ratios, torch.zeros_like(terms),
                     terms), ratios


def _tap_weights(hop: int, method: str, device) -> torch.Tensor:
  """(fall, rise) per sample of a hop, [2, hop]; float64 rounded once."""
  d = np.arange(hop, dtype=np.float64)
  if method == 'window':
    rise = 0.5 - 0.5 * np.cos(np.pi * d / hop)
  else:
    rise = d / hop
  return torch.as_tensor(np.stack([1.0 - rise, rise]).astype(np.float32),
                         device=device)


def fold_taps(dtaps: torch.Tensor) -> torch.Tensor:
  """Per-hop tap partials [B, F, 2, H] -> frame cotangent dham [B, F, H].

  Tap 0 of hop k belongs to frame k and tap 1 to frame k + 1; the endpoint
  frame was a copy of the last frame, so its share folds onto that one.
  """
  dham = dtaps[:, :, 0].clone()
  dham[:, 1:] += dtaps[:, :-1, 1]
  dham[:, -1] += dtaps[:, -1, 1]
  return dham


def harmonic_bwd_taps_plain(phase0: torch.Tensor, f0_env: torch.Tensor,
                            g: torch.Tensor, n_frames: int, n_harmonics: int,
                            sample_rate: int = 16000,
                            amp_resample_method: str = 'window'):
  """dtaps[b, k, j, h] = sum_d w_j[d] g[b, n] mask sin(h phase[b, n]).

  The plain version of K1t: per-hop partials [batch, n_frames, 2, H] with
  n = k * hop + d and w = (fall, rise); `fold_taps` turns them into dham.
  """
  batch, n_samples = phase0.shape
  hop = n_samples // n_frames
  sins, _ = _sample_terms(phase0, f0_env, n_harmonics, sample_rate, torch.sin)
  weights = _tap_weights(hop, amp_resample_method, phase0.device)
  gw = g.reshape(batch, n_frames, 1, hop) * weights[None, None]
  return torch.matmul(gw, sins.reshape(batch, n_frames, hop, n_harmonics))


def harmonic_bwd_phase_plain(phase0: torch.Tensor, f0_env: torch.Tensor,
                             ham: torch.Tensor, g: torch.Tensor,
                             sample_rate: int = 16000,
                             amp_resample_method: str = 'window'):
  """dphase[b, n] = g sum_h A_h h cos(h phase) mask: the plain version of
  K1p."""
  n_samples = phase0.shape[1]
  coss, ratios = _sample_terms(phase0, f0_env, ham.shape[-1], sample_rate,
                               torch.cos)
  amplitude_envelopes = resample(ham, n_samples, method=amp_resample_method)
  return g * torch.sum(amplitude_envelopes * ratios * coss, dim=-1)


_PTR = ctypes.c_void_p
_SHAPE_ARGS = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int]
_SIGNATURES = {
    'ddsp_harmonic_fwd': [_PTR] * 4 + _SHAPE_ARGS + [_PTR],
    'ddsp_harmonic_bwd_taps': [_PTR] * 4 + _SHAPE_ARGS + [_PTR],
    'ddsp_harmonic_bwd_phase': [_PTR] * 5 + _SHAPE_ARGS + [_PTR],
}


def _launch(name, inputs, out, n_frames, n_harmonics, sample_rate,
            amp_resample_method):
  """Run C entry `ddsp_harmonic_<name>` on contiguous float32 `inputs`
  ([batch, n_samples] streams and ham) into `out` ([batch, n_samples], or
  dham [batch, n_frames, H] for 'bwd_taps'), on the current stream of the
  inputs' device."""
  fn = getattr(_build.load('harmonic', _SIGNATURES), f'ddsp_harmonic_{name}')
  batch, n_samples = inputs[0].shape
  with torch.cuda.device(inputs[0].device):
    stream = torch.cuda.current_stream().cuda_stream
    status = fn(*(t.data_ptr() for t in inputs), out.data_ptr(), batch,
                n_samples, n_frames, n_harmonics, sample_rate / 2.0,
                int(amp_resample_method == 'linear'), stream)
  _build.check(status, f'ddsp_harmonic_{name}')
  launches[name] += 1
  return out


class HarmonicSynthesis(torch.autograd.Function):
  """K1 with its backward: kernels on CUDA tensors, plain versions on CPU
  tensors, the same gradients either way.

  Gradients: dham from K1t (on the CPU: per-hop partials, then
  `fold_taps`; on CUDA the kernel folds them itself), dphase from K1p only
  when the phase needs one, none for f0_env (the Nyquist mask is piecewise
  constant).
  """

  @staticmethod
  def forward(ctx, phase0, f0_env, ham, sample_rate, amp_resample_method):
    ctx.sample_rate = sample_rate
    ctx.method = amp_resample_method
    phase0, f0_env, ham = (t.contiguous() for t in (phase0, f0_env, ham))
    if any(ctx.needs_input_grad):  # nothing is kept when serving
      ctx.save_for_backward(phase0, f0_env, ham)
    if phase0.device.type == 'cpu':
      return harmonic_synthesis_plain(phase0, f0_env, ham, sample_rate,
                                      amp_resample_method)
    return _launch('fwd', (phase0, f0_env, ham), torch.empty_like(phase0),
                   ham.shape[1], ham.shape[2], sample_rate,
                   amp_resample_method)

  @staticmethod
  def backward(ctx, g):
    phase0, f0_env, ham = ctx.saved_tensors
    _, n_frames, n_harmonics = ham.shape
    g = g.contiguous()  # autograd may hand over an expanded cotangent
    on_cpu = phase0.device.type == 'cpu'
    dphase = dham = None
    if ctx.needs_input_grad[2]:
      if on_cpu:
        dham = fold_taps(harmonic_bwd_taps_plain(
            phase0, f0_env, g, n_frames, n_harmonics, ctx.sample_rate,
            ctx.method))
      else:
        dham = _launch('bwd_taps', (phase0, f0_env, g), torch.empty_like(ham),
                       n_frames, n_harmonics, ctx.sample_rate, ctx.method)
    if ctx.needs_input_grad[0]:
      if on_cpu:
        dphase = harmonic_bwd_phase_plain(phase0, f0_env, ham, g,
                                          ctx.sample_rate, ctx.method)
      else:
        dphase = _launch('bwd_phase', (phase0, f0_env, ham, g),
                         torch.empty_like(phase0), n_frames, n_harmonics,
                         ctx.sample_rate, ctx.method)
    return dphase, None, dham, None, None


def fused_harmonic_synthesis(phase0: torch.Tensor, f0_env: torch.Tensor,
                             ham: torch.Tensor, sample_rate: int = 16000,
                             amp_resample_method: str = 'window'):
  """Fused audio synthesis from fundamental phase and frame amplitudes.

  Args:
    phase0: Accumulated fundamental phase (radians), [batch, n_samples].
    f0_env: Fundamental frequency envelope (Hz), [batch, n_samples]; used
      for the Nyquist mask only (it gets no gradient).
    ham: Frame harmonic amplitudes (amplitudes * harmonic distribution),
      [batch, n_frames, n_harmonics], n_samples % n_frames == 0.
    sample_rate: Hz.
    amp_resample_method: 'window' (hann) or 'linear' 2-tap upsampling.

  Returns:
    audio [batch, n_samples] float32, differentiable in phase0 and ham. A
    CUDA input launches K1f (and K1t, K1p in backward); a CPU input takes
    the plain versions.
  """
  _check(phase0, f0_env, ham, amp_resample_method)
  if phase0.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'K1 runs on CUDA or the CPU, not {phase0.device}.')
  return HarmonicSynthesis.apply(phase0, f0_env, ham, sample_rate,
                                 amp_resample_method)
