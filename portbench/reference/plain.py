"""Plain PyTorch of the DDSP operations that the configurations use.

Each function follows the published DDSP operation (ddsp/core.py,
ddsp/spectral_ops.py, ddsp/synths.py, ddsp/effects.py, ddsp/losses.py of
the reference library) with the conventions the port keeps: tf.signal's
framing and periodic hann window, the legacy tf.image.resize coordinates,
float32 audio. Where the arithmetic could be done more exactly than the
program does it, the departure is named in the docstring. Nothing here
imports the program.

`Precision` says in what precision the configuration's products run: as
the configuration states (bfloat16 operands with float32 sums where it
names bfloat16, full float32 elsewhere), or, for the control that has to
come out as not correct, in the nearest precision below: bfloat16
operands rounded through float8 e4m3 first, float32 products in TF32.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Sequence

import numpy as np
import torch

TWO_PI = 2.0 * np.pi
LOG_10 = float(np.log(np.float32(10.0)))
FP8_MAX = 448.0  # float8 e4m3's largest finite value


@dataclasses.dataclass(frozen=True)
class Precision:
  """How the operands of a reduced-precision product are rounded.

  dtype: the compute dtype the configuration states for these products
    ('bfloat16' or 'float32').
  lower: the control: bfloat16 operands round through float8 e4m3 first
    (straight-through: the gradient passes as the cast's would), and
    float32 products run in TF32 (`products`).
  """

  dtype: str = 'bfloat16'
  lower: bool = False

  @property
  def torch_dtype(self) -> torch.dtype:
    return torch.bfloat16 if self.dtype == 'bfloat16' else torch.float32

  def __call__(self, x: torch.Tensor) -> torch.Tensor:
    y = x.to(self.torch_dtype)
    if self.lower and self.dtype == 'bfloat16':
      low = y.float().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
      y = y + (low.to(y.dtype) - y).detach()
    return y

  @contextlib.contextmanager
  def products(self):
    """Float32 matrix products and convolutions in full float32, or in
    TF32 for the control; the process's setting is restored after."""
    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = self.lower
    torch.backends.cudnn.allow_tf32 = self.lower
    try:
      yield
    finally:
      (torch.backends.cuda.matmul.allow_tf32,
       torch.backends.cudnn.allow_tf32) = kept


def exp_sigmoid(x: torch.Tensor) -> torch.Tensor:
  """2 sigmoid(x) ** log(10) + 1e-7 (ddsp.core.exp_sigmoid)."""
  return 2.0 * torch.sigmoid(x.float())**LOG_10 + 1e-7


def safe_log(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
  return torch.log(torch.where(x <= 0.0, torch.full_like(x, eps), x))


def hz_to_midi(f0_hz: torch.Tensor) -> torch.Tensor:
  """12 log2(f / 440) + 69, and MIDI 0 for f <= 0."""
  log2 = safe_log(torch.full_like(f0_hz, 2.0))
  notes = 12.0 * (safe_log(f0_hz) / log2 -
                  safe_log(torch.full_like(f0_hz, 440.0)) / log2) + 69.0
  return torch.where(f0_hz <= 0.0, torch.zeros_like(notes), notes)


def hann(size: int, device) -> torch.Tensor:
  """Periodic hann window."""
  t = torch.arange(size, dtype=torch.float32, device=device)
  return 0.5 - 0.5 * torch.cos(2.0 * np.pi * t / size)


def resample_linear(x: torch.Tensor, n_out: int) -> torch.Tensor:
  """[batch, n_in, ch] -> [batch, n_out, ch], linear, legacy resize
  coordinates without aligned corners (source i * n_in / n_out)."""
  n_in = x.shape[1]
  src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
  lo = np.floor(src).astype(np.int64)
  w = torch.as_tensor((src - lo).astype(np.float32), device=x.device)
  w = w.reshape((1, n_out) + (1,) * (x.ndim - 2))
  lo_t = torch.as_tensor(np.clip(lo, 0, n_in - 1), device=x.device)
  hi_t = torch.as_tensor(np.clip(lo + 1, 0, n_in - 1), device=x.device)
  return x[:, lo_t] * (1.0 - w) + x[:, hi_t] * w


def resample_window(x: torch.Tensor, n_out: int) -> torch.Tensor:
  """[batch, n_frames, ch] -> [batch, n_out, ch] by overlap-added hann
  windows of two hops (ddsp.core.upsample_with_windows, with an end
  point)."""
  x = torch.cat([x, x[:, -1:]], dim=1)
  hop = n_out // (x.shape[1] - 1)
  window = hann(2 * hop, x.device)
  rise, fall = window[:hop], window[hop:]
  seg = (x[:, 1:, None, :] * rise[:, None] + x[:, :-1, None, :] *
         fall[:, None])
  return seg.reshape(x.shape[0], n_out, x.shape[-1])


def phase(omega: torch.Tensor, round_to_float32: bool) -> torch.Tensor:
  """The fundamental's phase [batch, n, 1], summed in float64.

  round_to_float32: round each sample once to float32, as the program's
  training path accumulates it (ddsp_torch's phase_cumsum; the JAX package
  alike). Otherwise it stays float64 (the program's long renders wrap a
  float32 carry instead, which is within a float32 rounding of this)."""
  summed = torch.cumsum(omega.double(), dim=1)
  return summed.float().double() if round_to_float32 else summed


def harmonic_synthesis(f0_hz: torch.Tensor, amplitudes: torch.Tensor,
                       harmonic_distribution: torch.Tensor, n_samples: int,
                       sample_rate: int, round_phase: bool,
                       normalize: bool = True) -> torch.Tensor:
  """Harmonic(60)'s audio [batch, n_samples] from frame-rate controls.

  amplitudes [b, f, 1] and harmonic_distribution [b, f, H] are raw network
  outputs (exp_sigmoid applied here). With `normalize` (the Harmonic
  processor) harmonics at or above Nyquist are muted at frame rate and the
  distribution is normalised; without it (the bare synthesis of the
  long-audio step) the distribution is taken as it is. Every sample mutes
  the harmonics at or above Nyquist, h >= (sr / 2) / f0. The sines are
  taken of the wrapped phase in float64.
  """
  amps = exp_sigmoid(amplitudes)
  dist = exp_sigmoid(harmonic_distribution)
  n_harmonics = dist.shape[-1]
  ratios = torch.linspace(1.0, float(n_harmonics), n_harmonics,
                          device=dist.device)
  if normalize:
    dist = torch.where(f0_hz * ratios >= sample_rate / 2.0,
                       torch.zeros_like(dist), dist)
    total = dist.sum(dim=-1, keepdim=True)
    dist = dist / torch.where(total == 0.0, torch.full_like(total, 1e-7),
                              total)
  envelopes = resample_window(amps * dist, n_samples)
  f0_env = resample_linear(f0_hz, n_samples)
  omega = f0_env * TWO_PI / float(sample_rate)
  wrapped = torch.remainder(phase(omega, round_phase), TWO_PI)
  hmax = torch.full_like(f0_env, sample_rate / 2.0) / torch.clamp(
      f0_env, min=1e-20)
  muted = hmax <= ratios
  sines = torch.sin(wrapped * ratios.double()).float()
  envelopes = torch.where(muted, torch.zeros_like(envelopes), envelopes)
  return torch.sum(envelopes * sines, dim=-1)


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
  """[batch, n_frames, length] -> [batch, (n_frames - 1) * hop + length];
  length is a multiple of hop."""
  batch, n_frames, length = frames.shape
  k = length // hop
  total = (n_frames + k - 1) * hop
  out = None
  for j in range(k):
    part = frames[:, :, j * hop:(j + 1) * hop].reshape(batch, n_frames * hop)
    part = torch.nn.functional.pad(part, (j * hop, total - j * hop -
                                          n_frames * hop))
    out = part if out is None else out + part
  return out


def filtered_noise(noise: torch.Tensor, magnitudes: torch.Tensor
                   ) -> torch.Tensor:
  """FilteredNoise(window_size=0) of its scaled magnitudes [b, f, bands]:
  white noise [b, n] through one FIR per frame, designed by frequency
  sampling and a hann window, convolved frame by frame, with the
  linear-phase delay removed."""
  ir = torch.fft.irfft(magnitudes.float().to(torch.complex64))
  ir_size = ir.shape[-1]
  ir = torch.fft.fftshift(torch.fft.fftshift(hann(ir_size, ir.device)) * ir,
                          dim=-1)
  batch, n_samples = noise.shape
  n_frames = ir.shape[1]
  hop = -(-n_samples // n_frames)
  padded = torch.nn.functional.pad(noise, (0, n_frames * hop - n_samples))
  frames = padded.reshape(batch, n_frames, hop)
  fft_size = int(2**np.ceil(np.log2(hop + ir_size - 1)))
  out = torch.fft.irfft(torch.fft.rfft(frames, fft_size) *
                        torch.fft.rfft(ir, fft_size), fft_size)
  out = overlap_add(out, hop)
  start = (ir_size - 1) // 2 - 1
  return out[:, start:start + n_samples]


def reverb(audio: torch.Tensor, ir: torch.Tensor) -> torch.Tensor:
  """Reverb(trainable): audio plus audio convolved with the IR [taps]
  whose first sample is masked, cut to the audio's length."""
  ir = torch.cat([ir.new_zeros(1), ir[1:]])
  n = audio.shape[1]
  size = int(2**np.ceil(np.log2(n + ir.shape[0] - 1)))
  wet = torch.fft.irfft(torch.fft.rfft(audio, size) *
                        torch.fft.rfft(ir, size)[None], size)[:, :n]
  return audio + wet


def stft_mag(audio: torch.Tensor, size: int, overlap: float = 0.75
             ) -> torch.Tensor:
  """|STFT| [b, frames, size // 2 + 1]: hop size * (1 - overlap), the end
  zero-padded so that frames = ceil(n / hop), periodic hann."""
  hop = int(size * (1.0 - overlap))
  n = audio.shape[1]
  n_frames = -(-n // hop)
  pad = max(0, (n_frames - 1) * hop + size - n)
  frames = torch.nn.functional.pad(audio, (0, pad)).unfold(1, size, hop)
  return torch.abs(torch.fft.rfft(frames * hann(size, audio.device), size))


def spectral_loss(target: torch.Tensor, audio: torch.Tensor, fft_sizes,
                  mag_weight: float = 1.0, logmag_weight: float = 1.0
                  ) -> torch.Tensor:
  """The multi-scale L1 loss of magnitudes and log magnitudes."""
  loss = 0.0
  for size in fft_sizes:
    t, v = stft_mag(target, size), stft_mag(audio, size)
    loss = loss + mag_weight * torch.mean(torch.abs(t - v))
    loss = loss + logmag_weight * torch.mean(torch.abs(safe_log(t) -
                                                       safe_log(v)))
  return loss


def a_weighting(n_fft: int, sample_rate: int) -> np.ndarray:
  """A-weighting (IEC 61672) in linear power on the rfft bins, -80 dB
  floor."""
  f_sq = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)**2.0
  c = np.array([12194.217, 20.598997, 107.65265, 737.86223])**2.0
  with np.errstate(divide='ignore'):
    db = 2.0 + 20.0 * (np.log10(c[0]) + 2 * np.log10(f_sq) -
                       np.log10(f_sq + c[0]) - np.log10(f_sq + c[1]) -
                       0.5 * np.log10(f_sq + c[2]) -
                       0.5 * np.log10(f_sq + c[3]))
  db = np.maximum(-80.0, db).astype(np.float32)
  return 10**(db / 10)


def loudness_db(audio: torch.Tensor, sample_rate: int, frame_rate: int,
                n_fft: int = 512, range_db: float = 80.0) -> torch.Tensor:
  """A-weighted loudness [b, n / hop + 1] in dB, centred frames."""
  hop = sample_rate // frame_rate
  padded = torch.nn.functional.pad(audio, (n_fft // 2, n_fft // 2))
  frames = padded.unfold(1, n_fft, hop) * hann(n_fft, audio.device)
  s = torch.fft.rfft(frames, n_fft)
  weights = torch.as_tensor(a_weighting(n_fft, sample_rate),
                            device=audio.device)
  power = torch.mean((s.real**2 + s.imag**2) * weights, dim=-1)
  power = torch.clamp(power, min=10**-(range_db / 10.0))
  db = 10.0 * (safe_log(power) / safe_log(torch.full_like(power, 10.0)))
  return torch.clamp(db, min=-range_db)


def dense(x, kernel, bias, cast: Precision) -> torch.Tensor:
  return cast(x) @ cast(kernel) + cast(bias)


def layer_norm(x, scale, bias, cast: Precision, eps: float = 1e-3):
  """Float32 statistics (E[x^2] - E[x]^2), the output cast."""
  xf = x.float()
  mean = xf.mean(dim=-1, keepdim=True)
  var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                    min=0.0)
  return cast((xf - mean) * torch.rsqrt(var + eps) * scale + bias)


def fc_stack(x, params, prefix: str, layers: int, cast: Precision):
  """Dense -> LayerNorm -> leaky ReLU (0.2), `layers` times."""
  for i in range(layers):
    p = f'{prefix}.Fc_{i}'
    x = dense(x, params[f'{p}.Dense_0.kernel'], params[f'{p}.Dense_0.bias'],
              cast)
    x = layer_norm(x, params[f'{p}.LayerNorm_0.scale'],
                   params[f'{p}.LayerNorm_0.bias'], cast)
    x = torch.nn.functional.leaky_relu(x, negative_slope=0.2)
  return x


def gru(x, wi, wh, bi, bn, cast: Precision) -> torch.Tensor:
  """Reset-after GRU over [b, t, in] from a zero state -> [b, t, H]
  float32: n = tanh(x W_in + b_in + r (h W_hn + b_hn)), h' = (1 - z) n +
  z h. The input projection is one product of cast operands with a float32
  sum. In bfloat16 the recurrence streams cast operands where it has at
  least 8 steps and a multiple of 128 units, the configurations' widths
  (the JAX package's rule for its bfloat16 kernel), and float32 ones
  otherwise; gates and carry are float32."""
  hidden = wh.shape[0]
  xp = cast(x).float() @ cast(wi).float() + bi
  low = (cast.dtype == 'bfloat16' and x.shape[1] >= 8 and
         hidden % 128 == 0)
  stream = cast if low else (lambda v: v.float())
  xp = stream(xp)
  whf = stream(wh).float()
  h = x.new_zeros((x.shape[0], hidden), dtype=torch.float32)
  ys = []
  for t in range(x.shape[1]):
    xt = xp[:, t].float()
    hp = stream(h).float() @ whf
    r = torch.sigmoid(xt[:, :hidden] + hp[:, :hidden])
    z = torch.sigmoid(xt[:, hidden:2 * hidden] + hp[:, hidden:2 * hidden])
    n = torch.tanh(xt[:, 2 * hidden:] + r * (hp[:, 2 * hidden:] + bn))
    h = (1.0 - z) * n + z * h
    ys.append(h)
  return torch.stack(ys, dim=1)


def adam_steps(params, batches: Sequence, noises: Sequence, cfg,
               cast: Precision, loss_fn, opt=None):
  """The optimiser `opt` (the configuration's by default: a global-norm
  clip unless grad_clip_norm is None, then Adam with exponential decay)
  over len(batches) steps of the sum of the loss terms that
  loss_fn(params, batch, noise, cfg, cast) returns, from `params`.

  Returns (each step's total loss, the first step's terms, the first
  gradients as the optimiser takes them, after the clip, {name: tensor},
  the parameters after the last step)."""
  opt = opt or cfg['optimizer']
  names = list(params)
  p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
  mu = {k: torch.zeros_like(v) for k, v in p.items()}
  nu = {k: torch.zeros_like(v) for k, v in p.items()}
  losses, first, terms = [], None, None
  for count, (batch, noise) in enumerate(zip(batches, noises)):
    parts = loss_fn(p, batch, noise, cfg, cast)
    loss = sum(parts.values())
    grads = torch.autograd.grad(loss, [p[k] for k in names])
    losses.append(float(loss.detach()))
    if terms is None:
      terms = {k: float(v.detach()) for k, v in parts.items()}
    with torch.no_grad():
      if opt['grad_clip_norm'] is not None:
        norm = torch.sqrt(sum(g.double().pow(2).sum()
                              for g in grads)).float()
        scale = opt['grad_clip_norm'] / torch.clamp(
            norm, min=opt['grad_clip_norm'])
        grads = [g * scale for g in grads]
      if first is None:
        first = {k: g.clone() for k, g in zip(names, grads)}
      lr = opt['learning_rate'] * opt['lr_decay_rate']**(
          count / opt['lr_decay_steps'])
      b1, b2, eps = opt['b1'], opt['b2'], opt['eps']
      for k, g in zip(names, grads):
        mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
        nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (nu[k] / (1.0 - b2**(count + 1))).sqrt_().add_(eps)
        p[k].addcdiv_(mu[k], denom, value=-lr / (1.0 - b1**(count + 1)))
  return losses, terms, first, {k: v.detach() for k, v in p.items()}
