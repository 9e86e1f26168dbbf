"""The plain reference of DDSP-inv's self-supervised pretraining (the
DDSP library's gin/papers/icml2020/pretrain_model.gin, models/
inverse_synthesis.py): synthetic controls -> audio; audio -> log mel ->
ResNet (small) -> sinusoidal controls -> audio; sinusoids -> RnnSandwich
-> harmonic controls -> audio; the spectral losses of both levels, the KDE
consistency between them and with the ground truth, the harmonic and
filtered-noise consistency with the ground truth.

The ResNet's convolutions, its heads and the harmonic heads are float32;
the RnnSandwich's FC stacks and GRU run in bfloat16 (the port's and the
JAX package's layers, bfloat16 by default). Parameters are a flat
{name: tensor} under the program's names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import plain

Params = Dict[str, torch.Tensor]
ENC = 'sinusoidal_encoder'
HARM = 'harmonic_encoder'
MEL_BINS = 229
LOG_2PI = 1.8378770664093453

# The children of the program's model that each layer's forward timing
# (fwd_ms.<layer>.*) covers; a ModuleList stands for its members.
LAYERS = {'nn': (ENC, HARM), 'proc': ('processor_group',),
          'losses': ('losses', 'sinusoidal_consistency_losses',
                     'harmonic_consistency_losses',
                     'filtered_noise_consistency_loss')}


def _stacks(cfg):
  """(filters, blocks, strides) of the ResNet's two residual stacks."""
  ch, blocks = cfg['resnet_ch'], cfg['resnet_blocks']
  return [([ch, 2 * ch, 4 * ch], blocks, [1, 2, 2]),
          ([8 * ch], [3], [2])]


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
  """(name, shape) of every trainable leaf, in a fixed order."""
  spec = []
  r = f'{ENC}.resnet'
  spec += [(f'{r}.Conv_0.kernel', (7, 7, 1, 64)), (f'{r}.Conv_0.bias', (64,))]
  norm = lambda p, c: [(f'{p}.scale', (1, 1, 1, c)), (f'{p}.shift',
                                                      (1, 1, 1, c))]
  conv = lambda p, k, ci, co: [(f'{p}.kernel', (k, k, ci, co)),
                               (f'{p}.bias', (co,))]
  in_ch = 64
  for s, (filters, blocks, _) in enumerate(_stacks(cfg)):
    n = 0
    for f, n_layers in zip(filters, blocks):
      for i in range(n_layers):
        p = f'{r}.ResidualStack_{s}.ResidualLayer_{n}'
        spec += norm(f'{p}.Normalize_0', in_ch)
        if i == 0:
          spec += conv(f'{p}.conv_proj', 1, in_ch, 4 * f)
        spec += conv(f'{p}.Conv_0', 1, in_ch, f)
        spec += norm(f'{p}.NormReluConv_0.Normalize_0', f)
        spec += conv(f'{p}.NormReluConv_0.Conv_0', 3, f, f)
        spec += norm(f'{p}.NormReluConv_1.Normalize_0', f)
        spec += conv(f'{p}.NormReluConv_1.Conv_0', 1, f, 4 * f)
        n += 1
        in_ch = 4 * f
    spec += norm(f'{r}.ResidualStack_{s}.Normalize_0', in_ch)
  width = _mel_width() * in_ch
  for name, size in (('frequencies', cfg['n_sinusoids'] * cfg['freq_depth']),
                     ('amplitudes', cfg['n_sinusoids']),
                     ('noise_magnitudes', cfg['n_noise_magnitudes'])):
    spec += [(f'{ENC}.dense_{name}.kernel', (width, size)),
             (f'{ENC}.dense_{name}.bias', (size,))]
  fc, layers, rnn = cfg['fc_stack_ch'], cfg['fc_stack_layers'], cfg['rnn_ch']

  def fc_stack(prefix, fan_in):
    out = []
    for i in range(layers):
      p = f'{prefix}.Fc_{i}'
      out += [(f'{p}.Dense_0.kernel', (fan_in if i == 0 else fc, fc)),
              (f'{p}.Dense_0.bias', (fc,)),
              (f'{p}.LayerNorm_0.scale', (fc,)),
              (f'{p}.LayerNorm_0.bias', (fc,))]
    return out

  net = f'{HARM}.net'
  spec += fc_stack(f'{net}.FcStack_0', 2 * cfg['n_sinusoids'])
  g = f'{net}.Rnn_0.FastGRU_0'
  spec += [(f'{g}.wi', (fc, 3 * rnn)), (f'{g}.wh', (rnn, 3 * rnn)),
           (f'{g}.bi', (3 * rnn,)), (f'{g}.bn', (rnn,))]
  spec += fc_stack(f'{net}.FcStack_1', rnn)
  for name, size in (('amp_out', 1), ('hd_out', cfg['n_harmonics']),
                     ('f0_out', cfg['freq_depth'])):
    spec += [(f'{HARM}.{name}.kernel', (fc, size)),
             (f'{HARM}.{name}.bias', (size,))]
  return spec


def _mel_width() -> int:
  """Mel bins after the stem, the pool and three strides of 2."""
  n = MEL_BINS
  for _ in range(5):
    n = -(-n // 2)
  return n


def _mel_matrix(n_bins: int, sample_rate: int, device) -> torch.Tensor:
  """tf.signal.linear_to_mel_weight_matrix (HTK mel, 0-8000 Hz, the DC bin
  left out)."""
  mel = lambda f: 1127.0 * np.log1p(f / 700.0)
  freqs = mel(np.linspace(0.0, sample_rate / 2.0, n_bins)[1:])[:, None]
  edges = np.linspace(mel(0.0), mel(sample_rate / 2.0), MEL_BINS + 2)
  lower, center, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
  weights = np.maximum(0.0, np.minimum((freqs - lower) / (center - lower),
                                       (upper - freqs) / (upper - center)))
  weights = np.pad(weights, [[1, 0], [0, 0]]).astype(np.float32)
  return torch.as_tensor(weights, device=device)


def _same(size: int, k: int, s: int) -> Tuple[int, int]:
  out = -(-size // s)
  total = max((out - 1) * s + k - size, 0)
  return total // 2, total - total // 2


def _conv(x, params, prefix, stride=1):
  """'SAME' convolution of NHWC x, striding over frequency (width)."""
  kernel = params[f'{prefix}.kernel']
  k = kernel.shape[0]
  h, w = x.shape[1:3]
  pads = _same(w, k, stride) + _same(h, k, 1)
  y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads),
               kernel.permute(3, 2, 0, 1), params[f'{prefix}.bias'],
               (1, stride))
  return y.permute(0, 2, 3, 1)


def _norm(x, params, prefix, eps=1e-5):
  """Layer normalisation over time, frequency and channels, then the
  learned scale and shift."""
  mean = x.mean(dim=(1, 2, 3), keepdim=True)
  var = x.var(dim=(1, 2, 3), keepdim=True, correction=0)
  x = (x - mean) / torch.sqrt(var + eps)
  return x * params[f'{prefix}.scale'] + params[f'{prefix}.shift']


def resnet(x, params, cfg):
  """[b, t, mel] -> [b, t, mel', 8 ch x 4]."""
  r = f'{ENC}.resnet'
  x = _conv(x[..., None], params, f'{r}.Conv_0', 2)
  pads = _same(x.shape[2], 3, 2) + (0, 0)
  x = F.max_pool2d(F.pad(x.permute(0, 3, 1, 2), pads, value=-math.inf),
                   (1, 3), (1, 2)).permute(0, 2, 3, 1)
  for s, (filters, blocks, strides) in enumerate(_stacks(cfg)):
    n = 0
    for stride, n_layers in zip(strides, blocks):
      for i in range(n_layers):
        p = f'{r}.ResidualStack_{s}.ResidualLayer_{n}'
        step = stride if i == 0 else 1
        h = torch.relu(_norm(x, params, f'{p}.Normalize_0'))
        shortcut = (_conv(h, params, f'{p}.conv_proj', step) if i == 0
                    else x)
        h = _conv(h, params, f'{p}.Conv_0')
        h = _conv(torch.relu(_norm(h, params,
                                   f'{p}.NormReluConv_0.Normalize_0')),
                  params, f'{p}.NormReluConv_0.Conv_0', step)
        h = _conv(torch.relu(_norm(h, params,
                                   f'{p}.NormReluConv_1.Normalize_0')),
                  params, f'{p}.NormReluConv_1.Conv_0')
        x = h + shortcut
        n += 1
    x = torch.relu(_norm(x, params, f'{r}.ResidualStack_{s}.Normalize_0'))
  return x


def unit_to_hz(unit, hz_min, hz_max):
  lo = plain.hz_to_midi(torch.full_like(unit, hz_min))
  hi = plain.hz_to_midi(torch.full_like(unit, hz_max))
  return 440.0 * 2.0**((lo + (hi - lo) * unit - 69.0) / 12.0)


def frequencies_softmax(x, depth, hz_min, hz_max):
  """A softmax over `depth` bins per sinusoid, its mean bin mapped
  logarithmically onto [hz_min, hz_max]: [b, t, n x depth] -> [b, t, n]."""
  x = x.reshape(x.shape[0], x.shape[1], -1, depth)
  bins = torch.linspace(0.0, 1.0, depth, device=x.device)
  return unit_to_hz(torch.sum(bins * torch.softmax(x, dim=-1), dim=-1),
                    hz_min, hz_max)


def sinusoidal(amplitudes, frequencies, n_samples, sample_rate):
  """Sinusoidal(): a bank of free oscillators [b, n] from frame-rate
  amplitudes and frequencies [b, f, k]; an oscillator at or above Nyquist
  is muted. Each phase is summed in float64 and rounded once to float32,
  and its sine taken in float32, as the program's oscillator_bank does:
  the encoder reads the log mel of this audio, whose near-silent bins
  carry any rounding of it to the whole network."""
  amp = plain.resample_window(amplitudes, n_samples)
  freq = plain.resample_linear(frequencies, n_samples)
  amp = torch.where(freq >= sample_rate / 2.0, torch.zeros_like(amp), amp)
  phase = plain.phase(freq * plain.TWO_PI / float(sample_rate), True)
  return torch.sum(amp * torch.sin(phase.float()), dim=-1)


def synth(amplitudes, frequencies, magnitudes, noise, sample_rate):
  """The processor group: Sinusoidal + FilteredNoise, their controls
  already scaled."""
  n = noise.shape[1]
  return (plain.filtered_noise(noise, magnitudes) +
          sinusoidal(amplitudes, frequencies, n, sample_rate))


def encode_sinusoids(params, audio, cfg):
  """Audio -> (sin_amps, sin_freqs, noise_magnitudes), scaled."""
  mag = plain.stft_mag(audio, 1024)
  mel = plain.safe_log(torch.tensordot(
      mag, _mel_matrix(mag.shape[-1], cfg['sample_rate'], audio.device),
      dims=1))
  x = resnet(mel, params, cfg)
  x = x.reshape(x.shape[0], x.shape[1], -1)
  head = lambda name: (x @ params[f'{ENC}.dense_{name}.kernel'] +
                       params[f'{ENC}.dense_{name}.bias'])
  freqs = frequencies_softmax(head('frequencies'), cfg['freq_depth'], 20.0,
                              8000.0)
  return (plain.exp_sigmoid(head('amplitudes')), freqs,
          plain.exp_sigmoid(head('noise_magnitudes')))


def encode_harmonics(params, sin_amps, sin_freqs, cfg, cast):
  """Sinusoids -> (harm_amp, harm_dist, f0_hz) through the RnnSandwich."""
  sr = cfg['sample_rate']
  midi = plain.hz_to_midi(sin_freqs)
  unit = midi / plain.hz_to_midi(torch.full_like(sin_freqs, sr / 2.0))
  net = f'{HARM}.net'
  layers = cfg['fc_stack_layers']
  x = plain.fc_stack(torch.cat([unit, sin_amps], dim=-1), params,
                     f'{net}.FcStack_0', layers, cast)
  g = f'{net}.Rnn_0.FastGRU_0'
  x = plain.gru(x, params[f'{g}.wi'], params[f'{g}.wh'], params[f'{g}.bi'],
                params[f'{g}.bn'], cast)
  x = plain.fc_stack(x, params, f'{net}.FcStack_1', layers, cast).float()
  head = lambda name: x @ params[f'{HARM}.{name}.kernel'] + params[
      f'{HARM}.{name}.bias']
  harm_amp = plain.exp_sigmoid(head('amp_out'))
  harm_dist = plain.exp_sigmoid(head('hd_out'))
  f0_hz = frequencies_softmax(head('f0_out'), cfg['freq_depth'], 20.0,
                              1200.0)
  ratios = torch.linspace(1.0, float(cfg['n_harmonics']),
                          cfg['n_harmonics'], device=x.device)
  harm_dist = torch.where(f0_hz * ratios >= sr / 2.0,
                          torch.zeros_like(harm_dist), harm_dist)
  total = harm_dist.sum(dim=-1, keepdim=True)
  harm_dist = harm_dist / torch.where(total == 0.0,
                                      torch.full_like(total, 1e-7), total)
  return harm_amp, harm_dist, f0_hz


def _mixture_nll(amps, freqs, amps_target, freqs_target, scale):
  """Amplitude-weighted -log p of one trace's sinusoids (MIDI) under the
  other's gaussian mixture: [b, t, k] -> [b, t]."""
  amps_target = torch.where(amps_target == 0.0,
                            torch.full_like(amps_target, 1e-7), amps_target)
  probs = amps_target / amps_target.sum(dim=-1, keepdim=True)
  x = plain.hz_to_midi(freqs)[..., :, None]
  loc = plain.hz_to_midi(freqs_target)[..., None, :]
  log_p = -0.5 * (((x - loc) / scale)**2 + LOG_2PI) - math.log(scale)
  log_w = torch.log(torch.clamp(probs, min=1e-37))[..., None, :]
  nll = -torch.logsumexp(log_p + log_w, dim=-1)
  total = amps.sum(dim=-1, keepdim=True)
  amps_norm = amps / torch.where(total == 0.0, torch.full_like(total, 1e-7),
                                 total)
  return torch.mean(nll * amps_norm, dim=-1)


def kde_loss(amps_a, freqs_a, amps_b, freqs_b, scale=0.1):
  """KDEConsistencyLoss(weight_a=1, weight_b=1, scale_a=scale_b=0.1) with
  its mean-amplitude term."""
  return (torch.mean(_mixture_nll(amps_a, freqs_a, amps_b, freqs_b, scale)) +
          torch.mean(_mixture_nll(amps_b, freqs_b, amps_a, freqs_a, scale)) +
          torch.mean(torch.abs(amps_a.mean(dim=-1) - amps_b.mean(dim=-1))))


def training_loss(params: Params, batch, noise, cfg,
                  cast: plain.Precision) -> Dict[str, torch.Tensor]:
  """The self-supervised step's loss terms, under the program's names, on
  a batch of synthetic controls; `noise` holds the three processor-group
  calls' draws."""
  sr = cfg['sample_rate']
  with torch.no_grad():
    audio = synth(batch['sin_amps'], batch['sin_freqs'],
                  batch['noise_magnitudes'], noise['synthetic_noise'], sr)
  sin_amps, sin_freqs, mags = encode_sinusoids(params, audio, cfg)
  sin_audio = synth(sin_amps, sin_freqs, mags, noise['noise'], sr)
  harm_amp, harm_dist, f0_hz = encode_harmonics(
      params, sin_amps.detach(), sin_freqs.detach(), cfg, cast)
  ratios = torch.linspace(1.0, float(cfg['n_harmonics']),
                          cfg['n_harmonics'], device=audio.device)
  harm_freqs = f0_hz * ratios
  harm_amps = harm_amp * harm_dist
  harm_audio = synth(harm_amps, harm_freqs, mags.detach(),
                     noise['harmonic_noise'], sr)
  sizes = cfg['fft_sizes']
  weights = (batch['harm_amp'] >= 1e-4).float()
  return {
      'sin_spectral_loss': plain.spectral_loss(audio, sin_audio, sizes),
      'harm_spectral_loss': plain.spectral_loss(audio, harm_audio, sizes),
      'kde_consistency_loss': kde_loss(sin_amps.detach(), sin_freqs.detach(),
                                       harm_amps, harm_freqs),
      'ss_kde_consistency_loss': kde_loss(sin_amps, sin_freqs,
                                          batch['sin_amps'],
                                          batch['sin_freqs']),
      'ss_filtered_noise_consistency_loss': torch.mean(
          torch.abs(mags - batch['noise_magnitudes'])),
      'ss_harm_amp_loss': torch.mean(torch.abs(harm_amp - batch['harm_amp'])),
      'ss_harm_dist_loss': torch.mean(
          torch.abs((harm_dist - batch['harm_dist']) * weights)),
      'ss_f0_hz_loss': torch.mean(torch.abs(
          (plain.hz_to_midi(f0_hz) - plain.hz_to_midi(batch['f0_hz'])) *
          weights)),
  }


def rnn_hidden(cfg) -> int:
  """The GRU's width (K2's H)."""
  return cfg['rnn_ch']


def step_flops(cfg, batch: int, frames: int, passes: int = 3) -> float:
  """Operations of DDSP-inv's products over `batch` rows of `frames`
  frames: the ResNet's convolutions over the 229-bin log mel (each at its
  output width), the sinusoidal heads, the RnnSandwich and the harmonic
  heads, 2 per multiply-add, times `passes`. The oscillator banks, the
  FFTs and the consistency losses are not counted."""
  width = -(-229 // 2)
  macs = width * 49 * 64
  width = -(-width // 2)
  in_ch, ch = 64, cfg['resnet_ch']
  for filters, blocks, strides in (([ch, 2 * ch, 4 * ch], cfg['resnet_blocks'],
                                    [1, 2, 2]), ([8 * ch], [3], [2])):
    for f, n_layers, stride in zip(filters, blocks, strides):
      for i in range(n_layers):
        out = -(-width // stride) if i == 0 else width
        if i == 0:
          macs += out * in_ch * 4 * f
        macs += width * in_ch * f + out * 9 * f * f + out * f * 4 * f
        width, in_ch = out, 4 * f
  n_sin = cfg['n_sinusoids']
  macs += width * in_ch * (n_sin * cfg['freq_depth'] + n_sin +
                           cfg['n_noise_magnitudes'])
  fc, rnn = cfg['fc_stack_ch'], cfg['rnn_ch']
  macs += (2 * n_sin * fc + fc * fc + fc * 3 * rnn + rnn * 3 * rnn +
           rnn * fc + fc * fc +
           fc * (1 + cfg['n_harmonics'] + cfg['freq_depth']))
  return passes * 2.0 * macs * batch * frames
