"""The plain reference of the solo_instrument autoencoder (the DDSP
library's gin/models/solo_instrument.gin): loudness and f0 -> two FC
stacks -> GRU -> FC stack -> dense head -> Harmonic + FilteredNoise ->
Reverb, the multi-scale spectral loss.

Parameters are a flat {name: tensor} under the program's names, so that
the benchmark can hand the same seeded weights to both sides.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from portbench.reference import plain

Params = Dict[str, torch.Tensor]

# The children of the program's model that each layer's forward timing
# (fwd_ms.<layer>.*) covers; a ModuleList stands for its members.
LAYERS = {'nn': ('preprocessor', 'decoder'), 'proc': ('processor_group',),
          'losses': ('losses',)}


def param_spec(cfg) -> List[Tuple[str, Tuple[int, ...]]]:
  """(name, shape) of every trainable leaf, in a fixed order."""
  ch, hidden, layers = cfg['ch'], cfg['rnn_channels'], cfg['layers_per_stack']
  n_out = 1 + cfg['n_harmonics'] + cfg['n_noise_magnitudes']
  spec = []

  def stack(prefix, fan_in):
    for i in range(layers):
      p = f'{prefix}.Fc_{i}'
      spec.extend([(f'{p}.Dense_0.kernel', (fan_in if i == 0 else ch, ch)),
                   (f'{p}.Dense_0.bias', (ch,)),
                   (f'{p}.LayerNorm_0.scale', (ch,)),
                   (f'{p}.LayerNorm_0.bias', (ch,))])

  for i in range(2):
    stack(f'decoder.in_stack_{i}', 1)
  gru = 'decoder.rnn.FastGRU_0'
  spec.extend([(f'{gru}.wi', (2 * ch, 3 * hidden)),
               (f'{gru}.wh', (hidden, 3 * hidden)),
               (f'{gru}.bi', (3 * hidden,)), (f'{gru}.bn', (hidden,))])
  stack('decoder.out_stack', 2 * ch + hidden)
  spec.extend([('decoder.dense_out.kernel', (ch, n_out)),
               ('decoder.dense_out.bias', (n_out,))])
  if cfg['reverb']:
    spec.append(('processor_group.reverb.ir', (cfg['reverb_length'],)))
  return spec


def decode(params: Params, ld_scaled, f0_scaled, cfg,
           cast: plain.Precision) -> Dict[str, torch.Tensor]:
  """The decoder: [b, f, 1] scaled loudness and f0 -> raw controls."""
  layers = cfg['layers_per_stack']
  ins = [plain.fc_stack(x, params, f'decoder.in_stack_{i}', layers, cast)
         for i, x in enumerate((ld_scaled, f0_scaled))]
  g = 'decoder.rnn.FastGRU_0'
  ys = plain.gru(torch.cat(ins, dim=-1), params[f'{g}.wi'],
                 params[f'{g}.wh'], params[f'{g}.bi'], params[f'{g}.bn'], cast)
  x = plain.fc_stack(torch.cat(ins + [cast(ys)], dim=-1), params,
                     'decoder.out_stack', layers, cast)
  out = x.float() @ params['decoder.dense_out.kernel'] + params[
      'decoder.dense_out.bias']
  n_h = cfg['n_harmonics']
  return {'amps': out[..., :1], 'harmonic_distribution': out[..., 1:1 + n_h],
          'noise_magnitudes': out[..., 1 + n_h:]}


def synthesize(params: Params, controls, f0_hz, noise, cfg,
               round_phase: bool, normalize: bool = True) -> torch.Tensor:
  """Harmonic + FilteredNoise, then the reverb: audio [b, n]."""
  n_samples = noise.shape[1]
  harmonic = plain.harmonic_synthesis(
      f0_hz, controls['amps'], controls['harmonic_distribution'], n_samples,
      cfg['sample_rate'], round_phase=round_phase, normalize=normalize)
  audio = plain.filtered_noise(
      noise, plain.exp_sigmoid(controls['noise_magnitudes'] - 5.0)) + harmonic
  if cfg['reverb']:
    audio = plain.reverb(audio, params['processor_group.reverb.ir'])
  return audio


def scaled_features(f0_hz, loudness):
  return loudness / 80.0 + 1.0, plain.hz_to_midi(f0_hz) / 127.0


def training_loss(params: Params, batch, noise, cfg,
                  cast: plain.Precision) -> Dict[str, torch.Tensor]:
  """The training forward: loudness from the audio, the loss under the
  program's name; `noise` holds the step's noise draw under 'noise'."""
  ld = plain.loudness_db(batch['audio'], cfg['sample_rate'],
                         cfg['loudness_frame_rate'])
  ld = plain.resample_linear(ld[..., None], cfg['time_steps'])
  f0_hz = plain.resample_linear(batch['f0_hz'], cfg['time_steps'])
  ld_scaled, f0_scaled = scaled_features(f0_hz, ld)
  controls = decode(params, ld_scaled, f0_scaled, cfg, cast)
  audio = synthesize(params, controls, f0_hz, noise['noise'], cfg,
                     round_phase=True)
  return {'spectral_loss': plain.spectral_loss(batch['audio'], audio,
                                               cfg['fft_sizes'])}


def decoder_loss(params: Params, batch, noise, cfg,
                 cast: plain.Precision) -> Dict[str, torch.Tensor]:
  """The long-audio step's forward (ddsp's sp_synth_and_loss): the
  decoder on the batch's scaled features, the bare harmonic synthesis (the
  distribution not normalised) plus FilteredNoise, no reverb, the loss;
  the phase kept in float64."""
  controls = decode(params, batch['ld_scaled'], batch['f0_scaled'], cfg,
                    cast)
  audio = synthesize(params, controls, batch['f0_hz'], noise['noise'],
                     dict(cfg, reverb=False), round_phase=False,
                     normalize=False)
  return {'spectral_loss': plain.spectral_loss(batch['audio'], audio,
                                               cfg['fft_sizes'])}


@torch.no_grad()
def render(params: Params, f0_hz, loudness_db, noise, cfg,
           cast: plain.Precision) -> torch.Tensor:
  """One request's audio [1, n]: f0_hz and loudness_db [1, f, 1] at the
  model's frame rate, features as given (no loudness from audio)."""
  ld_scaled, f0_scaled = scaled_features(f0_hz, loudness_db)
  controls = decode(params, ld_scaled, f0_scaled, cfg, cast)
  return synthesize(params, controls, f0_hz, noise, cfg, round_phase=False)


def rnn_hidden(cfg) -> int:
  """The GRU's width (K2's H)."""
  return cfg['rnn_channels']


def step_flops(cfg, batch: int, frames: int, passes: int = 3) -> float:
  """Operations of a solo_instrument-style decoder's products over `batch`
  rows of `frames` frames: the FC stacks, the GRU's input projection and
  recurrence and the head, 2 per multiply-add, times `passes` (3 for a
  training step: forward once, backward twice for inputs and weights; 1
  for a forward). FFTs, the synthesizers and elementwise work are not
  counted."""
  ch, hidden, layers = cfg['ch'], cfg['rnn_channels'], cfg['layers_per_stack']
  n_in = len(cfg.get('decoder_inputs', ('ld_scaled', 'f0_scaled')))
  n_out = 1 + cfg['n_harmonics'] + cfg['n_noise_magnitudes']

  def stack(fan_in):
    return fan_in * ch + (layers - 1) * ch * ch

  macs = (n_in * stack(1) + n_in * ch * 3 * hidden + hidden * 3 * hidden +
          stack(n_in * ch + hidden) + ch * n_out)
  return passes * 2.0 * macs * batch * frames
