"""Inverse synthesis (DDSP-INV): audio -> sinusoids -> harmonics -> audio.

Port of ddsp_tpu/models/inverse_synthesis.py. A hierarchical
self-supervised model: a sinusoidal encoder predicts sinusoid and noise
controls straight from audio; a harmonic encoder compresses the sinusoids
into harmonic controls; both levels resynthesize audio through one
Sinusoidal + FilteredNoise (+ FilteredNoiseReverb) processor group.
Self-supervised batches carry ground-truth controls ('sin_amps', ...) from
which the audio is synthesized on the fly; a (normal, self-supervised)
tuple of batches, as ZippedProvider yields, runs both through one forward
of the concatenated rows.

Each processor-group call draws its own noise (FilteredNoise, and the
trainable reverb's IR): the caller hands the sinusoidal level `noise`, the
harmonic level `harmonic_noise` and the synthetic audio `synthetic_noise`
(each a tensor, or a dict {processor name: tensor}), or a `generator`
every call draws from in turn (the synthetic audio first, then the
sinusoidal level, then the harmonic level, as the JAX model draws).

Loss keys are the JAX package's: flax names a loss module in a tuple field
positionally, and the package then keys it by its class's snake_case name;
the TWM and filtered-noise consistency losses, each in a field of its own,
are keyed by the field's name.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.losses.consistency import HarmonicConsistencyLoss
from ddsp_torch.models.model import Model, TensorDict
from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops.oscillator import get_harmonic_frequencies
from ddsp_torch.proc.dags import snake_case
from ddsp_torch.proc.effects import FilteredNoiseReverb
from ddsp_torch.proc.processors import Add, ProcessorGroup
from ddsp_torch.proc.synths import FilteredNoise, Sinusoidal


def _class_name(loss_obj) -> str:
  return snake_case(type(loss_obj).__name__)


class InverseSynthesis(Model):
  """Inverse synthesis model (DDSP-INV).

  Attributes:
    sinusoidal_encoder: Network audio -> raw (frequencies, amplitudes,
      noise_magnitudes) (e.g. ResnetSinusoidalEncoder); the model applies
      the scaling nonlinearities.
    harmonic_encoder: Network (sin_freqs, sin_amps) -> (harm_amp,
      harm_dist, f0_hz) (e.g. SinusoidalToHarmonicEncoder).
    losses: Audio reconstruction losses applied at both levels.
    sinusoidal_consistency_losses: Losses between the sinusoidal and
      harmonic sinusoids (e.g. KDEConsistencyLoss).
    harmonic_consistency_losses: Self-supervised losses on harmonic
      controls.
    filtered_noise_consistency_loss: Self-supervised loss on the noise
      magnitudes.
    twm_loss: Two-way mismatch loss between sinusoids and f0 candidates.
    harmonic_distribution_prior: Prior loss on the harmonic distribution
      (its get_losses_dict(harm_dist) adds its losses).
    freq_depth: Depth of the frequencies_softmax scaling.
    reverb: Append a trainable FilteredNoiseReverb.
    n_samples / sample_rate: Audio dimensions.
    stop_gradient: Block harmonic-level gradients from reaching the
      sinusoidal encoder.
  """

  def __init__(self, sinusoidal_encoder: Optional[nn.Module] = None,
               harmonic_encoder: Optional[nn.Module] = None,
               losses: Sequence[nn.Module] = (),
               sinusoidal_consistency_losses: Sequence[nn.Module] = (),
               harmonic_consistency_losses: Sequence[nn.Module] = (),
               filtered_noise_consistency_loss: Optional[nn.Module] = None,
               twm_loss: Optional[nn.Module] = None,
               harmonic_distribution_prior: Optional[nn.Module] = None,
               freq_depth: int = 64, reverb: bool = True,
               n_samples: int = 64000, sample_rate: int = 16000,
               stop_gradient: bool = True):
    super().__init__()
    self.sinusoidal_encoder = sinusoidal_encoder
    self.harmonic_encoder = harmonic_encoder
    self.losses = nn.ModuleList(losses)
    self.sinusoidal_consistency_losses = nn.ModuleList(
        sinusoidal_consistency_losses)
    self.harmonic_consistency_losses = nn.ModuleList(
        harmonic_consistency_losses)
    self.filtered_noise_consistency_loss = filtered_noise_consistency_loss
    self.twm_loss = twm_loss
    self.harmonic_distribution_prior = harmonic_distribution_prior
    self.freq_depth = freq_depth
    self.n_samples = n_samples
    self.sample_rate = sample_rate
    self.stop_gradient = stop_gradient
    dag = [
        (Sinusoidal(n_samples=n_samples, sample_rate=sample_rate,
                    amp_scale_fn=None, freq_scale_fn=None,
                    name='sinusoidal'), ['amplitudes', 'frequencies']),
        (FilteredNoise(n_samples=n_samples, window_size=0, scale_fn=None,
                       name='filtered_noise'), ['noise_magnitudes']),
        (Add(name='add'), ['filtered_noise/signal', 'sinusoidal/signal']),
    ]
    if reverb:
      dag.append((FilteredNoiseReverb(
          reverb_length=int(sample_rate * 2), window_size=257, n_frames=500,
          n_filter_banks=16, trainable=True, name='reverb'), ['add/signal']))
    self.processor_group = ProcessorGroup(dag)

  @property
  def n_frames(self) -> Optional[int]:
    """Control frames of the sinusoidal encoder at n_samples (250 at 4 s),
    which a self-supervised batch's controls must have; None where the
    encoder does not say."""
    frames = getattr(self.sinusoidal_encoder, 'n_frames', None)
    return frames(self.n_samples) if frames is not None else None

  def generate_synthetic_audio(self, features: TensorDict, noise=None,
                               generator=None) -> torch.Tensor:
    """Audio from the ground-truth synthetic controls."""
    return self.processor_group({
        'amplitudes': features['sin_amps'],
        'frequencies': features['sin_freqs'],
        'noise_magnitudes': features['noise_magnitudes'],
    }, noise=noise, generator=generator)

  @staticmethod
  def parse_zipped_features(features) -> Tuple[TensorDict, TensorDict]:
    """Order a (normal, self-supervised) pair of feature dicts."""
    assert len(features) == 2
    ss_idx = int(features[1].get('sin_amps') is not None)
    s_idx = int(not ss_idx)
    return features[s_idx], features[ss_idx]

  def get_audio_from_outputs(self, outputs: TensorDict) -> torch.Tensor:
    return (outputs['sin_audio'] if self.harmonic_encoder is None else
            outputs['harm_audio'])

  def forward_with_losses(self, features, training: bool = True,
                          compute_losses: bool = True, noise=None,
                          harmonic_noise=None, synthetic_noise=None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[TensorDict, TensorDict]:
    """Outputs and losses of the zipped, self-supervised or plain feed;
    the noise arguments feed each processor-group call (module
    docstring)."""
    losses_dict = {}
    levels = dict(noise=noise, harmonic_noise=harmonic_noise,
                  generator=generator)
    if isinstance(features, (list, tuple)):
      # Train on normal and self-supervised data together, concatenated
      # along the batch for one shared forward pass.
      features, ss_features = self.parse_zipped_features(features)
      ss_features = dict(ss_features)
      ss_features['audio'] = self.generate_synthetic_audio(
          ss_features, synthetic_noise, generator)
      batch_size = features['audio'].shape[0]
      inputs = {'audio': torch.cat([features['audio'], ss_features['audio']],
                                   dim=0)}
      all_outputs = self.forward_levels(inputs, training, **levels)
      outputs = {k: v[:batch_size] for k, v in all_outputs.items()
                 if not isinstance(v, dict)}
      ss_outputs = {k: v[batch_size:] for k, v in all_outputs.items()
                    if not isinstance(v, dict)}
      if compute_losses:
        self.append_losses(losses_dict, outputs)
        self.append_losses(losses_dict, ss_outputs, ss_features)
    elif features.get('sin_amps') is not None:
      # Self-supervised pretraining.
      ss_features = dict(features)
      ss_features['audio'] = self.generate_synthetic_audio(
          ss_features, synthetic_noise, generator)
      outputs = self.forward_levels(ss_features, training, **levels)
      if compute_losses:
        self.append_losses(losses_dict, outputs)
        self.append_losses(losses_dict, outputs, ss_features)
    else:
      outputs = self.forward_levels(features, training, **levels)
      if compute_losses:
        self.append_losses(losses_dict, outputs)
    return outputs, losses_dict

  def append_losses(self, losses_dict: TensorDict, outputs: TensorDict,
                    self_supervised_features: Optional[TensorDict] = None):
    """Compute and accumulate losses into losses_dict."""
    o = outputs
    f = self_supervised_features
    if f is None:
      # The sinusoidal autoencoder's loss.
      for loss_obj in self.losses:
        losses_dict[f'sin_{_class_name(loss_obj)}'] = loss_obj(
            o['audio'], o['sin_audio'])

      if self.harmonic_encoder is not None:
        if self.harmonic_distribution_prior is not None:
          losses_dict.update(
              self.harmonic_distribution_prior.get_losses_dict(
                  o['harm_dist']))

        for loss_obj in self.losses:
          losses_dict[f'harm_{_class_name(loss_obj)}'] = loss_obj(
              o['audio'], o['harm_audio'])

        if len(self.sinusoidal_consistency_losses):
          sin_amps, sin_freqs = o['sin_amps'], o['sin_freqs']
          if self.stop_gradient:
            # Harmonic errors do not reach the sinusoidal predictions.
            sin_amps, sin_freqs = sin_amps.detach(), sin_freqs.detach()
          for loss_obj in self.sinusoidal_consistency_losses:
            losses_dict[_class_name(loss_obj)] = loss_obj(
                sin_amps, sin_freqs, o['harm_amps'], o['harm_freqs'])

      if self.twm_loss is not None:
        f0_c = (o['sin_freqs'] if self.harmonic_encoder is None
                else o['f0_hz'])
        losses_dict['twm_loss'] = self.twm_loss(f0_c, o['sin_freqs'],
                                                o['sin_amps'])
    else:
      # Self-supervised losses against the ground-truth controls.
      for loss_obj in self.sinusoidal_consistency_losses:
        losses_dict[f'ss_{_class_name(loss_obj)}'] = loss_obj(
            o['sin_amps'], o['sin_freqs'], f['sin_amps'], f['sin_freqs'])

      fncl = self.filtered_noise_consistency_loss
      if fncl is not None:
        losses_dict['ss_filtered_noise_consistency_loss'] = fncl(
            o['noise_magnitudes'], f['noise_magnitudes'])

      if self.harmonic_encoder is not None:
        for loss_obj in self.harmonic_consistency_losses:
          if isinstance(loss_obj, HarmonicConsistencyLoss):
            losses = loss_obj(o['harm_amp'], f['harm_amp'],
                              o['harm_dist'], f['harm_dist'],
                              o['f0_hz'], f['f0_hz'])
            losses_dict.update({'ss_' + k: v for k, v in losses.items()})
          else:
            losses_dict[f'ss_harm_{_class_name(loss_obj)}'] = loss_obj(
                o['harm_amp'], o['f0_hz'], f['harm_amp'], f['f0_hz'])

  def forward_levels(self, features: TensorDict, training: bool = True,
                     noise=None, harmonic_noise=None,
                     generator: Optional[torch.Generator] = None
                     ) -> TensorDict:
    """The forward pass without losses (the JAX model's `forward`): audio
    -> sinusoids -> harmonics; `noise` feeds the sinusoidal level's
    processor group, `harmonic_noise` the harmonic level's."""
    audio = features['audio']

    # Audio -> sinusoids.
    pg_in = dict(self.sinusoidal_encoder(features, training=training))

    # The scaling nonlinearities, applied here.
    sin_freqs = ops_core.frequencies_softmax(pg_in['frequencies'],
                                             depth=self.freq_depth)
    sin_amps = ops_core.exp_sigmoid(pg_in['amplitudes'])
    noise_magnitudes = ops_core.exp_sigmoid(pg_in['noise_magnitudes'])
    pg_in['frequencies'] = sin_freqs
    pg_in['amplitudes'] = sin_amps
    pg_in['noise_magnitudes'] = noise_magnitudes

    controls = self.processor_group.get_controls(pg_in, noise=noise,
                                                 generator=generator)
    sin_audio = self.processor_group.get_signal(controls)

    outputs = {
        'audio': audio,
        'noise_magnitudes': noise_magnitudes,
        'sin_audio': sin_audio,
        'sin_amps': sin_amps,
        'sin_freqs': sin_freqs,
    }
    outputs.update(controls)

    # Sinusoids -> harmonics.
    if self.stop_gradient:
      sin_freqs = sin_freqs.detach()
      sin_amps = sin_amps.detach()
      noise_magnitudes = noise_magnitudes.detach()

    if self.harmonic_encoder is not None:
      h_out = self.harmonic_encoder(sin_freqs, sin_amps)
      harm_amp = h_out['harm_amp']
      harm_dist = h_out['harm_dist']
      f0_hz = h_out['f0_hz']

      # Harmonics back to sinusoids.
      harm_freqs = get_harmonic_frequencies(f0_hz, int(harm_dist.shape[-1]))
      harm_amps = harm_amp * harm_dist

      pg_in['frequencies'] = harm_freqs
      pg_in['amplitudes'] = harm_amps
      pg_in['noise_magnitudes'] = noise_magnitudes
      harm_audio = self.processor_group(pg_in, noise=harmonic_noise,
                                        generator=generator)
      outputs.update({
          'harm_audio': harm_audio,
          'harm_amp': harm_amp,
          'harm_dist': harm_dist,
          'f0_hz': f0_hz,
          'harm_freqs': harm_freqs,
          'harm_amps': harm_amps,
      })
    return outputs
