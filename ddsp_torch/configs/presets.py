"""Model presets (port of ae, solo_instrument, tiny, vst, midiae and
inverse_synthesis, ddsp_tpu/configs/presets.py).

Each preset builds its modules on the CPU; utils.build_model moves them to
the device. SpectralLoss has no parameters, so a JAX parameter tree loads
into a preset's model as it is.
"""

from __future__ import annotations

from ddsp_torch import losses as losses_lib
from ddsp_torch import nn, proc
from ddsp_torch.models import (Autoencoder, InverseSynthesis, MarginLoss,
                               MidiAutoencoder)
from ddsp_torch.utils.registry import register_preset


def _synth_dag(n_samples: int, sample_rate: int,
               use_angular_cumsum: bool = False) -> list:
  """Harmonic + FilteredNoise -> Add: the autoencoders' synthesizer."""
  return [
      (proc.Harmonic(n_samples=n_samples, sample_rate=sample_rate,
                     use_angular_cumsum=use_angular_cumsum, name='harmonic'),
       ['amps', 'harmonic_distribution', 'f0_hz']),
      (proc.FilteredNoise(n_samples=n_samples, window_size=0,
                          name='filtered_noise'),
       ['noise_magnitudes']),
      (proc.Add(name='add'), ['filtered_noise/signal', 'harmonic/signal']),
  ]


@register_preset('ae')
def ae(n_samples: int = 64000,
       sample_rate: int = 16000,
       time_steps: int = 1000,
       n_harmonics: int = 100,
       n_noise_magnitudes: int = 65,
       z_dims: int = 16,
       z_time_steps: int = 125,
       rnn_channels: int = 512,
       ch: int = 512,
       layers_per_stack: int = 3,
       compute_loudness_fresh: bool = True,
       compute_dtype: str = 'bfloat16') -> Autoencoder:
  """NSynth-style autoencoder decoding from (loudness, f0, z).

  ddsp_tpu/configs/presets.py:22-71 (gin/models/ae.gin). The encoder reads
  the audio: MFCCs, instance norm, a GRU and a Dense to z at z_time_steps,
  resampled to time_steps. Its GRU runs in bf16 whatever compute_dtype
  says, as in the JAX package; compute_dtype sets the decoder's and the
  loss's. No reverb.
  """
  return Autoencoder(
      preprocessor=nn.F0LoudnessPreprocessor(
          time_steps=time_steps, sample_rate=sample_rate,
          compute_loudness_fresh=compute_loudness_fresh),
      encoder=nn.MfccTimeDistributedRnnEncoder(
          rnn_channels=rnn_channels, rnn_type='gru', z_dims=z_dims,
          z_time_steps=z_time_steps),
      decoder=nn.RnnFcDecoder(
          rnn_channels=rnn_channels, rnn_type='gru', ch=ch,
          layers_per_stack=layers_per_stack, compute_dtype=compute_dtype,
          input_keys=('ld_scaled', 'f0_scaled', 'z'),
          input_dims=(1, 1, z_dims),
          output_splits=(('amps', 1),
                         ('harmonic_distribution', n_harmonics),
                         ('noise_magnitudes', n_noise_magnitudes))),
      processor_group=proc.ProcessorGroup(_synth_dag(n_samples, sample_rate)),
      losses=(losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                      logmag_weight=1.0,
                                      compute_dtype=compute_dtype),))


@register_preset('solo_instrument')
def solo_instrument(n_samples: int = 64000,
                    sample_rate: int = 16000,
                    time_steps: int = 1000,
                    n_harmonics: int = 60,
                    n_noise_magnitudes: int = 65,
                    reverb_length: int = 48000,
                    rnn_channels: int = 512,
                    ch: int = 512,
                    layers_per_stack: int = 3,
                    reverb: bool = True,
                    use_angular_cumsum: bool = False,
                    compute_loudness_fresh: bool = True,
                    compute_dtype: str = 'bfloat16') -> Autoencoder:
  """Decodes from (loudness, f0) with a trainable reverb."""
  dag = _synth_dag(n_samples, sample_rate, use_angular_cumsum)
  if reverb:
    dag.append((proc.Reverb(trainable=True, reverb_length=reverb_length,
                            name='reverb'), ['add/signal']))
  return Autoencoder(
      preprocessor=nn.F0LoudnessPreprocessor(
          time_steps=time_steps, sample_rate=sample_rate,
          compute_loudness_fresh=compute_loudness_fresh),
      encoder=None,
      decoder=nn.RnnFcDecoder(
          rnn_channels=rnn_channels, rnn_type='gru', ch=ch,
          layers_per_stack=layers_per_stack, compute_dtype=compute_dtype,
          input_keys=('ld_scaled', 'f0_scaled'),
          output_splits=(('amps', 1),
                         ('harmonic_distribution', n_harmonics),
                         ('noise_magnitudes', n_noise_magnitudes))),
      processor_group=proc.ProcessorGroup(dag),
      losses=(losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                      logmag_weight=1.0,
                                      compute_dtype=compute_dtype),))


@register_preset('tiny')
def tiny(n_samples: int = 16000,
         sample_rate: int = 16000,
         time_steps: int = 250,
         n_harmonics: int = 20,
         n_noise_magnitudes: int = 33,
         reverb_length: int = 8000,
         **kwargs) -> Autoencoder:
  """Small solo-instrument model for tests; extra kwargs go to
  solo_instrument."""
  kwargs.setdefault('rnn_channels', 64)
  kwargs.setdefault('ch', 64)
  kwargs.setdefault('layers_per_stack', 1)
  return solo_instrument(n_samples=n_samples, sample_rate=sample_rate,
                         time_steps=time_steps, n_harmonics=n_harmonics,
                         n_noise_magnitudes=n_noise_magnitudes,
                         reverb_length=reverb_length, **kwargs)


@register_preset('vst')
def vst(sample_rate: int = 16000,
        frame_rate: int = 50,
        frame_size: int = 1024,
        n_harmonics: int = 60,
        n_noise_magnitudes: int = 65,
        rnn_channels: int = 512,
        ch: int = 256,
        layers_per_stack: int = 1,
        reverb_length: int = 24000,
        seconds: float = 4.0,
        stateless: bool = False,
        reverb: bool = True,
        use_angular_cumsum: bool = False,
        compute_dtype: str = 'bfloat16') -> Autoencoder:
  """Streaming (VST) autoencoder decoding from (power, f0).

  ddsp_tpu/configs/presets.py:154-222 (gin/models/vst/vst.gin). It
  synthesizes one extra hop for centered framing and crops it from the
  back. compute_dtype is the port's own keyword (the JAX preset always
  runs its decoder in bf16, its default); it sets the decoder's dtype.
  """
  hop_size = sample_rate // frame_rate
  n_samples = int(seconds * sample_rate) + hop_size  # the extra center frame
  dag = [
      (proc.Harmonic(n_samples=n_samples, sample_rate=sample_rate,
                     amp_resample_method='linear',
                     use_angular_cumsum=use_angular_cumsum, name='harmonic'),
       ['amps', 'harmonic_distribution', 'f0_hz']),
      (proc.FilteredNoise(n_samples=n_samples, window_size=0,
                          name='filtered_noise'),
       ['noise_magnitudes']),
      (proc.Add(name='add'), ['filtered_noise/signal', 'harmonic/signal']),
  ]
  if reverb:
    dag.append((proc.FilteredNoiseReverb(
        trainable=True, reverb_length=reverb_length, n_frames=500,
        n_filter_banks=32, name='reverb'), ['add/signal']))
    crop_input = 'reverb/signal'
  else:
    crop_input = 'add/signal'
  dag.append((proc.Crop(frame_size=hop_size, crop_location='back',
                        name='crop'), [crop_input]))
  return Autoencoder(
      preprocessor=nn.OnlineF0PowerPreprocessor(
          frame_rate=frame_rate, frame_size=frame_size, padding='center',
          compute_power=True, compute_f0=False),
      encoder=None,
      decoder=nn.RnnFcDecoder(
          rnn_channels=rnn_channels, rnn_type='gru', ch=ch,
          layers_per_stack=layers_per_stack, stateless=stateless,
          compute_dtype=compute_dtype,
          input_keys=('pw_scaled', 'f0_scaled'),
          output_splits=(('amps', 1),
                         ('harmonic_distribution', n_harmonics),
                         ('noise_magnitudes', n_noise_magnitudes))),
      processor_group=proc.ProcessorGroup(dag),
      losses=(losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                      logmag_weight=1.0),))


@register_preset('midiae')
def midiae(n_samples: int = 64000,
           sample_rate: int = 16000,
           time_steps: int = 1000,
           n_harmonics: int = 60,
           n_noise_magnitudes: int = 65,
           ch: int = 128,
           layers_per_stack: int = 9,
           stacks: int = 2,
           reverb: bool = True,
           reverb_length: int = 24000,
           use_midi_encoder: bool = True) -> MidiAutoencoder:
  """MidiAutoencoder: a dilated-conv synthcoder and a quantized-MIDI
  bottleneck.

  ddsp_tpu/configs/presets.py:223-287 (gin/models/midiae/midiae.gin and its
  midi_encoder mixin): DilatedConvDecoder synthcoder (ch, layers_per_stack,
  stacks, layer norm), HarmonicToMidiEncoder and MidiToHarmonicDecoder on
  DilatedConvStack(ch, 5 layers, 4 stacks, layer norm), the reconstruction
  LossGroup (spectral, f0, amps, hd and noise losses) and the q_pitch
  margin loss; a trainable FilteredNoiseReverb. With
  use_midi_encoder=False the MIDI comes from
  features['note_active_velocities'] (URMP-style data).
  """
  midi_encoder = None
  if use_midi_encoder:
    midi_encoder = nn.HarmonicToMidiEncoder(
        net=nn.DilatedConvStack(2 + n_harmonics + n_noise_magnitudes, ch=ch,
                                layers_per_stack=5, stacks=4,
                                norm_type='layer'))
  recon_losses = losses_lib.LossGroup(dag=[
      (losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                               logmag_weight=1.0,
                               name='synth_spectral_loss'),
       ['audio', 'synth_audio']),
      (losses_lib.ParamLoss(weight=50.0, loss_type='L2', name='f0_loss'),
       ['f0_midi', 'f0_midi_pred', 'f0_loss_weights']),
      (losses_lib.ParamLoss(weight=0.5, name='amps_loss'),
       ['amps', 'amps_pred']),
      (losses_lib.ParamLoss(weight=500.0, name='hd_loss'),
       ['hd', 'hd_pred']),
      (losses_lib.ParamLoss(weight=0.5, name='noise_loss'),
       ['noise', 'noise_pred']),
  ])
  return MidiAutoencoder(
      preprocessor=nn.F0LoudnessPreprocessor(time_steps=time_steps,
                                             sample_rate=sample_rate),
      synthcoder=nn.DilatedConvDecoder(
          ch=ch, layers_per_stack=layers_per_stack, stacks=stacks,
          norm_type='layer', conditioning_keys=(),
          input_keys=('ld_scaled', 'f0_scaled'),
          output_splits=(('amplitudes', 1),
                         ('harmonic_distribution', n_harmonics),
                         ('magnitudes', n_noise_magnitudes))),
      midi_encoder=midi_encoder,
      midi_decoder=nn.MidiToHarmonicDecoder(
          net=nn.DilatedConvStack(1, ch=ch, layers_per_stack=5, stacks=4,
                                  norm_type='layer'),
          f0_residual=True,
          output_splits=(('f0_midi', 1), ('amplitudes', 1),
                         ('harmonic_distribution', n_harmonics),
                         ('magnitudes', n_noise_magnitudes))),
      reconstruction_losses=recon_losses,
      qpitch_f0rec_loss=MarginLoss(weight=50.0, margin=0.5),
      n_samples=n_samples, sample_rate=sample_rate,
      reverb=reverb, reverb_length=reverb_length)


@register_preset('inverse_synthesis')
def inverse_synthesis(n_samples: int = 64000,
                      sample_rate: int = 16000,
                      n_sinusoids: int = 100,
                      freq_depth: int = 64,
                      n_harmonics: int = 100,
                      n_noise_magnitudes: int = 65,
                      resnet_size: str = 'small',
                      reverb: bool = False) -> InverseSynthesis:
  """DDSP-INV, the self-supervised hierarchical model.

  ddsp_tpu/configs/presets.py:289-326 (gin/papers/icml2020/
  pretrain_model.gin): ResnetSinusoidalEncoder (a log mel of 229 bins,
  1024-point frames at hop 256: 250 frames at 4 s) with heads of
  n_sinusoids * freq_depth frequency logits, n_sinusoids amplitudes and
  n_noise_magnitudes noise bands; SinusoidalToHarmonicEncoder on an
  RnnSandwich (FcStacks of 256, a GRU of 512: K2 at T = 250);
  SpectralLoss (L1 mag + logmag); KDE sinusoidal consistency, harmonic
  and filtered-noise consistency.
  """
  return InverseSynthesis(
      sinusoidal_encoder=nn.ResnetSinusoidalEncoder(
          output_splits=(('frequencies', n_sinusoids * freq_depth),
                         ('amplitudes', n_sinusoids),
                         ('noise_magnitudes', n_noise_magnitudes)),
          size=resnet_size),
      harmonic_encoder=nn.SinusoidalToHarmonicEncoder(
          nn.RnnSandwich(2 * n_sinusoids), n_harmonics=n_harmonics,
          f0_depth=freq_depth),
      losses=(losses_lib.SpectralLoss(loss_type='L1', mag_weight=1.0,
                                      logmag_weight=1.0),),
      sinusoidal_consistency_losses=(
          losses_lib.KDEConsistencyLoss(weight_a=1.0, weight_b=1.0,
                                        scale_a=0.1, scale_b=0.1),),
      harmonic_consistency_losses=(
          losses_lib.HarmonicConsistencyLoss(amp_weight=1.0,
                                             dist_weight=1.0,
                                             f0_weight=1.0),),
      filtered_noise_consistency_loss=(
          losses_lib.FilteredNoiseConsistencyLoss(weight=1.0)),
      freq_depth=freq_depth,
      n_samples=n_samples, sample_rate=sample_rate, reverb=reverb)
