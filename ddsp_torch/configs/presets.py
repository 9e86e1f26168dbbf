"""Model presets (port of solo_instrument, tiny and vst,
ddsp_tpu/configs/presets.py).

Each preset builds its modules on the CPU; utils.build_model moves them to
the device. SpectralLoss has no parameters, so a JAX parameter tree loads
into a preset's model as it is.
"""

from __future__ import annotations

from ddsp_torch import losses as losses_lib
from ddsp_torch import nn, proc
from ddsp_torch.models import Autoencoder
from ddsp_torch.utils.registry import register_preset


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
  dag = [
      (proc.Harmonic(n_samples=n_samples, sample_rate=sample_rate,
                     use_angular_cumsum=use_angular_cumsum, name='harmonic'),
       ['amps', 'harmonic_distribution', 'f0_hz']),
      (proc.FilteredNoise(n_samples=n_samples, window_size=0,
                          name='filtered_noise'),
       ['noise_magnitudes']),
      (proc.Add(name='add'), ['filtered_noise/signal', 'harmonic/signal']),
  ]
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
