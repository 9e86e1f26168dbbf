"""Autoencoders with a quantized MIDI representation at the bottleneck.

Port of ddsp_tpu/models/midi_autoencoder.py (MarginLoss, SlownessLoss,
MidiAutoencoder, ZMidiAutoencoder). Two stacked branches share one processor
group:
  * the synthcoder: (f0, loudness) -> synth controls -> synth_audio;
  * the MIDI branch: synth controls -> midi_encoder -> quantized pitch
    (straight-through) -> midi_decoder -> synth controls -> midi_audio.

Each processor-group call draws its own noise (FilteredNoise, and the
trainable reverb's IR): the caller hands the synthcoder branch `noise` and
the MIDI branch `midi_noise` (each a tensor, or a dict {processor name:
tensor}), or a `generator` both branches draw from in turn. Loss keys are
the JAX package's: flax names a loss module bound to a field by the field's
name, so the closeness, slowness and pitch losses report under their field
names whatever `name` they were built with.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ddsp_torch.losses.spectral import Loss
from ddsp_torch.models.model import Model, TensorDict
from ddsp_torch.nn import stops
from ddsp_torch.ops.core import amplitude_to_db, diff, hz_to_midi, midi_to_hz
from ddsp_torch.proc.effects import FilteredNoiseReverb
from ddsp_torch.proc.processors import Add, ProcessorGroup
from ddsp_torch.proc.synths import FilteredNoise, Harmonic


class MarginLoss(Loss):
  """Penalizes values past a margin: weight * mean(relu(|x| - margin))."""

  def __init__(self, weight: float = 1.0, margin: float = 0.5,
               name: Optional[str] = None):
    super().__init__(name)
    self.weight = weight
    self.margin = margin

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    return self.weight * torch.mean(torch.relu(torch.abs(x) - self.margin))


class SlownessLoss(Loss):
  """Penalizes the temporal variation of a latent, masked per time step."""

  def __init__(self, weight: float = 1.0, name: Optional[str] = None):
    super().__init__(name)
    self.weight = weight

  def forward(self, z: torch.Tensor,
              loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    dz = torch.abs(diff(z[..., 0] if z.ndim == 3 else z, axis=1))
    if loss_mask is not None:
      dz = dz * loss_mask[:, 1:]
    return self.weight * torch.mean(dz)


class MidiAutoencoder(Model):
  """Autoencoder with a quantized MIDI pitch bottleneck.

  Attributes:
    synthcoder: Decoder network (f0, loudness -> amplitudes,
      harmonic_distribution, magnitudes), e.g. DilatedConvDecoder.
    midi_encoder: Optional network (f0_midi, amps, hd, noise) -> (z_pitch,
      z_vel). If None, the ground-truth MIDI comes from
      features['note_active_velocities'].
    midi_decoder: MidiToHarmonicDecoder (q_pitch -> controls and f0).
    sg_before_midiae: Stop gradients between the branches.
    reverb: Append a trainable FilteredNoiseReverb to the default group.
    preprocessor: F0LoudnessPreprocessor or F0PowerPreprocessor.
    processor_group: Optional replacement of the default harmonic + noise
      + add (+ reverb) group (default_pg).
    reconstruction_losses: LossGroup over the outputs dict.
    qpitch_f0rec_loss / pitch_f0rec_loss: Losses of |pitch - f0_rec|.
    pitch_qpitch_loss: Loss between unquantized and quantized pitch.
    midi_slowness_loss: SlownessLoss of the pitch latent on short notes.
    mask_f0_loss: Mask the f0 loss where f0 and the ground-truth MIDI
      differ by 2 semitones or more.
    n_samples / sample_rate / reverb_length: The default group's sizes.
  """

  def __init__(self, synthcoder: Optional[nn.Module] = None,
               midi_encoder: Optional[nn.Module] = None,
               midi_decoder: Optional[nn.Module] = None,
               sg_before_midiae: bool = True, reverb: bool = True,
               preprocessor: Optional[nn.Module] = None,
               processor_group: Optional[nn.Module] = None,
               reconstruction_losses: Optional[nn.Module] = None,
               qpitch_f0rec_loss: Optional[nn.Module] = None,
               pitch_f0rec_loss: Optional[nn.Module] = None,
               pitch_qpitch_loss: Optional[nn.Module] = None,
               midi_slowness_loss: Optional[nn.Module] = None,
               mask_f0_loss: bool = True, n_samples: int = 64000,
               sample_rate: int = 16000, reverb_length: int = 24000):
    super().__init__()
    self.synthcoder = synthcoder
    self.midi_encoder = midi_encoder
    self.midi_decoder = midi_decoder
    self.sg_before_midiae = sg_before_midiae
    self.preprocessor = preprocessor
    self.processor_group = processor_group
    self.reconstruction_losses = reconstruction_losses
    self.qpitch_f0rec_loss = qpitch_f0rec_loss
    self.pitch_f0rec_loss = pitch_f0rec_loss
    self.pitch_qpitch_loss = pitch_qpitch_loss
    self.midi_slowness_loss = midi_slowness_loss
    self.mask_f0_loss = mask_f0_loss
    self.n_samples = n_samples
    self.sample_rate = sample_rate
    self.default_pg = None
    if processor_group is None:
      dag = [
          (Harmonic(n_samples=n_samples, sample_rate=sample_rate,
                    name='harmonic'),
           ['amplitudes', 'harmonic_distribution', 'f0_hz']),
          (FilteredNoise(n_samples=n_samples, name='filtered_noise'),
           ['magnitudes']),
          (Add(name='add'), ['filtered_noise/signal', 'harmonic/signal']),
      ]
      if reverb:
        dag.append((FilteredNoiseReverb(
            trainable=True, reverb_length=reverb_length, n_frames=500,
            n_filter_banks=32, name='reverb'), ['add/signal']))
      self.default_pg = ProcessorGroup(dag)

  @property
  def db_key(self) -> str:
    # F0PowerPreprocessor emits 'pw_scaled' and 'power_db'.
    out_keys = tuple(getattr(self.preprocessor, 'output_keys', ()))
    return 'power_db' if 'pw_scaled' in out_keys else 'loudness_db'

  def _pg(self) -> nn.Module:
    return (self.processor_group if self.processor_group is not None
            else self.default_pg)

  def _render(self, pg_in: TensorDict, noise=None, generator=None):
    """The processor group on pg_in: (audio, its outputs dict)."""
    synth_params = self._pg().get_controls(pg_in, noise=noise,
                                           generator=generator)
    return self._pg().get_signal(synth_params), synth_params

  # ----- MIDI helpers -------------------------------------------------------
  def encode_to_midi(self, *args):
    """(f0_midi, amps, hd, noise) -> (z_pitch, q_pitch, z_vel, q_vel)."""
    if self.sg_before_midiae:
      args = [a.detach() for a in args]
    enc_out = self.midi_encoder(*args)
    z_pitch, z_vel = enc_out['z_pitch'], enc_out['z_vel']
    q_pitch = stops.straight_through_int_quantization(z_pitch)
    z_vel = z_vel * 0.0  # Velocities unused, as in the reference.
    return z_pitch, q_pitch, z_vel, z_vel

  @staticmethod
  def extract_harm_controls(synth_params: TensorDict, log_scale: bool = True,
                            stop_gradient: bool = False):
    """(amps, hd, noise) controls of a processor group's outputs."""
    amps = synth_params['harmonic']['controls']['amplitudes']
    hd = synth_params['harmonic']['controls']['harmonic_distribution']
    noise = synth_params['filtered_noise']['controls']['magnitudes']
    if log_scale:
      amps = amplitude_to_db(amps)
      noise = amplitude_to_db(noise)
    if stop_gradient:
      amps, hd, noise = amps.detach(), hd.detach(), noise.detach()
    return amps, hd, noise

  @staticmethod
  def pianoroll_to_midi(pianoroll: torch.Tensor):
    """Piano roll [..., 128] -> monophonic (notes, velocities) [..., 1]."""
    notes = torch.argmax(pianoroll, dim=-1).to(torch.float32)[..., None]
    velocities = torch.amax(pianoroll, dim=-1)[..., None]
    return notes, velocities

  @staticmethod
  def midi_to_pianoroll(q_pitch: torch.Tensor, q_vel: torch.Tensor,
                        piano_keys: int = 128,
                        thresh: float = 20.0) -> torch.Tensor:
    """Quantized pitch -> a one-hot piano roll [..., piano_keys].

    Pitches at or below thresh are silence. As jax.nn.one_hot of the
    int32 cast (which truncates toward zero), a key outside [0,
    piano_keys) gives an all-zero row.
    """
    del q_vel  # Velocity ignored, as in the reference.
    midi_space = q_pitch[..., 0] if q_pitch.ndim == 3 else q_pitch
    if thresh > 0.0:
      midi_space = midi_space * (midi_space > thresh).to(midi_space.dtype)
    keys = midi_space.to(torch.int32)[..., None]
    return (keys == torch.arange(piano_keys, dtype=torch.int32,
                                 device=keys.device)).to(torch.float32)

  # ----- Branches -----------------------------------------------------------
  def preprocess(self, features: TensorDict) -> TensorDict:
    features = dict(features)
    features.update(self.preprocessor(features))
    features['f0_midi'] = hz_to_midi(features['f0_hz'])
    features['db'] = features[self.db_key]
    return features

  def synthesize_audio(self, features: TensorDict,
                       z: Optional[torch.Tensor] = None,
                       training: bool = False, noise=None, generator=None):
    """The synthcoder and the processor group: (audio, synth_params)."""
    features = dict(features)
    if z is not None:
      features['z'] = z
    features.update(self.synthcoder(features, training=training))
    return self._render(features, noise, generator)

  def midi_to_audio(self, q_pitch: torch.Tensor, q_vel: torch.Tensor,
                    z: Optional[torch.Tensor] = None,
                    return_synth_params: bool = False, noise=None,
                    generator=None):
    """Audio [batch, n_samples] from MIDI pitch q_pitch [batch, time, 1]
    (and q_vel, unused) through the midi decoder and the processor group."""
    midi_audio, midi_synth_params = self._render(
        self.midi_decoder(q_pitch, q_vel, z), noise, generator)
    if return_synth_params:
      return midi_audio, midi_synth_params
    return midi_audio

  def get_gt_midi(self, features: TensorDict):
    """Ground-truth MIDI conditioning from features['note_active_velocities']
    (q_pitch, q_vel, f0 loss weights)."""
    q_pitch, q_vel = self.pianoroll_to_midi(
        features['note_active_velocities'])
    q_vel = q_vel * 0.0
    f0_loss_weights = None
    if self.mask_f0_loss:
      f0_loss_weights = (torch.abs(features['f0_midi'] - q_pitch) <
                         2.0).to(torch.float32)
    return q_pitch, q_vel, f0_loss_weights

  # ----- Loss helpers -------------------------------------------------------
  def _closeness_loss(self, losses_dict, field: str, f0, pitch):
    loss_obj = getattr(self, field)
    if loss_obj is not None:
      losses_dict[field] = loss_obj(torch.abs(pitch - f0))

  def _slowness_loss(self, losses_dict, z_pitch, q_pitch):
    if self.midi_slowness_loss is not None:
      note_mask = stops.get_note_mask(q_pitch, note_on_only=False)
      note_lengths = stops.get_note_lengths(note_mask)
      note_pitches = stops.get_note_moments(q_pitch[..., 0], note_mask,
                                            return_std=False)
      loss_mask = stops.get_short_note_loss_mask(
          note_mask, note_lengths, note_pitches, min_length=40)
      losses_dict['midi_slowness_loss'] = self.midi_slowness_loss(
          z_pitch, loss_mask)

  def _zpitch_losses(self, losses_dict, z_pitch, q_pitch, f0_midi_pred):
    if z_pitch is not None:
      self._slowness_loss(losses_dict, z_pitch, q_pitch)
      if self.pitch_qpitch_loss is not None:
        losses_dict['pitch_qpitch_loss'] = self.pitch_qpitch_loss(z_pitch,
                                                                  q_pitch)
      self._closeness_loss(losses_dict, 'pitch_f0rec_loss', f0_midi_pred,
                           z_pitch)

  def _midi_conditioning(self, features: TensorDict, amps, hd, noise):
    """(z_pitch, q_pitch, q_vel, f0 loss weights): the encoder's, or the
    ground truth's."""
    if self.midi_encoder is not None:
      f0_midi = features['f0_midi']
      z_pitch, q_pitch, _, q_vel = self.encode_to_midi(f0_midi, amps, hd,
                                                       noise)
      return z_pitch, q_pitch, q_vel, torch.ones_like(f0_midi)
    q_pitch, q_vel, f0_loss_weights = self.get_gt_midi(features)
    return None, q_pitch, q_vel, f0_loss_weights

  # ----- Forward ------------------------------------------------------------
  def forward_with_losses(self, features: TensorDict, training: bool = True,
                          compute_losses: bool = True, noise=None,
                          midi_noise=None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[TensorDict, TensorDict]:
    """Outputs and losses of both branches; noise / midi_noise / generator
    feed each branch's noise processors (module docstring)."""
    losses_dict = {}
    features = self.preprocess(features)

    synth_audio, synth_params = self.synthcoder_branch(
        features, training, noise=noise, generator=generator)
    amps, hd, noise_db = self.extract_harm_controls(synth_params)
    z_pitch, q_pitch, q_vel, f0_loss_weights = self._midi_conditioning(
        features, amps, hd, noise_db)

    if self.midi_decoder is None:
      f0_midi_pred = q_pitch
      midi_synth_params, midi_audio = synth_params, synth_audio
      amps_pred, hd_pred, noise_pred = amps, hd, noise_db
    else:
      pg_in = self.midi_decoder(q_pitch, q_vel)
      f0_midi_pred = pg_in['f0_midi']
      midi_audio, midi_synth_params = self._render(pg_in, midi_noise,
                                                   generator)
      amps_pred, hd_pred, noise_pred = self.extract_harm_controls(
          midi_synth_params)
      if compute_losses:
        self._zpitch_losses(losses_dict, z_pitch, q_pitch, f0_midi_pred)
        self._closeness_loss(losses_dict, 'qpitch_f0rec_loss', f0_midi_pred,
                             q_pitch)

    outputs = self._assemble_outputs(
        features, losses_dict, compute_losses, synth_params, synth_audio,
        midi_synth_params, midi_audio, q_pitch, q_vel, f0_midi_pred,
        amps, hd, noise_db, amps_pred, hd_pred, noise_pred, f0_loss_weights,
        extra_outputs={'z_pitch': z_pitch})
    return outputs, losses_dict

  def _assemble_outputs(self, features, losses_dict, compute_losses,
                        synth_params, synth_audio, midi_synth_params,
                        midi_audio, q_pitch, q_vel, f0_midi_pred,
                        amps, hd, noise, amps_pred, hd_pred, noise_pred,
                        f0_loss_weights, extra_outputs=None):
    """The outputs dict of both classes, and the reconstruction losses."""
    outputs = {
        'synth_params': synth_params,
        'synth_audio': synth_audio,
        'midi_synth_params': midi_synth_params,
        'midi_audio': midi_audio,
        'q_pitch': q_pitch,
        'q_vel': q_vel,
        'pianoroll': self.midi_to_pianoroll(q_pitch, q_vel),
        'f0_midi_pred': f0_midi_pred,
        'f0_hz_pred': midi_to_hz(f0_midi_pred),
        'amps': amps,
        'hd': hd,
        'noise': noise,
        'amps_pred': amps_pred,
        'hd_pred': hd_pred,
        'noise_pred': noise_pred,
        'f0_loss_weights': f0_loss_weights,
        f'{self.db_key}_pred': features['db'],
    }
    outputs.update(extra_outputs or {})
    outputs = {k: v for k, v in outputs.items() if v is not None}
    outputs.update({k: v for k, v in features.items() if k not in outputs})
    outputs.update(synth_params)
    if compute_losses and self.reconstruction_losses is not None:
      losses_dict.update(self.reconstruction_losses(outputs))
    return outputs

  def synthcoder_branch(self, features: TensorDict, training: bool,
                        z: Optional[torch.Tensor] = None, noise=None,
                        generator=None):
    return self.synthesize_audio(features, z=z, training=training,
                                 noise=noise, generator=generator)

  def get_audio_from_outputs(self, outputs: TensorDict) -> torch.Tensor:
    return (outputs['midi_audio'] if self.midi_decoder is None else
            outputs['synth_audio'])


class ZMidiAutoencoder(MidiAutoencoder):
  """MidiAutoencoder with synth, global and per-note latents.

  Attributes (besides MidiAutoencoder's):
    z_synth_encoders: Encoders whose concatenated z conditions the
      synthcoder (registered as z_synth_encoders_<i>, flax's names).
    z_global_encoders: Encoders whose concatenated z conditions the MIDI
      decoder (z_global_encoders_<i>).
    z_note_encoder: Encoder pooled over each note of the quantized pitch,
      conditioning the MIDI decoder.
    z_preconditioning_stack: Network applied to the MIDI decoder's z.
    z_global_prior / z_note_prior: Optional prior modules: their
      get_losses_dict(z) adds a loss, and calling them returns the z passed
      on.
  """

  def __init__(self, *args, z_synth_encoders: Sequence[nn.Module] = (),
               z_global_encoders: Sequence[nn.Module] = (),
               z_note_encoder: Optional[nn.Module] = None,
               z_preconditioning_stack: Optional[nn.Module] = None,
               z_global_prior: Optional[nn.Module] = None,
               z_note_prior: Optional[nn.Module] = None, **kwargs):
    super().__init__(*args, **kwargs)
    self.n_synth_encoders = len(z_synth_encoders)
    self.n_global_encoders = len(z_global_encoders)
    for i, enc in enumerate(z_synth_encoders):
      self.add_module(f'z_synth_encoders_{i}', enc)
    for i, enc in enumerate(z_global_encoders):
      self.add_module(f'z_global_encoders_{i}', enc)
    self.z_note_encoder = z_note_encoder
    self.z_preconditioning_stack = z_preconditioning_stack
    self.z_global_prior = z_global_prior
    self.z_note_prior = z_note_prior

  def _encode(self, prefix: str, count: int,
              features: TensorDict) -> Optional[torch.Tensor]:
    if not count:
      return None
    return torch.cat([getattr(self, f'{prefix}_{i}')(features)['z']
                      for i in range(count)], dim=-1)

  def z_synth_encode(self, features: TensorDict) -> Optional[torch.Tensor]:
    return self._encode('z_synth_encoders', self.n_synth_encoders, features)

  def z_global_encode(self, features: TensorDict) -> Optional[torch.Tensor]:
    return self._encode('z_global_encoders', self.n_global_encoders,
                        features)

  def z_note_encode(self, features: TensorDict,
                    q_pitch: torch.Tensor) -> Optional[torch.Tensor]:
    if self.z_note_encoder is None:
      return None
    z_notes = self.z_note_encoder(features)['z']
    z_notes, _ = stops.pool_over_notes(z_notes, stops.get_note_mask(q_pitch))
    return z_notes

  def forward_with_losses(self, features: TensorDict, training: bool = True,
                          compute_losses: bool = True, noise=None,
                          midi_noise=None,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[TensorDict, TensorDict]:
    losses_dict = {}
    features = self.preprocess(features)

    synth_audio, synth_params = self.synthcoder_branch(
        features, training, self.z_synth_encode(features), noise=noise,
        generator=generator)
    amps, hd, noise_db = self.extract_harm_controls(synth_params)
    # The scaled controls, for the expression and note encoders.
    features['amps_scaled'] = amps
    features['hd_scaled'] = hd
    features['noise_scaled'] = noise_db
    z_pitch, q_pitch, q_vel, f0_loss_weights = self._midi_conditioning(
        features, amps, hd, noise_db)

    z_global, z_notes = None, None
    if self.midi_decoder is None:
      f0_midi_pred = q_pitch
      midi_synth_params, midi_audio = synth_params, synth_audio
      amps_pred, hd_pred, noise_pred = amps, hd, noise_db
    else:
      z_global = self.z_global_encode(features)
      z_notes = self.z_note_encode(features, q_pitch)
      if self.z_global_prior is not None:
        losses_dict.update(self.z_global_prior.get_losses_dict(z_global))
        z_global = self.z_global_prior(z_global)
      if self.z_note_prior is not None:
        losses_dict.update(self.z_note_prior.get_losses_dict(z_notes))
        z_notes = self.z_note_prior(z_notes)

      if z_notes is None:
        z_midi_decoder = z_global
      elif z_global is None:
        z_midi_decoder = z_notes
      else:
        z_midi_decoder = torch.cat([z_global, z_notes], dim=-1)
      if self.z_preconditioning_stack is not None:
        z_midi_decoder = self.z_preconditioning_stack(z_midi_decoder)

      pg_in = self.midi_decoder(q_pitch, q_vel, z_midi_decoder)
      f0_midi_pred = pg_in['f0_midi']
      midi_audio, midi_synth_params = self._render(pg_in, midi_noise,
                                                   generator)
      amps_pred, hd_pred, noise_pred = self.extract_harm_controls(
          midi_synth_params)
      if compute_losses:
        self._closeness_loss(losses_dict, 'qpitch_f0rec_loss', f0_midi_pred,
                             q_pitch)
        self._zpitch_losses(losses_dict, z_pitch, q_pitch, f0_midi_pred)

    outputs = self._assemble_outputs(
        features, losses_dict, compute_losses, synth_params, synth_audio,
        midi_synth_params, midi_audio, q_pitch, q_vel, f0_midi_pred,
        amps, hd, noise_db, amps_pred, hd_pred, noise_pred, f0_loss_weights,
        extra_outputs={'z_pitch': z_pitch, 'z_vel': None,
                       'z_global': z_global, 'z_notes': z_notes})
    return outputs, losses_dict

