"""Inference-only models served from a params-format artifact.

Port of AutoencoderInference and the streaming (VST) classes of
ddsp_tpu/infer/inference.py (:97-169, :172-423). They load the fmt='params'
layout of ddsp_tpu/infer/export.py: operative_spec.json plus params.npz
with flat 'a/b/c' keys (README.md says how to write one for a vst
checkpoint). Every class runs on CUDA unless given device='cpu'; its calls
take and return tensors on that device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ddsp_torch.nn.preprocessing import (OnlineF0PowerPreprocessor,
                                         inv_scale_f0_hz)
from ddsp_torch.ops.fftconv import frequency_filter
from ddsp_torch.ops.oscillator import streaming_harmonic_synthesis
from ddsp_torch.utils import registry
from ddsp_torch.utils.convert import load_jax_params
from ddsp_torch.utils.device import DeviceLike, resolve_device

PARAMS_FILENAME = 'params.npz'
# Submodules kept when the reverb is removed (the processor group's params
# no longer line up, and a room IR is what removal discards).
_KEYS_WITHOUT_REVERB = ('decoder', 'encoder', 'preprocessor')


def load_params(export_dir: str) -> Dict[str, np.ndarray]:
  """The flat {'a/b/c': array} params of a fmt='params' export."""
  with np.load(os.path.join(export_dir, PARAMS_FILENAME)) as data:
    return {k: data[k] for k in data.files}


class AutoencoderInference:
  """Autoencoder rebuilt from an exported spec, for rendering features.

  As the JAX class does, it mutates the architecture for a new length
  (n_samples and time_steps from length_seconds), forces the chunked
  angular cumsum (bounded phase error on long renders) and
  compute_loudness_fresh=False (features carry loudness), and optionally
  removes the room reverb.

  Call with {'f0_hz': [n_frames], 'loudness_db': [n_frames]}-style features
  (1-D inputs are taken as one unbatched request). With no `noise`,
  FilteredNoise draws from its fixed-seed generator, so a request renders
  the same audio each time, as the JAX class's fixed noise key does.
  """

  def __init__(self, save_dir: str, length_seconds: float = 4,
               remove_reverb: bool = True, device: DeviceLike = None,
               **overrides):
    self.device = resolve_device(device)
    kwargs = registry.load_spec(save_dir)['kwargs']
    self.sample_rate = kwargs.get('sample_rate', 16000)
    n_samples_train = kwargs.get('n_samples', 64000)
    time_steps_train = kwargs.get('time_steps', 1000)
    self.hop_size = n_samples_train // time_steps_train
    self.n_frames = int(length_seconds * self.sample_rate / self.hop_size)
    self.n_samples = self.n_frames * self.hop_size

    mutations = {
        'n_samples': self.n_samples,
        'time_steps': self.n_frames,
        'use_angular_cumsum': True,
        'compute_loudness_fresh': False,
    }
    if remove_reverb:
      mutations['reverb'] = False
    mutations.update(overrides)
    self.applied_mutations = dict(mutations)

    params = load_params(save_dir)
    if remove_reverb:
      params = {k: v for k, v in params.items()
                if k.split('/')[0] in _KEYS_WITHOUT_REVERB}
    self.model = registry.model_from_spec(save_dir, device='cpu',
                                          **mutations)
    load_jax_params(self.model, params)
    self.model.to(self.device).eval()

  @torch.no_grad()
  def __call__(self, features: Dict[str, Any],
               noise: Optional[torch.Tensor] = None) -> Dict[str, Any]:
    """Outputs dict for one request; `noise` overrides the noise draw."""
    batched = {}
    for k, v in features.items():
      if isinstance(v, torch.Tensor):
        v = v.to(self.device, torch.float32)
      else:
        v = torch.as_tensor(np.asarray(v, np.float32), device=self.device)
      if v.ndim == 1:
        v = v[None, :, None]
      batched[k] = v
    return self.model(batched, training=False, noise=noise)

  def get_audio(self, features: Dict[str, Any]) -> torch.Tensor:
    return self(features)['audio_synth']


class _VSTBase:
  """The VST classes' settings, read from the artifact's spec."""

  def __init__(self, save_dir: str, device: DeviceLike = None):
    self.device = resolve_device(device)
    kwargs = registry.load_spec(save_dir)['kwargs']
    self.sample_rate = kwargs.get('sample_rate', 16000)
    self.frame_rate = kwargs.get('frame_rate', 50)
    self.frame_size = kwargs.get('frame_size', 1024)
    self.hop_size = self.sample_rate // self.frame_rate
    self.state_size = kwargs.get('rnn_channels', 512)

  def _tensor(self, x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=self.device)


class VSTExtractFeatures(_VSTBase):
  """One frame of audio [frame_size] -> (f0_hz, f0_scaled, pw_db,
  pw_scaled), each [1]: the power of the frame, 'valid' framing.

  Needs no parameters (the JAX class restores none either). f0 comes from
  CREPE in the JAX package, which is not ported: compute_f0=True raises
  NotImplementedError, and with compute_f0=False f0 is 0 Hz.
  """

  def __init__(self, save_dir: str, compute_f0: bool = True,
               device: DeviceLike = None):
    super().__init__(save_dir, device)
    self.preprocessor = OnlineF0PowerPreprocessor(
        frame_rate=self.frame_rate, frame_size=self.frame_size,
        padding='valid', compute_power=True, compute_f0=compute_f0)
    self._no_f0 = torch.zeros((1, 1), device=self.device)

  @torch.no_grad()
  def __call__(self, audio):
    features = {'audio': self._tensor(audio).reshape(1, self.frame_size),
                'f0_hz': self._no_f0, 'f0_confidence': self._no_f0}
    out = self.preprocessor(features)
    return (out['f0_hz'][0, 0], out['f0_scaled'][0, 0], out['pw_db'][0, 0],
            out['pw_scaled'][0, 0])


class VSTStatelessPredictControls(_VSTBase):
  """Frame controls from (f0_scaled, pw_scaled) with the GRU state passed
  in and out: (amps [1], harmonic distribution [n_harmonics], noise
  magnitudes [n_noise], state [state_size]).

  The artifact's decoder, built stateless, runs one frame (its GRU on K2f's
  float32 route, nn/layers.py FastGRU), then the Harmonic and FilteredNoise
  control nonlinearities. Only the decoder's parameters are read, as the
  JAX class restores only 'decoder'.
  """

  def __init__(self, save_dir: str, device: DeviceLike = None):
    super().__init__(save_dir, device)
    self.model = registry.model_from_spec(save_dir, device='cpu',
                                          stateless=True)
    prefix = 'decoder/'
    load_jax_params(self.model.decoder,
                    {k[len(prefix):]: v
                     for k, v in load_params(save_dir).items()
                     if k.startswith(prefix)})
    self.model.to(self.device).eval()
    group = self.model.processor_group
    self._harmonic, self._filtered_noise = group.harmonic, group.filtered_noise

  def initial_state(self) -> torch.Tensor:
    return torch.zeros((self.state_size,), device=self.device)

  @torch.no_grad()
  def __call__(self, f0_scaled, pw_scaled, state):
    f0_scaled = self._tensor(f0_scaled).reshape(1, 1, 1)
    outputs = self.model.decoder({
        'f0_scaled': f0_scaled,
        'pw_scaled': self._tensor(pw_scaled).reshape(1, 1, 1),
        'state': self._tensor(state).reshape(1, self.state_size)})
    harmonic = self._harmonic.get_controls(
        outputs['amps'], outputs['harmonic_distribution'],
        inv_scale_f0_hz(f0_scaled))
    noise = self._filtered_noise.get_controls(outputs['noise_magnitudes'])
    return (harmonic['amplitudes'][0, 0],
            harmonic['harmonic_distribution'][0, 0],
            noise['magnitudes'][0, 0], outputs['state'][0])


class VSTPredictControls(VSTStatelessPredictControls):
  """VSTStatelessPredictControls that carries the GRU state itself:
  (f0_scaled, pw_scaled) -> (amps, harmonic distribution, noise
  magnitudes). reset() zeroes the state (the reference's Keras
  reset_states())."""

  def __init__(self, save_dir: str, device: DeviceLike = None):
    super().__init__(save_dir, device)
    self.reset()

  def reset(self):
    self._state = self.initial_state()

  def __call__(self, f0_scaled, pw_scaled):
    amps, hd, noise, self._state = super().__call__(f0_scaled, pw_scaled,
                                                    self._state)
    return amps, hd, noise


class VSTSynthesize(_VSTBase):
  """One hop of audio from the previous and current frame controls, with
  the oscillator phase carried between calls.

  (amps, prev_amps, hd, prev_hd, f0, prev_f0, noise, prev_phase) ->
  (audio [hop_size], final_phase [1]). The controls are interpolated over
  the hop (streaming_harmonic_synthesis, linear), and the noise magnitudes
  (already through FilteredNoise's nonlinearity) filter a fixed noise
  buffer, `noise_signal` [1, hop_size], uniform in [-1, 1) from
  torch.Generator().manual_seed(noise_seed). The JAX class's buffer is
  jax.random.uniform(PRNGKey(noise_seed), (1, hop)), which torch cannot
  draw; a caller that needs those samples sets the attribute.
  """

  include_noise = True
  include_harmonic = True

  def __init__(self, save_dir: str, new_hop_size: Optional[int] = None,
               noise_seed: int = 0, device: DeviceLike = None):
    super().__init__(save_dir, device)
    self.hop_size = new_hop_size or self.hop_size
    generator = torch.Generator().manual_seed(noise_seed)
    self.noise_signal = (torch.rand((1, self.hop_size), generator=generator)
                         * 2.0 - 1.0).to(self.device)

  def initial_phase(self) -> torch.Tensor:
    return torch.zeros((1,), device=self.device)

  @torch.no_grad()
  def __call__(self, amps, prev_amps, hd, prev_hd, f0, prev_f0, noise,
               prev_phase):
    audio = final_phase = None
    if self.include_harmonic:
      pairs = [torch.stack([self._tensor(prev), self._tensor(cur)])[None]
               for prev, cur in ((prev_amps, amps), (prev_hd, hd),
                                 (prev_f0, f0))]
      audio, final_phase = streaming_harmonic_synthesis(
          frequencies=pairs[2], amplitudes=pairs[0],
          harmonic_distribution=pairs[1],
          initial_phase=self._tensor(prev_phase).reshape(1, 1, 1),
          n_samples=self.hop_size, sample_rate=self.sample_rate,
          amp_resample_method='linear')
      final_phase = final_phase[0, 0]
    if self.include_noise:
      noise = self._tensor(noise)
      noise_audio = frequency_filter(self.noise_signal,
                                     torch.stack([noise, noise])[None],
                                     window_size=0)
      audio = noise_audio if audio is None else audio + noise_audio
    return audio[0], final_phase


class VSTSynthesizeHarmonic(VSTSynthesize):
  """VSTSynthesize without the noise branch: (amps, prev_amps, hd,
  prev_hd, f0, prev_f0, prev_phase) -> (audio [hop_size], final_phase)."""

  include_noise = False

  def __call__(self, amps, prev_amps, hd, prev_hd, f0, prev_f0, prev_phase):
    return super().__call__(amps, prev_amps, hd, prev_hd, f0, prev_f0, None,
                            prev_phase)


class VSTSynthesizeNoise(VSTSynthesize):
  """VSTSynthesize's noise branch alone: noise magnitudes [n_noise] ->
  audio [hop_size]."""

  include_harmonic = False

  def __call__(self, noise):
    audio, _ = super().__call__(None, None, None, None, None, None, noise,
                                None)
    return audio
