"""Inference-only autoencoder served from the JAX package's export artifact.

Port of AutoencoderInference (ddsp_tpu/infer/inference.py:97-169). It loads
the fmt='params' export of ddsp_tpu/infer/export.py: operative_spec.json
plus params.npz with flat 'a/b/c' keys.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

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
    return self.model(batched, noise=noise)

  def get_audio(self, features: Dict[str, Any]) -> torch.Tensor:
    return self(features)['audio_synth']
