"""The CREPE pitch tracker as a torch module, for batch f0 on the device.

Port of ddsp_tpu/ops/crepe.py: six conv -> ReLU -> BatchNorm -> max-pool
blocks over 1024-sample frames, a sigmoid classifier over 360 pitch bins of
20 cents, the decoding of activations to (f0_hz, confidence) and the
Viterbi-smoothed bin centers.

Weights: the repository commits assets/crepe/model-tiny.npz, written from
model-tiny.h5 by `convert_h5_to_npz` (weights trained on synthetic harmonic
data, not the published CREPE), so the default path needs numpy only. A
model-<size>.h5 of the crepe pip package (keras layer names) is read
through h5py, imported only when such a file is given.

The convolutions and the classifier run in full float32 whatever the
process's TF32 settings (`full_float32`).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ddsp_torch.ops import hmm as hmm_ops
from ddsp_torch.ops.core import full_float32
from ddsp_torch.utils.device import DeviceLike, resolve_device

CREPE_SAMPLE_RATE = 16000
CREPE_FRAME_SIZE = 1024
_N_BINS = 360

# Capacity multiplier per model size (public CREPE).
_CAPACITIES = {'tiny': 4, 'small': 8, 'medium': 16, 'large': 24, 'full': 32}
_FILTERS = (32, 4, 4, 4, 8, 16)
_WIDTHS = (512, 64, 64, 64, 64, 64)
_STRIDES = (4, 1, 1, 1, 1, 1)
# BatchNorm as keras and flax run it: epsilon 1e-3, running statistics.
_BN_EPSILON = 1e-3

# Pitch bin centers in cents above 10 Hz (CREPE convention).
_CENT_MAPPING = (np.linspace(0, 7180, _N_BINS) +
                 1997.3794084376191).astype(np.float32)


def _assets_dir() -> str:
  return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
      os.path.abspath(__file__)))), 'assets', 'crepe')


def default_weights_path(model_capacity: str) -> Optional[str]:
  """The first model-<size>.npz or model-<size>.h5 in $CREPE_WEIGHTS_DIR,
  then in the repository's assets/crepe (the committed tiny weights)."""
  dirs = [d for d in (os.environ.get('CREPE_WEIGHTS_DIR', ''),
                      _assets_dir()) if d]
  for d in dirs:
    for ext in ('npz', 'h5'):
      path = os.path.join(d, f'model-{model_capacity}.{ext}')
      if os.path.exists(path):
        return path
  return None


def _same_padding(width: int, stride: int, length: int) -> Tuple[int, int]:
  """flax/keras padding='SAME': (left, right) zeros for a conv of `width`
  and `stride` over `length` samples."""
  n_out = -(-length // stride)
  total = max((n_out - 1) * stride + width - length, 0)
  return total // 2, total - total // 2


class BatchNorm(nn.Module):
  """Inference BatchNorm over channels of [b, c, t]: running statistics
  only, as flax's BatchNorm(use_running_average=True) computes it."""

  def __init__(self, channels: int, epsilon: float = _BN_EPSILON):
    super().__init__()
    self.epsilon = epsilon
    self.scale = nn.Parameter(torch.ones(channels))
    self.bias = nn.Parameter(torch.zeros(channels))
    self.register_buffer('mean', torch.zeros(channels))
    self.register_buffer('var', torch.ones(channels))

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    mul = self.scale * torch.rsqrt(self.var + self.epsilon)
    return (x - self.mean[:, None]) * mul[:, None] + self.bias[:, None]


class CrepeModel(nn.Module):
  """The CREPE network: 1024 audio samples -> 360 pitch-bin activations.

  Layers carry the keras names (conv1..conv6, conv{i}_BN, classifier), so
  the JAX package's variables and the keras .h5 map onto them.
  `activation_layer` ('conv{i}-BN' or 'conv{i}-maxpool') returns that
  intermediate activation, flattened time-major with the channel fastest as
  the JAX package's NHWC layout flattens it, instead of the classifier's.
  """

  def __init__(self, model_capacity: str = 'tiny',
               activation_layer: Optional[str] = None):
    super().__init__()
    self.model_capacity = model_capacity
    self.activation_layer = activation_layer
    capacity = _CAPACITIES[model_capacity]
    in_channels = 1
    for i, (f, w, s) in enumerate(zip(_FILTERS, _WIDTHS, _STRIDES)):
      setattr(self, f'conv{i + 1}', nn.Conv1d(in_channels, f * capacity, w,
                                              stride=s))
      setattr(self, f'conv{i + 1}_BN', BatchNorm(f * capacity))
      in_channels = f * capacity
    n_features = in_channels * (CREPE_FRAME_SIZE // _STRIDES[0] // 2**6)
    self.classifier = nn.Linear(n_features, _N_BINS)

  @staticmethod
  def _flatten(x: torch.Tensor) -> torch.Tensor:
    """[b, c, t] -> [b, t * c], time-major (the NHWC flatten)."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)

  def forward(self, frames: torch.Tensor) -> torch.Tensor:
    """frames: [batch, 1024] normalized audio -> [batch, 360] (sigmoid)."""
    x = frames[:, None, :]
    for i, (w, s) in enumerate(zip(_WIDTHS, _STRIDES)):
      layer_n = i + 1
      x = F.pad(x, _same_padding(w, s, x.shape[-1]))
      x = torch.relu(getattr(self, f'conv{layer_n}')(x))
      x = getattr(self, f'conv{layer_n}_BN')(x)
      if self.activation_layer == f'conv{layer_n}-BN':
        return self._flatten(x)
      x = F.max_pool1d(x, 2, 2)
      if self.activation_layer == f'conv{layer_n}-maxpool':
        return self._flatten(x)
      # Dropout(0.25) in the original; inference only here.
    return torch.sigmoid(self.classifier(self._flatten(x)))


def load_variables(model: CrepeModel, variables: Dict[str, Any]) -> None:
  """Carry the flax variables {'params', 'batch_stats'} of the JAX
  CrepeModel (the output of its load_weights_from_h5, as numpy, or of
  load_weights) into `model` (strict).

  Kernels [w, 1, in, out] become Conv1d weights [out, in, w]; the dense
  kernel [in, out] a Linear weight [out, in].
  """
  params, stats = variables['params'], variables['batch_stats']
  state = {}
  for i in range(1, 7):
    kernel = np.asarray(params[f'conv{i}']['kernel'], np.float32)
    state[f'conv{i}.weight'] = kernel[:, 0].transpose(2, 1, 0)
    state[f'conv{i}.bias'] = params[f'conv{i}']['bias']
    bn = f'conv{i}_BN'
    state[f'{bn}.scale'] = params[bn]['scale']
    state[f'{bn}.bias'] = params[bn]['bias']
    state[f'{bn}.mean'] = stats[bn]['mean']
    state[f'{bn}.var'] = stats[bn]['var']
  state['classifier.weight'] = np.asarray(params['classifier']['kernel'],
                                          np.float32).T
  state['classifier.bias'] = params['classifier']['bias']
  model.load_state_dict({
      k: torch.from_numpy(np.array(v, np.float32, order='C'))
      for k, v in state.items()})


# The keras names of an .h5's weights, keyed as the .npz stores them
# ('<flax collection>/<flax module>/<flax name>').
def _h5_names() -> Dict[str, Tuple[str, str]]:
  names = {}
  for i in range(1, 7):
    conv, bn = f'conv{i}', f'conv{i}-BN'
    names[f'params/{conv}/kernel'] = (conv, 'kernel:0')
    names[f'params/{conv}/bias'] = (conv, 'bias:0')
    names[f'params/{conv}_BN/scale'] = (bn, 'gamma:0')
    names[f'params/{conv}_BN/bias'] = (bn, 'beta:0')
    names[f'batch_stats/{conv}_BN/mean'] = (bn, 'moving_mean:0')
    names[f'batch_stats/{conv}_BN/var'] = (bn, 'moving_variance:0')
  names['params/classifier/kernel'] = ('classifier', 'kernel:0')
  names['params/classifier/bias'] = ('classifier', 'bias:0')
  return names


def read_h5(path: str) -> Dict[str, np.ndarray]:
  """The weights of a crepe model-<size>.h5 as flat {'params/conv1/kernel':
  array} arrays (h5py is imported here only)."""
  import h5py  # pylint: disable=g-import-not-at-top
  out = {}
  with h5py.File(path, 'r') as f:
    weights = f['model_weights'] if 'model_weights' in f else f
    for key, (group, name) in _h5_names().items():
      out[key] = np.asarray(weights[group][group][name])
  return out


def convert_h5_to_npz(h5_path: str, npz_path: str) -> str:
  """Write the weights of a crepe .h5 to an .npz that numpy alone reads."""
  np.savez(npz_path, **read_h5(h5_path))
  return npz_path


def load_weights(path: str, model_capacity: str = 'tiny') -> Dict[str, Any]:
  """Read model-<size>.npz (numpy) or .h5 (h5py) into a flax-style
  variables dict {'params': ..., 'batch_stats': ...} of numpy arrays."""
  if path.endswith('.h5'):
    return load_weights_from_h5(path, model_capacity)
  with np.load(path) as data:
    return _variables({k: data[k] for k in data.files}, path, model_capacity)


def load_weights_from_h5(path: str,
                         model_capacity: str = 'tiny') -> Dict[str, Any]:
  """Read a crepe pip-package model-<size>.h5 (h5py) into a flax-style
  variables dict {'params': ..., 'batch_stats': ...} of numpy arrays."""
  return _variables(read_h5(path), path, model_capacity)


def _variables(flat: Dict[str, np.ndarray], path: str,
               model_capacity: str) -> Dict[str, Any]:
  """Flat 'collection/module/name' arrays as a variables dict, checked
  against the capacity's conv1 width."""
  variables = {'params': {}, 'batch_stats': {}}
  for key, value in flat.items():
    collection, module, name = key.split('/')
    variables[collection].setdefault(module, {})[name] = value
  expected = _FILTERS[0] * _CAPACITIES[model_capacity]
  got = variables['params']['conv1']['kernel'].shape[-1]
  if got != expected:
    raise ValueError(
        f'Weights file {path!r} has {got} conv1 filters but capacity '
        f'{model_capacity!r} expects {expected}.')
  return variables


def activations_to_f0_and_confidence(
    activations: torch.Tensor, centers: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
  """[batch, 360] activations -> (f0_hz [batch], confidence [batch, 1]).

  The weighted average of cents over 10 bins around the argmax (or the
  given centers).
  """
  (cent_mapping,) = _decoding_constants(activations.device, 'cents')
  confidence = torch.amax(activations, dim=-1, keepdim=True)
  if centers is None:
    centers = torch.argmax(activations, dim=-1)
  idx = (centers.long() - 4)[:, None] + torch.arange(
      10, device=activations.device)
  idx = torch.clamp(idx, 0, _N_BINS - 1)
  weights = torch.gather(activations, -1, idx)
  cents = cent_mapping[idx]
  f0_cent = torch.sum(weights * cents, dim=-1) / torch.sum(weights, dim=-1)
  f0_hz = 10 * 2**(f0_cent / 1200.0)
  return f0_hz, confidence


def _viterbi_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """(log_initial [360], log_transition [360, 360], log_emission [obs,
  state]) of CREPE's decoder, float32."""
  bins = np.arange(_N_BINS, dtype=np.float32)
  xx, yy = np.meshgrid(bins, bins)
  transition = np.maximum(12 - np.abs(xx - yy), 1e-5)
  transition = transition / transition.sum(axis=1, keepdims=True)
  log_transition = np.log(transition.astype(np.float32))
  log_initial = np.full((_N_BINS,), -np.log(_N_BINS), dtype=np.float32)
  # Emission with a fixed self-emission mass; for an activation vector
  # observed as a Multinomial(total_count=1), the observation
  # log-likelihood is sum_j act_j * log(emission[s, j]).
  self_emission = 0.1
  emission = (np.eye(_N_BINS) * self_emission +
              np.ones((_N_BINS, _N_BINS)) * ((1 - self_emission) / _N_BINS))
  log_emission = np.log(emission.T).astype(np.float32)
  return log_initial, log_transition, log_emission


# {(name, device): a decoding constant there}. Filled only outside a
# trace: a tensor made while torch.export or torch.compile traces is fake,
# and a later call or trace would find it here.
_DECODING_CONSTANTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _decoding_constants(device: torch.device,
                        *names: str) -> List[torch.Tensor]:
  """The named constants on `device` ('cents' of the bins, the Viterbi
  tables 'log_initial', 'log_transition', 'log_emission'), each copied
  there once (a copy from pageable host memory per call would wait for the
  stream); inside a trace they are made anew, and only the ones the traced
  code reads become the program's constants."""
  device = torch.device(device)
  out = [_DECODING_CONSTANTS.get((name, device)) for name in names]
  if any(t is None for t in out):
    host = dict(zip(('log_initial', 'log_transition', 'log_emission'),
                    _viterbi_tables()), cents=_CENT_MAPPING)
    for i, name in enumerate(names):
      if out[i] is None:
        out[i] = torch.as_tensor(np.ascontiguousarray(host[name]),
                                 device=device)
        if not torch.compiler.is_compiling():
          _DECODING_CONSTANTS[(name, device)] = out[i]
  return out


def crepe_viterbi_centers(activations: torch.Tensor) -> torch.Tensor:
  """Viterbi-smoothed pitch bin centers, [batch, time, 360] -> [batch, time].

  CREPE's decoder: a uniform initial state, a triangular transition kernel
  that favours small jumps, and an emission that boosts the self bin.
  """
  log_initial, log_transition, log_emission = _decoding_constants(
      activations.device, 'log_initial', 'log_transition', 'log_emission')
  with full_float32():
    obs_ll = torch.einsum('bto,os->bts', activations, log_emission)
  return hmm_ops.viterbi_decode(log_initial, log_transition, obs_ll)


class PretrainedCrepe:
  """Batch pitch prediction on the device with CREPE: frame, normalize, run
  the network, decode f0 and confidence (optionally with Viterbi).

  Args:
    model_capacity: One of 'tiny', 'small', 'medium', 'large', 'full'.
    weights_path: model-<size>.npz or .h5; None looks in
      $CREPE_WEIGHTS_DIR, then assets/crepe. Without weights the network
      keeps torch's random init (plumbing only) and a warning says so.
    hop_size: Samples between frames (160 = 100 Hz at 16 kHz).
    device: Where the network runs (CUDA unless the caller says otherwise;
      raises without a GPU). `to(device)` moves it.
  """

  def __init__(self, model_capacity: str = 'tiny',
               weights_path: Optional[str] = None, hop_size: int = 160,
               device: DeviceLike = None):
    self.model_capacity = model_capacity
    self.hop_size = hop_size
    self.frame_size = CREPE_FRAME_SIZE
    self.sample_rate = CREPE_SAMPLE_RATE
    self.model = CrepeModel(model_capacity=model_capacity)
    if weights_path is None:
      weights_path = default_weights_path(model_capacity)
    self.pretrained = weights_path is not None
    if self.pretrained:
      load_variables(self.model, load_weights(weights_path, model_capacity))
    else:
      logging.getLogger('ddsp_torch').warning(
          'PretrainedCrepe(%s): no weights found (weights_path not given, '
          'no model-%s.npz or .h5 in $CREPE_WEIGHTS_DIR or assets/crepe). '
          'Running with RANDOM weights: pitch predictions are garbage.',
          model_capacity, model_capacity)
    self.model.requires_grad_(False).eval()
    self.to(resolve_device(device))

  def to(self, device) -> 'PretrainedCrepe':
    self.model.to(device)
    # Where the weights landed ('cuda:0' for 'cuda'), so that a caller
    # comparing it with its audio's device moves nothing when they agree.
    self.device = next(self.model.parameters()).device
    return self

  def batch_frames(self, audio: torch.Tensor,
                   hop_size: Optional[int] = None) -> torch.Tensor:
    """Chop [batch, n] audio into frames pushed onto the batch axis."""
    if audio.shape[-1] == self.frame_size:
      return audio
    frames = audio.unfold(-1, self.frame_size, hop_size or self.hop_size)
    return frames.reshape(-1, self.frame_size)

  @staticmethod
  def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(frames, dim=-1, keepdim=True)
    var = torch.var(frames, dim=-1, keepdim=True, correction=0)
    std = torch.where(torch.abs(var) > 0, torch.sqrt(var),
                      torch.full_like(var, 1e-8))
    return (frames - mu) / std

  @torch.no_grad()
  def activations(self, audio: torch.Tensor,
                  hop_size: Optional[int] = None) -> torch.Tensor:
    """[batch, n] audio -> [batch, n_frames, 360] activations."""
    audio = audio.to(self.device, torch.float32)
    frames = self.normalize_frames(self.batch_frames(audio, hop_size))
    with full_float32():
      acts = self.model(frames)
    return acts.reshape(audio.shape[0], -1, _N_BINS)

  @torch.no_grad()
  def predict_f0_and_confidence(self, audio: torch.Tensor,
                                viterbi: bool = False,
                                padding: str = 'center',
                                hop_size: Optional[int] = None):
    """[batch, n] (or [n]) audio -> (f0_hz, confidence), [batch, n_frames],
    on the network's device; `hop_size` overrides the instance's."""
    from ddsp_torch.ops.spectral import pad  # pylint: disable=g-import-not-at-top
    audio = torch.as_tensor(audio, device=self.device)
    audio = audio[None, :] if audio.ndim == 1 else audio
    batch_size = audio.shape[0]
    hop_size = hop_size or self.hop_size
    audio = pad(audio, self.frame_size, hop_size, padding=padding)
    acts = self.activations(audio, hop_size)
    centers = None
    if viterbi:
      centers = crepe_viterbi_centers(acts).reshape(-1)
    f0_hz, confidence = activations_to_f0_and_confidence(
        acts.reshape(-1, _N_BINS), centers)
    return (f0_hz.reshape(batch_size, -1),
            confidence.reshape(batch_size, -1))
