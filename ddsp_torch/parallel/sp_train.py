"""Sequence-parallel training on audio longer than one shard holds.

Port of ddsp_tpu/parallel/sp_train.py. `sp_synth_and_loss` runs harmonic
synthesis (phase-carry exchange), filtered noise (overlap-add halo
exchange) and the multi-scale spectral loss (STFT halos and sums) from raw
decoder outputs, with every [batch, n_samples] intermediate time-sharded.
`make_sp_train_step` wraps it into a training step around a decoder and a
torch.optim optimizer: the long-audio step of the JAX package (a decoder
on frame-rate features, no preprocessor, no reverb), beside the full-model
sequence-parallel step of `train.Trainer(mesh=...)`.

On a mesh over ranks each rank runs the decoder on its data row's
features and synthesizes its own shards; its loss is the global loss (the
sums run over every rank), so the gradients are summed over the ranks
before `optimizer.step()`, and every rank takes the same step.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import fftconv as fftconv_ops
from ddsp_torch.parallel import distributed, time_shard
from ddsp_torch.parallel import mesh as mesh_lib
from ddsp_torch.parallel.mesh import Mesh


def sp_synth_and_loss(mesh: Mesh, target_audio: torch.Tensor,
                      f0_hz: torch.Tensor, amps_raw: torch.Tensor,
                      hd_raw: torch.Tensor, noise_raw: torch.Tensor,
                      noise_ir: torch.Tensor, n_samples: int,
                      sample_rate: int = 16000,
                      fft_sizes=(2048, 1024, 512, 256, 128, 64),
                      mag_weight: float = 1.0,
                      logmag_weight: float = 1.0) -> torch.Tensor:
  """Time-sharded synthesis, filtering and spectral loss.

  Args:
    mesh: Mesh with a 'time' axis (and optionally 'data').
    target_audio: [batch, n_samples].
    f0_hz: [batch, n_frames, 1] frame-rate fundamental.
    amps_raw / hd_raw: Raw decoder outputs (exp_sigmoid applied here),
      [batch, n_frames, 1] / [batch, n_frames, n_harmonics].
    noise_raw: Raw filtered-noise magnitudes, [batch, n_frames, n_mags];
      turned into a frequency-sampled FIR applied to `noise_ir`.
    noise_ir: White noise [batch, n_samples], drawn by the caller.
    n_samples: Global audio length.
    sample_rate: Hz.
    fft_sizes / mag_weight / logmag_weight: Spectral loss config.

  Returns:
    The scalar loss.
  """
  amps = ops_core.exp_sigmoid(amps_raw)
  hd = ops_core.exp_sigmoid(hd_raw)
  harm = time_shard.time_sharded_harmonic_synthesis(
      mesh, f0_hz, amps, hd, n_samples=n_samples, sample_rate=sample_rate)
  mags = ops_core.exp_sigmoid(noise_raw - 5.0)
  ir = fftconv_ops.frequency_impulse_response(mags, window_size=0)
  noise = time_shard.time_sharded_fft_convolve(mesh, noise_ir, ir)
  return time_shard.time_sharded_spectral_loss(
      mesh, target_audio, harm + noise, fft_sizes=fft_sizes,
      mag_weight=mag_weight, logmag_weight=logmag_weight)


def make_sp_train_step(mesh: Mesh, decoder: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, n_samples: int,
                       sample_rate: int = 16000,
                       fft_sizes=(2048, 1024, 512, 256, 128, 64)
                       ) -> Tuple[Callable[..., torch.Tensor], Callable]:
  """A sequence-parallel training step.

  The decoder (a DictModule such as RnnFcDecoder or FcStackDecoder,
  emitting 'amps', 'harmonic_distribution' and 'noise_magnitudes') runs on
  the frame-rate features on the mesh's first device; everything
  audio-rate stays time-sharded (`sp_synth_and_loss`).

  Args:
    mesh: Mesh(('data', 'time')).
    decoder: Control network; its parameters lie on the mesh's first
      device.
    optimizer: A torch.optim optimizer over the decoder's parameters
      (torch.optim.Adam makes optax.adam's update).
    n_samples: Global audio length per example.
    sample_rate: Hz.
    fft_sizes: Spectral loss sizes.

  Returns:
    (train_step, shard_batch): train_step(batch, noise) runs the forward,
    the backward and optimizer.step(), updating the parameters in place,
    and returns the loss (a scalar tensor on the device); shard_batch(batch,
    noise) returns the host arrays as float32 tensors on the mesh's first
    device, where the time-sharded functions split them over the mesh.
    Across ranks shard_batch takes the global batch and noise and keeps the
    rank's rows and, of [batch, n_samples] leaves, its samples; the
    decoder's parameters are rank 0's from the start.
  """
  device = mesh.first_device
  for name, p in decoder.named_parameters():
    if p.device != device:
      raise ValueError(f'The decoder parameter {name} lies on {p.device}, '
                       f'the mesh on {device}; move the decoder there '
                       'before making its optimizer.')
  mesh_lib.replicate(mesh, list(decoder.parameters()))

  def train_step(batch: Dict[str, torch.Tensor],
                 noise: torch.Tensor) -> torch.Tensor:
    optimizer.zero_grad(set_to_none=True)
    controls = decoder(batch, training=True)
    loss = sp_synth_and_loss(
        mesh, batch['audio'], batch['f0_hz'], controls['amps'],
        controls['harmonic_distribution'], controls['noise_magnitudes'],
        noise, n_samples=n_samples, sample_rate=sample_rate,
        fft_sizes=fft_sizes)
    loss.backward()
    if mesh.ranks is not None:
      distributed.all_reduce_([p.grad for p in decoder.parameters()
                               if p.grad is not None])
    optimizer.step()
    return loss.detach()

  def to_device(v: Any) -> torch.Tensor:
    if not isinstance(v, torch.Tensor):
      v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device, torch.float32)

  def shard_batch(batch: Dict[str, Any], noise: Any):
    batch = mesh_lib.shard_batch(mesh, batch, n_samples)
    noise = mesh_lib.shard_batch(mesh, {'noise': noise}, n_samples)['noise']
    return {k: to_device(v) for k, v in batch.items()}, to_device(noise)

  return train_step, shard_batch
