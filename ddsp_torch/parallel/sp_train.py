"""Sequence-parallel synthesis and loss from raw decoder outputs.

Port of `sp_synth_and_loss` of ddsp_tpu/parallel/sp_train.py: harmonic
synthesis (phase-carry exchange), filtered noise (overlap-add halo
exchange) and the multi-scale spectral loss (STFT halos and sums), with
every [batch, n_samples] intermediate time-sharded. The JAX module's
`make_sp_train_step` makes a jitted step around an optax optimizer; the
port's sequence-parallel training goes through `train.Trainer(mesh=...)`,
and its own `make_sp_train_step` is listed in ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import torch

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import fftconv as fftconv_ops
from ddsp_torch.parallel import time_shard
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
