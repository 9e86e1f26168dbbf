"""The time-sharded kernels of ddsp_torch against ddsp_tpu, on the CPU.

Each `time_sharded_*` wrapper of the port, on a mesh of CPU devices,
against its JAX counterpart with halo_impl='pallas' on the same mesh shape
of simulated CPU devices, for values and gradients, with the same numpy
inputs. The port's halo shifts take K3's plain version here.

Tolerances, each no looser than the JAX package's own test of the same
function in tests/test_time_shard.py:
  * harmonic synthesis: atol 3e-3 (values), atol 1e-4 + rtol 1e-3
    (gradients): the two frameworks' float32 cumsums differ by ~5e-4 rad
    over 16000 samples and harmonic h multiplies that;
  * fft_convolve: atol 2e-5 (values), relative to the largest element 1e-5
    (gradients): the same FFT sizes in two FFT libraries;
  * the spectral loss: rtol 2e-5 (two terms), 2e-4 (all six), gradients
    relative to their largest element 1e-4.
The JAX side runs under jax.jit: eager shard_map takes tens of seconds per
call here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.parallel import create_mesh as j_create_mesh
from ddsp_tpu.parallel import sp_synth_and_loss as j_sp_synth_and_loss
from ddsp_tpu.parallel import time_shard as j_ts
from ddsp_torch.parallel import create_mesh, sp_synth_and_loss, time_shard

torch.set_num_threads(1)

MESHES = [(1, 4), (2, 2)]


def _meshes(n_data, n_time):
  n = n_data * n_time
  return (j_create_mesh(n_data=n_data, n_time=n_time,
                        devices=jax.devices()[:n]),
          create_mesh(n_data, n_time, devices=['cpu'] * n))


def _t(x, grad=False):
  return torch.from_numpy(np.asarray(x)).requires_grad_(grad)


def _harmonic_inputs(n_frames, seed=1):
  rng = np.random.RandomState(seed)
  f0 = (110.0 + 60.0 * rng.rand(2, n_frames, 1)).astype(np.float32)
  amps = rng.rand(2, n_frames, 1).astype(np.float32)
  hd = rng.rand(2, n_frames, 8).astype(np.float32)
  return f0, amps, hd / hd.sum(-1, keepdims=True)


# hop 160 divides t_local (4000 and 8000); hop 128 divides neither.
@pytest.mark.parametrize('n_frames', [100, 125], ids=['aligned', 'gather'])
@pytest.mark.parametrize('mesh_shape', MESHES, ids=str)
def test_harmonic_synthesis_matches_jax(mesh_shape, n_frames):
  f0, amps, hd = _harmonic_inputs(n_frames)
  jmesh, mesh = _meshes(*mesh_shape)
  want = np.asarray(jax.jit(
      lambda *a: j_ts.time_sharded_harmonic_synthesis(
          jmesh, *a, n_samples=16000))(f0, amps, hd))
  got = time_shard.time_sharded_harmonic_synthesis(
      mesh, _t(f0), _t(amps), _t(hd), n_samples=16000)
  assert got.shape == (2, 16000)
  np.testing.assert_allclose(got.numpy(), want, atol=3e-3)


@pytest.mark.parametrize('mesh_shape', MESHES, ids=str)
def test_harmonic_synthesis_gradients_match_jax(mesh_shape):
  f0, amps, hd = _harmonic_inputs(100, seed=2)
  jmesh, mesh = _meshes(*mesh_shape)
  want = jax.jit(jax.grad(
      lambda a, h: jnp.mean(j_ts.time_sharded_harmonic_synthesis(
          jmesh, f0, a, h, n_samples=16000)**2), argnums=(0, 1)))(amps, hd)
  leaves = [_t(amps, True), _t(hd, True)]
  audio = time_shard.time_sharded_harmonic_synthesis(
      mesh, _t(f0), *leaves, n_samples=16000)
  got = torch.autograd.grad(torch.mean(audio**2), leaves)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                               rtol=1e-3)


CONV_CASES = {
    'ltv_small_ir': (16, 64, -1),
    'delay_spans_shards': (1, 12000, -1),  # delay 5998 > t_local 4096
    'reverb_delay_0': (1, 3000, 0),
}


def _conv_inputs(case, seed=3):
  n_ir_frames, ir_size, _ = CONV_CASES[case]
  rng = np.random.RandomState(seed)
  audio = rng.randn(2, 16384).astype(np.float32)
  ir = (rng.randn(2, n_ir_frames, ir_size) *
        np.exp(-np.arange(ir_size) / (0.2 * ir_size)) * 0.3).astype(
            np.float32)
  return audio, ir


@pytest.mark.parametrize('case', sorted(CONV_CASES))
@pytest.mark.parametrize('mesh_shape', MESHES, ids=str)
def test_fft_convolve_matches_jax(mesh_shape, case):
  audio, ir = _conv_inputs(case)
  delay = CONV_CASES[case][2]
  jmesh, mesh = _meshes(*mesh_shape)
  want = np.asarray(jax.jit(lambda a, h: j_ts.time_sharded_fft_convolve(
      jmesh, a, h, delay_compensation=delay, halo_impl='pallas'))(audio, ir))
  got = time_shard.time_sharded_fft_convolve(
      mesh, _t(audio), _t(ir), delay_compensation=delay, halo_impl='pallas')
  np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize('case', ['ltv_small_ir', 'delay_spans_shards'])
def test_fft_convolve_gradients_match_jax(case):
  audio, ir = _conv_inputs(case, seed=4)
  jmesh, mesh = _meshes(1, 4)
  want = jax.jit(jax.grad(lambda a, h: jnp.mean(
      j_ts.time_sharded_fft_convolve(jmesh, a, h, halo_impl='pallas')**2),
                          argnums=(0, 1)))(audio, ir)
  leaves = [_t(audio, True), _t(ir, True)]
  out = time_shard.time_sharded_fft_convolve(mesh, *leaves,
                                             halo_impl='pallas')
  got = torch.autograd.grad(torch.mean(out**2), leaves)
  for g, w in zip(got, want):
    w = np.asarray(w)
    scale = np.abs(w).max()
    np.testing.assert_allclose(g.numpy() / scale, w / scale, atol=1e-5)


def _loss_inputs(seed):
  rng = np.random.RandomState(seed)
  target = (0.1 * rng.randn(2, 16384)).astype(np.float32)
  audio = (0.7 * target +
           0.02 * rng.randn(2, 16384)).astype(np.float32)
  return target, audio


SIX_TERMS = dict(mag_weight=1.0, delta_time_weight=0.5, delta_freq_weight=0.4,
                 cumsum_freq_weight=0.3, logmag_weight=1.0,
                 loudness_weight=0.2)
LOSS_CASES = {
    'mag_logmag': (dict(fft_sizes=(256, 64), mag_weight=1.0,
                        logmag_weight=1.0), 2e-5),
    'six_terms_six_sizes': (dict(fft_sizes=(2048, 1024, 512, 256, 128, 64),
                                 **SIX_TERMS), 2e-4),
}


@pytest.mark.parametrize('case', sorted(LOSS_CASES))
@pytest.mark.parametrize('mesh_shape', MESHES, ids=str)
def test_spectral_loss_matches_jax(mesh_shape, case):
  kwargs, rtol = LOSS_CASES[case]
  target, audio = _loss_inputs(5)
  jmesh, mesh = _meshes(*mesh_shape)
  want = float(jax.jit(lambda t, a: j_ts.time_sharded_spectral_loss(
      jmesh, t, a, halo_impl='pallas', **kwargs))(target, audio))
  got = float(time_shard.time_sharded_spectral_loss(
      mesh, _t(target), _t(audio), halo_impl='pallas', **kwargs))
  np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize('mesh_shape', MESHES, ids=str)
def test_spectral_loss_gradients_match_jax(mesh_shape):
  """All six terms at sizes (256, 64) plus the loudness term's 2048."""
  target, audio = _loss_inputs(6)
  kwargs = dict(fft_sizes=(256, 64), **SIX_TERMS)
  jmesh, mesh = _meshes(*mesh_shape)
  want = np.asarray(jax.jit(jax.grad(
      lambda a: j_ts.time_sharded_spectral_loss(
          jmesh, jnp.asarray(target), a, halo_impl='pallas', **kwargs)))(
              audio))
  leaf = _t(audio, True)
  (got,) = torch.autograd.grad(time_shard.time_sharded_spectral_loss(
      mesh, _t(target), leaf, halo_impl='pallas', **kwargs), leaf)
  scale = np.abs(want).max()
  np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=1e-4)


def test_sp_synth_and_loss_matches_jax():
  """The raw-decoder-output pipeline of sp_train (halo 'xla' on both
  sides), rtol 2e-3: the phase difference above, amplified by the logmag
  term in near-silent bins (the JAX package holds this pipeline to its
  dense version at 2e-2)."""
  rng = np.random.RandomState(3)
  n_frames, n_samples = 16, 8192
  args = [np.full((1, n_frames, 1), 330.0, np.float32),
          rng.randn(1, n_frames, 1).astype(np.float32),
          rng.randn(1, n_frames, 6).astype(np.float32),
          rng.randn(1, n_frames, 5).astype(np.float32),
          rng.uniform(-1, 1, (1, n_samples)).astype(np.float32)]
  target = (0.1 * rng.randn(1, n_samples)).astype(np.float32)
  jmesh, mesh = _meshes(1, 4)
  want = float(jax.jit(lambda *a: j_sp_synth_and_loss(
      jmesh, *a, n_samples=n_samples, fft_sizes=(512, 64)))(target, *args))
  got = float(sp_synth_and_loss(mesh, _t(target), *map(_t, args),
                                n_samples=n_samples, fft_sizes=(512, 64)))
  np.testing.assert_allclose(got, want, rtol=2e-3)
