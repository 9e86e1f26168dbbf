"""The port's long-audio training step and FIRFilter's time-sharded branch
against the JAX package, on the CPU.

1. `make_sp_train_step` at the JAX test's shapes
   (tests/test_time_shard.py, test_sp_train_step_runs_and_learns): an
   FcStackDecoder of width 16, 8192 samples, FFT sizes (512, 64), a
   (2 data x 4 time) mesh on both sides, the JAX parameters carried over by
   load_jax_params, optax.adam(1e-2) beside torch.optim.Adam(lr=1e-2) (the
   same update: bias-corrected, eps outside the root). Three steps' losses
   within STEP_RTOL, and the loss falls.
2. FIRFilter's branch of `_sp_get_signal` against the JAX one and against
   the port's dense FIRFilter, alone and inside a ProcessorGroup run by
   `sp_run_dag`.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from ddsp_tpu import nn as j_nn
from ddsp_tpu import proc as j_proc
from ddsp_tpu.parallel import create_mesh as j_create_mesh
from ddsp_tpu.parallel import make_sp_train_step as j_make_sp_train_step
from ddsp_tpu.parallel import sp_model as j_sp_model
from ddsp_torch import nn as t_nn
from ddsp_torch import proc as t_proc
from ddsp_torch.parallel import create_mesh, make_sp_train_step
from ddsp_torch.parallel import sp_model as t_sp_model
from ddsp_torch.utils import load_jax_params

torch.set_num_threads(1)

N_DATA, N_TIME = 2, 4
N_FRAMES, HOP = 16, 512
N_SAMPLES = N_FRAMES * HOP  # 8192: 2048 samples a time shard
FFT_SIZES = (512, 64)
STEPS = 3
# The losses of the JAX step and the port's from the same parameters,
# batch and noise: two float32 forwards (the frameworks' phase cumsums
# differ by ~1e-4 rad over 8192 samples) and the logmag term's 1/|X| on
# quiet bins; the tolerance of test_sp_synth_and_loss_matches_jax
# (tests/test_torch_time_shard.py).
STEP_RTOL = 2e-3
# FIRFilter: float32 FFT convolutions of the same frames, per shard with
# halos (SP) or whole (dense), in two frameworks: rounding only.
FIR_ATOL = 1e-6


def _batch():
  """The JAX test's batch and noise (a 220 Hz tone with a noise floor)."""
  rng = np.random.RandomState(0)
  t = np.arange(N_SAMPLES) / 16000
  target = (0.3 * np.sin(2 * np.pi * 220 * t) +
            3e-3 * rng.randn(N_SAMPLES)).astype(np.float32)
  batch = {
      'audio': np.stack([target] * N_DATA),
      'f0_hz': np.full((N_DATA, N_FRAMES, 1), 220.0, np.float32),
      'ld_scaled': np.full((N_DATA, N_FRAMES, 1), 0.6, np.float32),
      'f0_scaled': np.full((N_DATA, N_FRAMES, 1), 0.55, np.float32),
  }
  noise = rng.uniform(-1, 1, (N_DATA, N_SAMPLES)).astype(np.float32)
  return batch, noise


OUTPUT_SPLITS = (('amps', 1), ('harmonic_distribution', 8),
                 ('noise_magnitudes', 5))


@pytest.fixture(scope='module')
def jax_steps():
  """The JAX decoder's initial parameters (numpy) and its step's losses."""
  batch, noise = _batch()
  decoder = j_nn.FcStackDecoder(
      ch=16, layers_per_stack=1, input_keys=('ld_scaled', 'f0_scaled'),
      output_splits=OUTPUT_SPLITS)
  params = jax.jit(decoder.init)(jax.random.PRNGKey(0), batch)['params']
  initial = jax.tree_util.tree_map(np.array, params)
  optimizer = optax.adam(1e-2)
  opt_state = optimizer.init(params)
  mesh = j_create_mesh(n_data=N_DATA, n_time=N_TIME,
                       devices=jax.devices()[:N_DATA * N_TIME])
  train_step, shard_batch = j_make_sp_train_step(
      mesh, decoder, optimizer, n_samples=N_SAMPLES, fft_sizes=FFT_SIZES)
  sharded, noise_dev = shard_batch(batch, noise)
  losses = []
  for _ in range(STEPS):
    params, opt_state, loss = train_step(params, opt_state, sharded,
                                         noise_dev)
    losses.append(float(loss))
  return initial, losses


def _port_step(params, mesh):
  decoder = t_nn.FcStackDecoder(
      ch=16, layers_per_stack=1, input_keys=('ld_scaled', 'f0_scaled'),
      output_splits=OUTPUT_SPLITS)
  load_jax_params(decoder, params)
  optimizer = torch.optim.Adam(decoder.parameters(), lr=1e-2)
  train_step, shard_batch = make_sp_train_step(
      mesh, decoder, optimizer, n_samples=N_SAMPLES, fft_sizes=FFT_SIZES)
  return decoder, train_step, shard_batch


def test_sp_train_step_matches_the_jax_step(jax_steps):
  params, want = jax_steps
  batch, noise = _batch()
  _, train_step, shard_batch = _port_step(
      params, create_mesh(N_DATA, N_TIME, devices=['cpu'] * 8))
  sharded, noise_t = shard_batch(batch, noise)
  assert noise_t.dtype == torch.float32
  assert all(v.dtype == torch.float32 for v in sharded.values())
  got = []
  for _ in range(STEPS):
    loss = train_step(sharded, noise_t)
    assert loss.shape == () and not loss.requires_grad
    got.append(float(loss))
  np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
  assert got[-1] < got[0], got


def test_sp_train_step_on_a_trivial_mesh_is_the_dense_loss(jax_steps):
  """On a (1, 1) mesh the step's loss is sp_synth_and_loss on one shard,
  which the dense pipeline computes in the same order."""
  from ddsp_torch import losses as t_losses
  from ddsp_torch.ops import core, fftconv, oscillator
  params, _ = jax_steps
  batch, noise = _batch()
  decoder, train_step, shard_batch = _port_step(
      params, create_mesh(1, 1, devices=['cpu']))
  sharded, noise_t = shard_batch(batch, noise)
  with torch.no_grad():
    controls = decoder(sharded)
    harm = oscillator.harmonic_synthesis(
        sharded['f0_hz'], core.exp_sigmoid(controls['amps']),
        harmonic_distribution=core.exp_sigmoid(
            controls['harmonic_distribution']), n_samples=N_SAMPLES)
    ir = fftconv.frequency_impulse_response(
        core.exp_sigmoid(controls['noise_magnitudes'] - 5.0))
    audio = harm + fftconv.fft_convolve(noise_t, ir)
    want = t_losses.SpectralLoss(fft_sizes=FFT_SIZES, mag_weight=1.0,
                                 logmag_weight=1.0)(sharded['audio'], audio)
  got = train_step(sharded, noise_t)
  np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_sp_train_step_refuses_a_decoder_off_the_mesh():
  decoder = t_nn.FcStackDecoder(ch=8, layers_per_stack=1,
                                output_splits=OUTPUT_SPLITS)
  optimizer = torch.optim.Adam(decoder.parameters())
  mesh = create_mesh(1, 2, devices=['cpu'] * 2)
  # A mesh object whose first device is not where the decoder lies.
  mesh.devices = (torch.device('meta'),) * 2
  with pytest.raises(ValueError, match='lies on cpu'):
    make_sp_train_step(mesh, decoder, optimizer, n_samples=N_SAMPLES)


# ---------------------------------------------------------------------------
# FIRFilter's time-sharded branch
# ---------------------------------------------------------------------------
FIR_SAMPLES, FIR_FRAMES, FIR_BANDS = 16384, 128, 129


def _fir_inputs(seed=4):
  rng = np.random.RandomState(seed)
  audio = (0.3 * rng.randn(2, FIR_SAMPLES)).astype(np.float32)
  raw = rng.randn(2, FIR_FRAMES, FIR_BANDS).astype(np.float32)
  return audio, raw


@pytest.mark.parametrize('window_size', [257, 65])
def test_fir_filter_branch_matches_jax_and_the_dense_filter(window_size):
  audio, raw = _fir_inputs()
  j_fir = j_proc.FIRFilter(window_size=window_size)
  controls = j_fir.apply({}, audio, raw, method=j_fir.get_controls)
  jmesh = j_create_mesh(n_data=1, n_time=4, devices=jax.devices()[:4])
  want = np.asarray(jax.jit(lambda c: j_sp_model._sp_get_signal(  # pylint: disable=protected-access
      j_fir, c, jmesh, 'pallas'))(controls))

  fir = t_proc.FIRFilter(window_size=window_size)
  t_controls = fir.get_controls(torch.from_numpy(audio),
                                torch.from_numpy(raw))
  np.testing.assert_allclose(t_controls['magnitudes'].numpy(),
                             np.asarray(controls['magnitudes']), rtol=1e-6)
  mesh = create_mesh(1, 4, devices=['cpu'] * 4)
  got = t_sp_model._sp_get_signal(fir, t_controls, mesh, 'pallas')  # pylint: disable=protected-access
  dense = fir.get_signal(**t_controls)
  assert got.shape == (2, FIR_SAMPLES)
  np.testing.assert_allclose(got.numpy(), want, atol=FIR_ATOL)
  np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=FIR_ATOL)


def test_fir_filter_in_a_processor_group_on_the_sharded_path(monkeypatch):
  """A ProcessorGroup with FIRFilter through sp_run_dag on (1 x 4) and
  (2 x 2) meshes: the node takes the time-sharded convolution, and its
  signal, the group's output and the gradient with respect to the
  magnitudes agree with the dense group's."""
  convolve = t_sp_model.time_shard.time_sharded_fft_convolve
  calls = []

  def counting(*args, **kwargs):
    calls.append(kwargs.get('halo_impl'))
    return convolve(*args, **kwargs)

  monkeypatch.setattr(t_sp_model.time_shard, 'time_sharded_fft_convolve',
                      counting)
  audio, raw = _fir_inputs(seed=5)
  pg = t_proc.ProcessorGroup(dag=[
      (t_proc.FIRFilter(name='fir'), ['audio', 'magnitudes']),
      (t_proc.Add(name='add'), ['fir/signal', 'audio']),
  ])
  dense_raw = torch.from_numpy(raw).requires_grad_()
  inputs = {'audio': torch.from_numpy(audio), 'magnitudes': dense_raw}
  dense = pg(inputs, return_outputs_dict=True)
  (g_dense,) = torch.autograd.grad(dense['signal'].square().sum(),
                                   [dense_raw])
  for shape in ((1, 4), (2, 2)):
    sp_raw = torch.from_numpy(raw).requires_grad_()
    out = t_sp_model.sp_run_dag(
        pg, {'audio': torch.from_numpy(audio), 'magnitudes': sp_raw},
        create_mesh(*shape, devices=['cpu'] * 4), halo_impl='pallas')
    np.testing.assert_allclose(
        out['fir']['signal'].detach().numpy(),
        dense['controls']['fir']['signal'].detach().numpy(), atol=FIR_ATOL)
    np.testing.assert_allclose(out['out']['signal'].detach().numpy(),
                               dense['signal'].detach().numpy(),
                               atol=FIR_ATOL)
    (g_sp,) = torch.autograd.grad(out['out']['signal'].square().sum(),
                                  [sp_raw])
    assert calls == ['pallas']
    calls.clear()
    np.testing.assert_allclose(g_sp.numpy(), g_dense.numpy(),
                               rtol=1e-4, atol=1e-4 * float(
                                   g_dense.abs().max()))
