"""Training, eval and sample across processes: four gloo ranks on the CPU
against ddsp_tpu.

One module fixture starts four torch.distributed ranks once, with
torch.multiprocessing (spawn) and init_method='file://...', and runs every
case's port side in them while the parent computes the JAX package's on the
conftest's 8 simulated CPU devices. The ranks write their results to files;
the parametrised cases read them. Inputs are made from seeds with numpy, and
the parameters come from the JAX inits through load_jax_params.

  * K3's remote shift (kernels/halo.py, its plain version on the CPU: point-
    to-point sends) on (1 x 4) and (2 x 2) meshes of four ranks, both
    directions: the values and the adjoint against pallas_halo's
    neighbor_shift (interpret mode on a 'time' mesh, its ppermute fallback
    on two axes), exactly: a shift is a copy.
  * The dense Trainer step on a (4 x 1) mesh of ranks (one row each of a
    batch of 4) against ddsp_tpu.train.Trainer on a 4-device mesh: the
    first step's loss and all-reduced gradients, both steps' losses.
  * The Trainer's sequence-parallel step on a (2 x 2) mesh of ranks against
    the JAX Trainer's on a (2 x 2) mesh, and make_sp_train_step on a
    (1 x 4) mesh of ranks against the JAX long-audio step: likewise.
  * Parameters bit for bit equal across the ranks after two steps.
  * ddsp_torch.run.main(['--multihost', ...]) on two of the ranks (gloo, a
    (1 x 2) mesh): rank 0 writes, both end with the same parameters; then
    --mode eval and --mode sample of that run on the same two ranks.
  * evaluate_or_sample on (1 x 4) and (2 x 2) meshes of ranks against the
    JAX package's evaluate_or_sample on meshes of the same shapes (one
    numpy noise draw handed to both), and with its own noise against the
    port's one-process eval on the same (1 x 4), (2 x 2) and dense (4 x 1)
    meshes: the scalars on every rank, the gathered audio, rank 0 alone
    writing, and 'sample' writing the one-process files.
  * The nodes and losses that gather across ranks: a processor group
    ending in Crop, one with Mix (of two harmonic synths), and
    SpectralLoss(loss_type='L2'), each a Trainer step on (1 x 4) and
    (2 x 2) meshes of ranks against jax.value_and_grad of the JAX
    sp_forward_with_losses on a mesh of the same shape (the loss and every
    parameter's gradient).
  * Ranks holding whole data rows: the dense step on an (8 x 1) mesh of
    the four ranks, and the SP Trainer step on a (4 x 2) mesh of two ranks
    (the group the CLI case starts after the four-rank one ends), against
    the JAX package on the conftest's 8 simulated devices; the halo shifts
    stay in the process.
  * Ranks whose runs straddle a data row: a (3 x 2) mesh over the same two
    ranks, three shards a rank (rank 0 holds (0, 0), (0, 1), (1, 0), rank 1
    holds (1, 1), (2, 0), (2, 1)), against the JAX package on a (3 x 2)
    mesh of simulated devices: K3's shift both ways (values and adjoint,
    exactly), the Trainer's SP step and make_sp_train_step (the first
    step's loss and gradients, a batch of 3; parameters equal on both ranks
    after two steps) and evaluate_or_sample (scalars and audio, one numpy
    noise draw handed to both).

Everything is float32 (compute_dtype='float32'). Gradients are compared,
not parameters after Adam: Adam's first step is close to lr * sign(g),
which magnifies the differences of tiny gradients. This module imports JAX
only inside the fixture, so that the spawned ranks, which import it to find
their function, load PyTorch alone.
"""

import concurrent.futures
import json
import os
import socket
import tempfile
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

N_RANKS = 4
# The Trainer cases: tests/test_torch_sp.py's model (RnnFcDecoder of 16,
# Harmonic(8), FilteredNoise(9), a trainable Reverb of 3000 taps, the mag
# term) at 8192 samples, 4096 a time shard, and three FFT sizes, to keep
# the JAX package's compilations short.
N_SAMPLES, N_FRAMES = 8192, 64
FFT_SIZES = (1024, 256, 64)
# make_sp_train_step: tests/test_torch_sp_train_step.py's decoder and sizes.
SP_SAMPLES, SP_FRAMES, SP_FFT_SIZES = 8192, 16, (512, 64)
OUTPUT_SPLITS = (('amps', 1), ('harmonic_distribution', 8),
                 ('noise_magnitudes', 5))
STEPS = 2
RANKS_TIMEOUT_S = 300  # the ranks take ~15 s alone
# The JAX package's steps are traced one after another and compiled on
# this many threads (XLA compiles without the GIL).
JAX_COMPILE_THREADS = 3
SHIFT_MESHES = ((1, 4), (2, 2))
SHIFT_SHAPE = (4, 64)  # rows x samples of the global signal
# A mesh over the two-rank group whose runs straddle data row 1, one row of
# the batch a data row.
STRADDLE_MESH, STRADDLE_BATCH = (3, 2), 3
STRADDLE_SHIFT_SHAPE = (3, 64)
CASES = ('dense', 'sp_trainer', 'sp_step')
MESHES = {'dense': (4, 1), 'sp_trainer': (2, 2), 'sp_step': (1, 4)}
GLOBAL_BATCH = {'dense': 4, 'sp_trainer': 2, 'sp_step': 1}
# Losses against the JAX package: two float32 frameworks whose phase sums
# differ by ~1e-4 rad over 16384 samples, the sums of the loss and the
# gradient all-reduced in another order (tests/test_torch_sp.py holds the
# one-process SP step at this rtol; the second step also carries one Adam
# update of those gradients).
LOSS_RTOL = 1e-3
# make_sp_train_step on the straddled mesh's batch of 3 rows (220, 250 and
# 280 Hz): its logmag term reads the frameworks' phase rounding on quiet
# bins, and the port in one process departs from JAX as far as the ranks
# do (measured on an x86 CPU, port in one process against JAX: the loss
# 1.6e-3 on a (1 x 2) mesh of the one-row batch, 2.0e-3 on (3 x 1) and
# 2.4e-3 on (3 x 2); the network's gradient 1.7e-2, 3.1e-2 and 2.6e-2).
# The ranks are held to the one-process port at ONE_PROCESS_* below.
JAX_LOSS_RTOL = {'straddle_step': 5e-3}
# Gradients against the JAX package, relative L2: the network's, all
# parameters but the reverb IR together, at tests/test_torch_train.py's
# float32 tolerance for the Trainer cases (measured: 5.9e-5 dense, 1.0e-5
# sharded; whole rows 7.4e-5 dense, 5.5e-6 sharded; the gathering nodes and
# losses 2.9e-6 to 3.4e-5, where a backward that summed over a row's ranks
# where it must not would put them 1 to 3 apart). make_sp_train_step's loss has the logmag term (its
# logmag_weight is 1), whose 1/|X| weighs the frameworks' phase rounding
# on quiet bins, and its decoder's first layer sees one constant and one
# slow input, so the layer's gradient is a small residue of large
# per-shard terms: the port in one process departs from JAX by 9.9e-3 here
# (and a 2-shard mesh from a 4-shard one by 2.4e-2), the ranks by 1.0e-2.
# The reverb IR's, tests/test_torch_train.py's (its entries' gradients
# are sums of many signed terms): relative L2 0.1 and a cosine of 0.995.
NET_GRAD_RTOL = {'dense': 1e-3, 'sp_trainer': 1e-3, 'sp_step': 2e-2,
                 'rows_dense': 1e-3, 'rows_sp': 1e-3,
                 'straddle_sp': 1e-3, 'straddle_step': 5e-2}
IR_GRAD_RTOL = 0.1
IR_GRAD_COSINE = 0.995
IR_NAME = 'processor_group/reverb/ir'
# Against the same steps in one process: the same shards, the same
# arithmetic, the sums of the loss and of the gradient taken across
# processes in another order. First loss: measured 1e-7 apart; second
# loss, after one Adam step of those gradients: 1.5e-6. Gradients,
# relative L2 over all parameters: 7.0e-6 dense, 1.1e-5 sharded, 2.7e-3
# for make_sp_train_step (the first layer's residue above).
ONE_PROCESS_LOSS_RTOL = 1e-5
SECOND_LOSS_RTOL = 1e-4
ONE_PROCESS_GRAD_RTOL = {'dense': 1e-4, 'sp_trainer': 1e-4, 'sp_step': 1e-2,
                         'straddle_sp': 1e-4, 'straddle_step': 1e-2}
CLI_MODEL = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, n_harmonics=8,
                 n_noise_magnitudes=9, reverb_length=3000, rnn_channels=16,
                 ch=16, compute_dtype='float32')
# Eval across ranks: the Trainer cases' model on a fixed set of one batch
# of 4 synthetic notes at 125 frames/s (64 hops of 128 samples).
EVAL_MESHES = ((1, 4), (2, 2), (4, 1))
SP_EVAL_MESHES = EVAL_MESHES[:2]
EVAL_BATCH, EVAL_FRAME_RATE = 4, 125
# The eval scalars against the JAX package's: tests/test_torch_sp_eval.py's
# JAX_LOSS_RTOL (the two frameworks' float32 phase sums; here 1.8e-6 and
# 8.6e-7 apart on an x86 CPU).
JAX_EVAL_RTOL = 1e-3
# Against the port's one-process eval on the same mesh: the same shards and
# arithmetic, only the loss's sums taken over ranks in another order (the
# dense mesh: the rows' means averaged over ranks). Measured equal on an
# x86 CPU; held at tests/test_torch_sp_eval.py's single-precision tier.
ONE_PROCESS_EVAL_RTOL = 1e-5
# The gathered audio against the one-process audio: the shards' own signals
# assembled (measured equal on the SP meshes; 3.6e-7 on the dense one,
# whose ranks run the network on one row each, not four). Tighter than
# tests/test_torch_sp_eval.py's SP_AUDIO_ATOL (3e-3), which holds SP
# against dense.
ONE_PROCESS_AUDIO_ATOL = 1e-5
# The straddled eval's audio against the JAX package's: the two frameworks'
# float32 phase sums (tests/test_torch_sp.py holds the SP signals at this
# atol).
JAX_AUDIO_ATOL = 3e-3
# The nodes and losses that gather (Crop, Mix, an L2 SpectralLoss): one
# Trainer step on each mesh of ranks against jax.value_and_grad on the same
# mesh shape. The Crop model synthesizes one extra hop and crops it from the
# back, as the vst preset does: 64 frames of 130 samples, 8320 samples
# cropped to 8192.
NODE_CASES = ('crop', 'mix', 'l2')
NODE_MESHES = ((1, 4), (2, 2))
NODE_BATCH = 2
CROP = 128
# Whole data rows per rank: the dense step on an (8 x 1) mesh of the four
# ranks (two rows each) and the SP Trainer step on a (4 x 2) mesh of two
# ranks (two rows of two time shards each).
ROWS_CASES = {'rows_dense': ((8, 1), 8), 'rows_sp': ((4, 2), 4)}
# The straddled mesh's steps: the Trainer's SP step and make_sp_train_step.
STRADDLE_CASES = ('straddle_sp', 'straddle_step')


# ---------------------------------------------------------------------------
# Inputs (numpy, shared by both sides)
# ---------------------------------------------------------------------------
def _signal(rows, n, seed):
  rng = np.random.RandomState(seed)
  t = np.arange(n) / 16000
  f0 = 220.0 + 30.0 * np.arange(rows)[:, None]
  return (0.3 * np.sin(2 * np.pi * f0 * t) +
          0.05 * rng.randn(rows, n)).astype(np.float32)


def _trainer_batch(rows):
  return {'audio': _signal(rows, N_SAMPLES, 0),
          'f0_hz': np.tile((220.0 + 30.0 * np.arange(rows))[:, None, None],
                           (1, N_FRAMES, 1)).astype(np.float32)}


def _noise(rows, n, seed=9):
  return np.random.RandomState(seed).uniform(-1, 1, (rows, n)).astype(
      np.float32)


def _sp_batch(rows=1):
  hop = SP_SAMPLES // SP_FRAMES
  t = np.arange(SP_SAMPLES) / 16000
  f0 = 220.0 + 30.0 * np.arange(rows)[:, None]
  target = (0.3 * np.sin(2 * np.pi * f0 * t) +
            3e-3 * np.random.RandomState(0).randn(rows, SP_SAMPLES))
  env = 0.5 + 0.4 * np.sin(2 * np.pi * t[::hop])
  frames = lambda x: np.broadcast_to(x[:, :, None], (rows, SP_FRAMES, 1))
  return {'audio': target.astype(np.float32),
          'f0_hz': frames(f0.repeat(SP_FRAMES, 1)).astype(np.float32),
          'ld_scaled': frames(env[None]).astype(np.float32),
          'f0_scaled': frames(0.55 + 0.01 * np.arange(rows)[:, None].repeat(
              SP_FRAMES, 1)).astype(np.float32)}


def _trainer_model(lib, nn_lib, proc_lib, autoencoder):
  """tests/test_torch_sp.py's model, in either framework."""
  return autoencoder(
      preprocessor=nn_lib.F0LoudnessPreprocessor(
          time_steps=N_FRAMES, sample_rate=16000,
          compute_loudness_fresh=True),
      encoder=None,
      decoder=nn_lib.RnnFcDecoder(
          rnn_channels=16, rnn_type='gru', ch=16, layers_per_stack=1,
          input_keys=('ld_scaled', 'f0_scaled'),
          output_splits=(('amps', 1), ('harmonic_distribution', 8),
                         ('noise_magnitudes', 9)), compute_dtype='float32'),
      processor_group=proc_lib.ProcessorGroup(dag=[
          (proc_lib.Harmonic(n_samples=N_SAMPLES, sample_rate=16000,
                             name='harmonic'),
           ['amps', 'harmonic_distribution', 'f0_hz']),
          (proc_lib.FilteredNoise(n_samples=N_SAMPLES, window_size=0,
                                  name='filtered_noise'),
           ['noise_magnitudes']),
          (proc_lib.Add(name='add'),
           ['filtered_noise/signal', 'harmonic/signal']),
          (proc_lib.Reverb(trainable=True, reverb_length=3000,
                           name='reverb'), ['add/signal']),
      ]),
      losses=(lib.SpectralLoss(fft_sizes=FFT_SIZES, loss_type='L1',
                               mag_weight=1.0, logmag_weight=0.0),))


def _node_model(case, lib, nn_lib, proc_lib, autoencoder):
  """The Trainer cases' model with a node or a loss that gathers across
  ranks: 'crop' (one extra hop synthesized and cropped from the back),
  'mix' (Mix of the two synths by a decoded level) or 'l2' (the loss)."""
  if case == 'l2':
    model = _trainer_model(lib, nn_lib, proc_lib, autoencoder)
    loss = lib.SpectralLoss(fft_sizes=FFT_SIZES, loss_type='L2',
                            mag_weight=1.0, logmag_weight=0.0)
    if hasattr(model, 'clone'):  # a flax module
      return model.clone(losses=(loss,))
    model.losses[0] = loss
    return model
  n = N_SAMPLES + (CROP if case == 'crop' else 0)
  splits = (('amps', 1), ('harmonic_distribution', 8),
            ('noise_magnitudes', 9))
  dag = [(proc_lib.Harmonic(n_samples=n, sample_rate=16000, name='harmonic'),
          ['amps', 'harmonic_distribution', 'f0_hz'])]
  if case == 'crop':
    dag += [(proc_lib.FilteredNoise(n_samples=n, window_size=0,
                                    name='filtered_noise'),
             ['noise_magnitudes']),
            (proc_lib.Add(name='add'),
             ['filtered_noise/signal', 'harmonic/signal']),
            (proc_lib.Crop(frame_size=CROP, crop_location='back',
                           name='crop'), ['add/signal'])]
  else:
    # Two harmonic synths: the JAX package's sharded forward of a
    # FilteredNoise signal into Mix fails in XLA's CPU FFT (a layout
    # RET_CHECK), forward and backward.
    splits += (('harmonic_distribution_2', 8), ('mix_level', 1))
    dag += [(proc_lib.Harmonic(n_samples=n, sample_rate=16000,
                               name='harmonic_2'),
             ['amps', 'harmonic_distribution_2', 'f0_hz']),
            (proc_lib.Mix(name='mix'),
             ['harmonic/signal', 'harmonic_2/signal', 'mix_level'])]
  return autoencoder(
      preprocessor=nn_lib.F0LoudnessPreprocessor(
          time_steps=N_FRAMES, sample_rate=16000,
          compute_loudness_fresh=True),
      encoder=None,
      decoder=nn_lib.RnnFcDecoder(
          rnn_channels=16, rnn_type='gru', ch=16, layers_per_stack=1,
          input_keys=('ld_scaled', 'f0_scaled'), output_splits=splits,
          compute_dtype='float32'),
      processor_group=proc_lib.ProcessorGroup(dag=dag),
      losses=(lib.SpectralLoss(fft_sizes=FFT_SIZES, loss_type='L1',
                               mag_weight=1.0, logmag_weight=0.0),))


def _model(case, lib, nn_lib, proc_lib, autoencoder):
  if case in NODE_CASES:
    return _node_model(case, lib, nn_lib, proc_lib, autoencoder)
  return _trainer_model(lib, nn_lib, proc_lib, autoencoder)


def _eval_provider(package, batch=EVAL_BATCH):
  return package(n_samples=N_SAMPLES, sample_rate=16000,
                 frame_rate=EVAL_FRAME_RATE, n_examples=batch)


def _sp_decoder(nn_lib):
  return nn_lib.FcStackDecoder(ch=16, layers_per_stack=1,
                               input_keys=('ld_scaled', 'f0_scaled'),
                               output_splits=OUTPUT_SPLITS)


# ---------------------------------------------------------------------------
# The ranks (PyTorch only)
# ---------------------------------------------------------------------------
def _shift_inputs(shape):
  return (np.random.RandomState(3).randn(*shape).astype(np.float32),
          np.random.RandomState(4).randn(*shape).astype(np.float32))


def _mesh_shifts(mesh, shape):
  """Both shifts of the rank's shards of a global [rows, samples] signal
  of `shape`, and their adjoints: {direction: [((d, t), value, adjoint)
  for each shard of the run]}."""
  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel import halo
  from ddsp_torch.parallel import mesh as mesh_lib
  x, w = _shift_inputs(shape)
  rows = mesh_lib.local_rows(mesh, shape[0])
  span = mesh_lib.time_span(mesh, shape[1])
  out = {}
  for direction in (+1, -1):
    mine = torch.from_numpy(x[rows, span].copy()).requires_grad_()
    got = halo.neighbor_shift(mesh_lib.split_time(mesh, mine), mesh,
                              direction, impl='pallas')
    cot = mesh_lib.split_time(mesh, torch.from_numpy(w[rows, span].copy()))
    (grad,) = torch.autograd.grad(got, mine, cot)
    out[direction] = [(mesh.shard_coords(j), v.detach().numpy(), g.numpy())
                      for j, (v, g) in enumerate(
                          zip(got, mesh_lib.split_time(mesh, grad)))]
  return out


def _rank_shifts(create_mesh):
  out = {}
  for shape in SHIFT_MESHES:
    shifts = _mesh_shifts(create_mesh(*shape, devices=['cpu']), SHIFT_SHAPE)
    for direction, shards in shifts.items():
      out[f'{shape}{direction:+d}'] = shards
  return out


def _trainer_steps(case, params, mesh, steps=STEPS, batch_size=None):
  """Trainer steps (two by default) from the JAX parameters on `mesh` (a
  mesh over the ranks, or all its shards in one process): the losses, the
  first step's reduced gradients and the parameters after."""
  from ddsp_torch import losses, nn, proc  # pylint: disable=g-import-not-at-top
  from ddsp_torch.models import Autoencoder
  from ddsp_torch.parallel import mesh as mesh_lib
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import load_jax_params
  model = _model(case, losses, nn, proc, Autoencoder)
  load_jax_params(model, params)
  trainer = Trainer(model, mesh=mesh, seed=0, halo_impl='pallas')
  grads = []
  apply = trainer.apply_gradients

  def recording(state, names, ps, gs):
    grads.append({k: g.clone() for k, g in zip(names, gs)})
    return apply(state, names, ps, gs)

  trainer.apply_gradients = recording
  b = batch_size or GLOBAL_BATCH[case]
  n = N_SAMPLES + (CROP if case == 'crop' else 0)
  batch = mesh_lib.shard_batch(mesh, _trainer_batch(b))
  noise = torch.from_numpy(_noise(b, n)[mesh_lib.local_rows(mesh, b)])
  state = trainer.init()
  seen = []
  for _ in range(steps):
    state, step_losses = trainer.train_step(state, batch, noise=noise)
    seen.append(float(step_losses['total_loss']))
  return {'losses': seen, 'grads': grads[0],
          'params': {k: p.detach().clone() for k, p in state.params.items()}}


def _sp_steps(params, mesh, rows=1):
  """Two make_sp_train_step steps on `mesh`, likewise, on a batch of
  `rows`."""
  from ddsp_torch import nn  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel import make_sp_train_step
  from ddsp_torch.utils import load_jax_params
  decoder = _sp_decoder(nn)
  load_jax_params(decoder, params)
  train_step, shard_batch = make_sp_train_step(
      mesh, decoder, torch.optim.Adam(decoder.parameters(), lr=1e-2),
      n_samples=SP_SAMPLES, fft_sizes=SP_FFT_SIZES)
  batch, noise = shard_batch(_sp_batch(rows),
                             _noise(rows, SP_SAMPLES, seed=1))
  seen, grads = [], None
  for _ in range(STEPS):
    seen.append(float(train_step(batch, noise)))
    if grads is None:
      grads = {k: p.grad.clone() for k, p in decoder.named_parameters()}
  return {'losses': seen, 'grads': grads,
          'params': {k: p.detach().clone()
                     for k, p in decoder.named_parameters()}}


class _Recorder:
  """An evaluator that keeps the audio the evaluators saw."""

  def __init__(self):
    from ddsp_torch.eval import evaluators  # pylint: disable=g-import-not-at-top
    self.base = evaluators.BasicEvaluator(16000, EVAL_FRAME_RATE)
    self.audio = []

  def evaluate(self, batch, outputs, losses):
    self.base.evaluate(batch, outputs, losses)
    self.audio.append(outputs['audio_synth'])

  def sample(self, batch, outputs, save_dir, step):
    self.base.sample(batch, outputs, save_dir, step)

  def flush(self, step):
    return self.base.flush(step)


def _port_eval(params, ckpt, save_dir, mesh, mode='eval', noise=None,
               batch=EVAL_BATCH):
  """evaluate_or_sample of the Trainer cases' model from `ckpt` on `mesh`
  (a mesh over the ranks, or all its shards in one process): (scalars,
  the audio the evaluators saw, the files written under save_dir)."""
  # pylint: disable=g-import-not-at-top
  from ddsp_torch import losses, nn, proc
  from ddsp_torch.data import SyntheticSinusoidProvider
  from ddsp_torch.eval import evaluate_or_sample
  from ddsp_torch.models import Autoencoder
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import load_jax_params
  model = _trainer_model(losses, nn, proc, Autoencoder)
  load_jax_params(model, params)
  trainer = Trainer(model, mesh=mesh, device='cpu', halo_impl='pallas')
  recorder = _Recorder()
  scalars = evaluate_or_sample(
      _eval_provider(SyntheticSinusoidProvider, batch), trainer, save_dir,
      restore_dir=ckpt, mode=mode, evaluators=[recorder],
      batch_size=batch, num_batches=1,
      noise=None if noise is None else torch.from_numpy(noise))
  files = sorted(os.path.relpath(os.path.join(root, f), save_dir)
                 for root, _, names in os.walk(save_dir) for f in names
                 if not f.startswith('events.')) if os.path.isdir(
                     save_dir) else []
  return scalars, recorder.audio, files


def _rank_evals(rank, work_dir, params, create_mesh):
  """The eval cases on this rank: each mesh of EVAL_MESHES with the default
  noise, the SP meshes with the JAX comparison's noise, 'sample' on
  (1 x 4); every rank writes into its own save_dir."""
  out = {}
  ckpt = os.path.join(work_dir, 'ckpt')
  noise = _noise(EVAL_BATCH, N_SAMPLES)
  for shape in EVAL_MESHES:
    mesh = create_mesh(*shape, devices=['cpu'])
    where = lambda kind: os.path.join(work_dir, f'{kind}{shape}', f'r{rank}')  # pylint: disable=cell-var-from-loop
    out[shape, 'eval'] = _port_eval(params, ckpt, where('eval'), mesh)
    if shape in SP_EVAL_MESHES:
      out[shape, 'noise'] = _port_eval(params, ckpt, where('noise'), mesh,
                                       noise=noise)
    if shape == (1, 4):
      out[shape, 'sample'] = _port_eval(params, ckpt, where('sample'), mesh,
                                        mode='sample')
  return out


def _counting_shifts():
  """Wrap K3's plain versions (local and remote) to count their calls."""
  from ddsp_torch.kernels import halo as kh  # pylint: disable=g-import-not-at-top
  counts = {'local': 0, 'remote': 0}
  for key, name in (('local', 'halo_shift_plain'),
                    ('remote', 'remote_shift_plain')):
    fn = getattr(kh, name)

    def counted(*args, _fn=fn, _key=key, **kwargs):
      counts[_key] += 1
      return _fn(*args, **kwargs)

    setattr(kh, name, counted)
  return counts


def _rank_cli(rank, work_dir, ports):
  """The CLI on two ranks: 2 training steps, then --mode eval and --mode
  sample of that run, each main() its own process group."""
  from ddsp_torch import run  # pylint: disable=g-import-not-at-top
  flags = ['--multihost', '--device', 'cpu', '--save_dir',
           os.path.join(work_dir, 'cli'), '--data', 'synthetic:8',
           '--batch_size', '1', '--time_shards', '2']
  out = {}
  for mode, port in zip(('train', 'eval', 'sample'), ports):
    os.environ.update(RANK=str(rank), WORLD_SIZE='2', LOCAL_RANK=str(rank),
                      MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    if mode == 'train':
      state = run.main(flags + [
          '--preset', 'tiny', '--model_kwargs', json.dumps(CLI_MODEL),
          '--num_steps', '2', '--steps_per_summary', '1',
          '--steps_per_save', '2'])
      out['step'] = state.step
      out['params'] = {k: p.detach().clone()
                       for k, p in state.params.items()}
    else:
      out[mode] = run.main(flags + ['--mode', mode, '--run_once',
                                    '--num_eval_batches', '1'])
  return out


def _rank_straddle(rank, work_dir, inputs, create_mesh):
  """The cases of the (3 x 2) mesh over two ranks, whose runs straddle
  data row 1: K3's shifts, two steps of the Trainer's SP step and of
  make_sp_train_step, and an eval with the JAX comparison's noise."""
  mesh = lambda: create_mesh(*STRADDLE_MESH, devices=['cpu'] * 3)
  return {
      'straddle_shifts': _mesh_shifts(mesh(), STRADDLE_SHIFT_SHAPE),
      'straddle_sp': _trainer_steps('straddle_sp', inputs['trainer_params'],
                                    mesh(), batch_size=STRADDLE_BATCH),
      'straddle_step': _sp_steps(inputs['sp_params'], mesh(),
                                 rows=STRADDLE_BATCH),
      'straddle_eval': _port_eval(inputs['trainer_params'],
                         os.path.join(work_dir, 'ckpt'),
                         os.path.join(work_dir, 'straddle_eval', f'r{rank}'),
                         mesh(), noise=_noise(STRADDLE_BATCH, N_SAMPLES),
                         batch=STRADDLE_BATCH)}


def _rank_main(rank, work_dir, ports):
  torch.set_num_threads(1)
  from ddsp_torch.parallel import create_mesh, distributed  # pylint: disable=g-import-not-at-top
  inputs = torch.load(os.path.join(work_dir, 'inputs.pt'), weights_only=False)
  distributed.init(device='cpu', init_method='file://' + os.path.join(
      work_dir, 'init'), rank=rank, world_size=N_RANKS)
  result = {'shifts': _rank_shifts(create_mesh)}
  for case in ('dense', 'sp_trainer'):
    result[case] = _trainer_steps(case, inputs['trainer_params'],
                                  create_mesh(*MESHES[case], devices=['cpu']))
  result['sp_step'] = _sp_steps(
      inputs['sp_params'], create_mesh(*MESHES['sp_step'], devices=['cpu']))
  result['eval'] = _rank_evals(rank, work_dir, inputs['trainer_params'],
                               create_mesh)
  for case in NODE_CASES:
    for shape in NODE_MESHES:
      result[case, shape] = _trainer_steps(
          case, inputs['node_params'][case],
          create_mesh(*shape, devices=['cpu']), steps=1,
          batch_size=NODE_BATCH)
  counts = _counting_shifts()
  (shape, batch), = [ROWS_CASES['rows_dense']]
  result['rows_dense'] = _trainer_steps(
      'rows_dense', inputs['trainer_params'],
      create_mesh(*shape, devices=['cpu'] * 2), batch_size=batch)
  distributed.shutdown()
  if rank < 2:
    result['cli'] = _rank_cli(rank, work_dir, ports)
    counts.update(local=0, remote=0)
    distributed.init(device='cpu', init_method='file://' + os.path.join(
        work_dir, 'init2'), rank=rank, world_size=2)
    shape, batch = ROWS_CASES['rows_sp']
    result['rows_sp'] = _trainer_steps(
        'rows_sp', inputs['trainer_params'],
        create_mesh(*shape, devices=['cpu'] * 4), batch_size=batch)
    result['rows_shifts'] = dict(counts)
    counts.update(local=0, remote=0)
    result.update(_rank_straddle(rank, work_dir, inputs, create_mesh))
    result['straddle_shift_counts'] = dict(counts)
    distributed.shutdown()
  torch.save(result, os.path.join(work_dir, f'rank{rank}.pt'))


# ---------------------------------------------------------------------------
# The JAX side (the parent process)
# ---------------------------------------------------------------------------
def _jax_side(trainer_params, sp_params, node_params, work_dir):
  # pylint: disable=g-import-not-at-top
  import functools
  import jax
  import jax.numpy as jnp
  from jax.sharding import Mesh as JaxMesh
  from jax.sharding import PartitionSpec as P
  from ddsp_tpu import losses as j_losses
  from ddsp_tpu import nn as j_nn
  from ddsp_tpu import proc as j_proc
  from ddsp_tpu.models import Autoencoder as JaxAutoencoder
  from ddsp_torch.ops.core import flatten
  from ddsp_tpu.parallel import create_mesh as j_create_mesh
  from ddsp_tpu.parallel import make_sp_train_step as j_make_sp_train_step
  from ddsp_tpu.parallel import mesh as j_mesh_lib
  from ddsp_tpu.parallel import pallas_halo
  from ddsp_tpu.parallel import sp_synth_and_loss
  from ddsp_tpu.parallel import sp_model as j_sp_model
  out = {}
  devices = jax.devices()[:N_RANKS]
  for shape, signal in [(m, SHIFT_SHAPE) for m in SHIFT_MESHES] + [
      (STRADDLE_MESH, STRADDLE_SHIFT_SHAPE)]:
    x, w = _shift_inputs(signal)
    if shape[0] == 1:
      jmesh, spec = JaxMesh(np.asarray(devices), ('time',)), P(None, 'time')
    else:
      jmesh = j_create_mesh(n_data=shape[0], n_time=shape[1],
                            devices=jax.devices()[:shape[0] * shape[1]])
      spec = P('data', 'time')
    for direction in (+1, -1):
      shift = jax.jit(jax.shard_map(
          functools.partial(pallas_halo.neighbor_shift, direction=direction,
                            impl='pallas'), mesh=jmesh, in_specs=spec,
          out_specs=spec, check_vma=False))
      value, vjp = jax.vjp(shift, x)
      out[f'{shape}{direction:+d}'] = (np.asarray(value),
                                       np.asarray(vjp(jnp.asarray(w))[0]))

  uniform = jax.random.uniform
  fixed = {}

  def fixed_noise(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
    if tuple(shape) in fixed:
      return jnp.asarray(fixed[tuple(shape)])
    return uniform(key, shape, dtype, minval, maxval)

  pool = concurrent.futures.ThreadPoolExecutor(JAX_COMPILE_THREADS)

  def step(model, params, b, n, shape):
    """The JAX Trainer's step function on a mesh of `shape`: its
    value_and_grad of the model's losses (sp_forward_with_losses when the
    mesh shards time), on the global batch of b rows. Traced here, compiled
    on the pool; returns a function that runs it."""
    fixed.clear()
    fixed[(b, n)] = _noise(b, n)
    n_data, n_time = shape
    jmesh = j_create_mesh(n_data=n_data, n_time=n_time,
                          devices=jax.devices()[:n_data * n_time])
    batch = j_mesh_lib.shard_batch(_trainer_batch(b), jmesh)
    if n_time > 1:
      loss_fn = lambda p, bt: model.apply(
          {'params': p}, bt, mesh=jmesh, training=True, halo_impl='pallas',
          method=j_sp_model.sp_forward_with_losses,
          rngs={'noise': jax.random.PRNGKey(0)})[1]['total_loss']
    else:
      loss_fn = lambda p, bt: model.apply(
          {'params': p}, bt, training=True, return_losses=True,
          rngs={'noise': jax.random.PRNGKey(0)})[1]['total_loss']
    compiled = pool.submit(
        jax.jit(jax.value_and_grad(loss_fn)).lower(params, batch).compile)

    def run():
      loss, grads = compiled.result()(params, batch)
      return float(loss), flatten(jax.tree_util.tree_map(np.asarray, grads))

    return run

  steps = {}
  with pytest.MonkeyPatch.context() as patch:
    patch.setattr(jax.random, 'uniform', fixed_noise)
    model = _trainer_model(j_losses, j_nn, j_proc, JaxAutoencoder)
    for case in ('dense', 'sp_trainer'):
      steps[case] = step(model, trainer_params, GLOBAL_BATCH[case],
                         N_SAMPLES, MESHES[case])
    for case, (shape, b) in ROWS_CASES.items():
      steps[case] = step(model, trainer_params, b, N_SAMPLES, shape)
    steps['straddle_sp'] = step(model, trainer_params, STRADDLE_BATCH,
                                N_SAMPLES, STRADDLE_MESH)
    for case in NODE_CASES:
      node = _node_model(case, j_losses, j_nn, j_proc, JaxAutoencoder)
      n = N_SAMPLES + (CROP if case == 'crop' else 0)
      for shape in NODE_MESHES:
        steps[case, shape] = step(node, node_params[case], NODE_BATCH, n,
                                  shape)
    fixed.clear()
    fixed[(EVAL_BATCH, N_SAMPLES)] = _noise(EVAL_BATCH, N_SAMPLES)
    fixed[(STRADDLE_BATCH, N_SAMPLES)] = _noise(STRADDLE_BATCH, N_SAMPLES)
    for shape in SP_EVAL_MESHES:
      out['eval', shape] = _jax_eval(model, trainer_params, shape, work_dir)
    out['eval', STRADDLE_MESH] = _jax_eval(
        model, trainer_params, STRADDLE_MESH, work_dir, STRADDLE_BATCH)
  out.update({key: run() for key, run in steps.items()})
  pool.shutdown()

  decoder = _sp_decoder(j_nn)

  def sp_step(shape, rows):
    """The JAX long-audio step's loss and gradients on a mesh of `shape`
    and a batch of `rows`."""
    jmesh = j_create_mesh(n_data=shape[0], n_time=shape[1],
                          devices=jax.devices()[:shape[0] * shape[1]])
    _, shard_batch = j_make_sp_train_step(
        jmesh, decoder, None, n_samples=SP_SAMPLES, fft_sizes=SP_FFT_SIZES)
    batch, noise = shard_batch(_sp_batch(rows),
                               _noise(rows, SP_SAMPLES, seed=1))

    def sp_loss(p):
      controls = decoder.apply({'params': p}, batch, training=True)
      return sp_synth_and_loss(
          jmesh, batch['audio'], batch['f0_hz'], controls['amps'],
          controls['harmonic_distribution'], controls['noise_magnitudes'],
          noise, n_samples=SP_SAMPLES, fft_sizes=SP_FFT_SIZES)

    loss, grads = jax.jit(jax.value_and_grad(sp_loss))(sp_params)
    return float(loss), flatten(jax.tree_util.tree_map(np.asarray, grads))

  out['sp_step'] = sp_step(MESHES['sp_step'], 1)
  out['straddle_step'] = sp_step(STRADDLE_MESH, STRADDLE_BATCH)
  return out


def _jax_eval(model, params, shape, work_dir, batch=EVAL_BATCH):
  """The JAX package's evaluate_or_sample on a mesh of `shape` with a
  stand-in trainer that hands over `params` as step 0's checkpoint: the
  scalars it writes, and the audio its evaluator saw."""
  # pylint: disable=g-import-not-at-top
  import jax
  from ddsp_tpu.data import SyntheticSinusoidProvider as JaxSinusoids
  from ddsp_tpu.eval import eval_util as j_eval_util
  from ddsp_tpu.eval import evaluators as j_evaluators
  from ddsp_tpu.parallel import create_mesh as j_create_mesh
  n_data, n_time = shape
  root = os.path.join(work_dir, f'jax_eval{shape}')
  os.makedirs(os.path.join(root, 'ckpt', '0'))
  state = types.SimpleNamespace(params=params, step=0)
  trainer = types.SimpleNamespace(
      model=model, halo_impl='pallas', init=lambda batch: state,
      restore=lambda state, restore_dir: state,
      mesh=j_create_mesh(n_data=n_data, n_time=n_time,
                         devices=jax.devices()[:n_data * n_time]))
  audio = []

  class Recorder(j_evaluators.BasicEvaluator):

    def evaluate(self, batch, outputs, losses):
      super().evaluate(batch, outputs, losses)
      audio.append(np.asarray(outputs['audio_synth']))

  j_eval_util.evaluate_or_sample(
      _eval_provider(JaxSinusoids, batch), trainer,
      os.path.join(root, 'eval'), restore_dir=os.path.join(root, 'ckpt'),
      evaluators=[Recorder(16000, EVAL_FRAME_RATE)], batch_size=batch,
      num_batches=1)
  with open(os.path.join(root, 'eval', 'eval', 'metrics.jsonl')) as f:
    return json.loads(f.read().splitlines()[-1]), audio[0]


def _port_side(trainer_params, sp_params):
  """The same steps in one process of the port (the mesh's shards in one
  process, R = 1)."""
  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel import create_mesh, distributed
  assert distributed.world_size() == 1
  out = {}
  for case in ('dense', 'sp_trainer'):
    shape = MESHES[case]
    out[case] = _trainer_steps(
        case, trainer_params, create_mesh(*shape, devices=['cpu'] * 4))
  out['sp_step'] = _sp_steps(sp_params, create_mesh(1, 4,
                                                     devices=['cpu'] * 4))
  mesh = lambda: create_mesh(*STRADDLE_MESH, devices=['cpu'] * 6)
  out['straddle_sp'] = _trainer_steps('straddle_sp', trainer_params, mesh(),
                                      batch_size=STRADDLE_BATCH)
  out['straddle_step'] = _sp_steps(sp_params, mesh(), rows=STRADDLE_BATCH)
  return out


def _port_evals(trainer_params, work_dir):
  """The eval cases in one process of the port: each mesh of EVAL_MESHES
  with every shard in this process, and 'sample' on (1 x 4)."""
  from ddsp_torch.parallel import create_mesh  # pylint: disable=g-import-not-at-top
  out = {}
  ckpt = os.path.join(work_dir, 'ckpt')
  for shape in EVAL_MESHES:
    mesh = create_mesh(*shape, devices=['cpu'] * 4)
    out[shape] = _port_eval(trainer_params, ckpt,
                            os.path.join(work_dir, f'one{shape}'), mesh)
  out['sample'] = _port_eval(trainer_params, ckpt,
                             os.path.join(work_dir, 'one_sample'),
                             create_mesh(1, 4, devices=['cpu'] * 4),
                             mode='sample')
  return out


def _save_checkpoint(trainer_params, path):
  """A port checkpoint (step 0) of the Trainer cases' model with the JAX
  parameters."""
  # pylint: disable=g-import-not-at-top
  from ddsp_torch import losses, nn, proc
  from ddsp_torch.models import Autoencoder
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import load_jax_params
  model = _trainer_model(losses, nn, proc, Autoencoder)
  load_jax_params(model, trainer_params)
  trainer = Trainer(model, device='cpu')
  trainer.save(trainer.init(), path)


def _jax_params():
  # pylint: disable=g-import-not-at-top
  import jax
  from ddsp_tpu import losses as j_losses
  from ddsp_tpu import nn as j_nn
  from ddsp_tpu import proc as j_proc
  from ddsp_tpu.models import Autoencoder as JaxAutoencoder
  model = _trainer_model(j_losses, j_nn, j_proc, JaxAutoencoder)
  variables = jax.jit(lambda b: model.init(
      {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}, b,
      training=True, return_losses=True))(_trainer_batch(2))
  decoder_params = jax.jit(_sp_decoder(j_nn).init)(jax.random.PRNGKey(0),
                                                   _sp_batch())['params']
  to_np = lambda t: jax.tree_util.tree_map(np.array, t)
  params = to_np(variables['params'])
  # The node models share the decoder; Mix's decodes nine more outputs (a
  # second harmonic distribution and the mix level), whose weights and
  # biases are drawn here.
  mix = {'decoder': dict(params['decoder'])}
  rng = np.random.RandomState(5)
  head = mix['decoder']['dense_out'] = dict(params['decoder']['dense_out'])
  head['kernel'] = np.concatenate(
      [head['kernel'], 0.3 * rng.randn(head['kernel'].shape[0], 9)],
      axis=1).astype(np.float32)
  head['bias'] = np.append(head['bias'],
                           0.1 * rng.randn(9)).astype(np.float32)
  node_params = {'crop': {'decoder': params['decoder']}, 'mix': mix,
                 'l2': params}
  return params, to_np(decoder_params), node_params


def _free_port():
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


@pytest.fixture(scope='module')
def runs():
  """(the ranks' results by rank, the JAX package's first steps, the port's
  steps in one process, the files of the CLI's save_dir)."""
  trainer_params, sp_params, node_params = _jax_params()
  with tempfile.TemporaryDirectory() as work_dir:
    torch.save({'trainer_params': trainer_params, 'sp_params': sp_params,
                'node_params': node_params},
               os.path.join(work_dir, 'inputs.pt'))
    _save_checkpoint(trainer_params, os.path.join(work_dir, 'ckpt'))
    ports = [_free_port() for _ in range(3)]
    ctx = mp.start_processes(_rank_main, args=(work_dir, ports),
                             nprocs=N_RANKS, join=False,
                             start_method='spawn')
    try:
      jax_side = _jax_side(trainer_params, sp_params, node_params, work_dir)
      port_side = _port_side(trainer_params, sp_params)
      port_side['eval'] = _port_evals(trainer_params, work_dir)
    finally:
      deadline = time.time() + RANKS_TIMEOUT_S
      while not ctx.join(timeout=5):
        if time.time() > deadline:
          for p in ctx.processes:
            p.kill()
          pytest.fail(f'the ranks did not finish in {RANKS_TIMEOUT_S} s')
    ranks = {r: torch.load(os.path.join(work_dir, f'rank{r}.pt'),
                           weights_only=False) for r in range(N_RANKS)}
    cli_dir = os.path.join(work_dir, 'cli')
    cli_files = sorted(os.path.relpath(os.path.join(root, f), cli_dir)
                       for root, _, names in os.walk(cli_dir)
                       for f in names)
    yield ranks, jax_side, port_side, cli_files


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------
@pytest.mark.parametrize('shape', SHIFT_MESHES)
@pytest.mark.parametrize('direction', [+1, -1])
def test_remote_shift_values_and_adjoint_match_jax(runs, shape, direction):
  ranks, jax_side, _, _ = runs
  key = f'{shape}{direction:+d}'
  _check_shift(shape, SHIFT_SHAPE, [ranks[r]['shifts'][key]
                                    for r in range(N_RANKS)], *jax_side[key])


def _check_shift(shape, signal, parts, value, adjoint):
  """Every rank's shards of a shift and its adjoint, placed into the
  global signal, against the JAX package's, exactly."""
  rows, samples = signal[0] // shape[0], signal[1] // shape[1]
  got_value = np.full(signal, np.nan, np.float32)
  got_adjoint = np.full(signal, np.nan, np.float32)
  for shards in parts:
    for (d, t), v, g in shards:
      at = (slice(d * rows, (d + 1) * rows),
            slice(t * samples, (t + 1) * samples))
      got_value[at], got_adjoint[at] = v, g
  np.testing.assert_array_equal(got_value, value)
  np.testing.assert_array_equal(got_adjoint, adjoint)


@pytest.mark.parametrize('direction', [+1, -1])
def test_straddled_shift_matches_jax(runs, direction):
  """K3's shift on the (3 x 2) mesh over two ranks, whose runs straddle
  data row 1 (the local launch on a run that starts inside a row, the
  remote copy between the rows' halves), against neighbor_shift on a
  (3 x 2) mesh, exactly; both ranks shifted locally and remotely."""
  ranks, jax_side, _, _ = runs
  parts = [ranks[r]['straddle_shifts'][direction] for r in (0, 1)]
  _check_shift(STRADDLE_MESH, STRADDLE_SHIFT_SHAPE, parts,
               *jax_side[f'{STRADDLE_MESH}{direction:+d}'])
  for r in (0, 1):
    counts = ranks[r]['straddle_shift_counts']
    assert counts['local'] > 0 and counts['remote'] > 0, counts


def _rel_l2(a, b):
  return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(grads):
  return {k.replace('.', '/'): np.asarray(g) for k, g in grads.items()}


def _holders(case):
  """The ranks that ran a case: the two-rank group's cases ran on two."""
  return range(2 if case in ('cli', 'rows_sp') + STRADDLE_CASES
               else N_RANKS)


def _check_step_against_jax(ranks, case, want_loss, want, net_rtol):
  """The first step's loss on every rank that ran it and its reduced
  gradients (rank 0's) against the JAX package's step."""
  for r in _holders(case if isinstance(case, str) else 'node'):
    np.testing.assert_allclose(ranks[r][case]['losses'][0], want_loss,
                               rtol=JAX_LOSS_RTOL.get(case, LOSS_RTOL))
  got = _flat(ranks[0][case]['grads'])
  assert sorted(got) == sorted(want)
  net = sorted(k for k in got if k != IR_NAME)
  whole = lambda d: np.concatenate([d[k].ravel() for k in net])
  assert _rel_l2(whole(got), whole(want)) <= net_rtol
  if IR_NAME in got:
    g, w = got[IR_NAME].ravel(), want[IR_NAME].ravel()
    assert _rel_l2(g, w) <= IR_GRAD_RTOL
    assert float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))) >= (
        IR_GRAD_COSINE)


@pytest.mark.parametrize('case', CASES + tuple(ROWS_CASES) + STRADDLE_CASES)
def test_first_step_matches_jax(runs, case):
  """The first step's loss on every rank and its reduced gradients against
  the JAX package's step on the global batch."""
  ranks, jax_side, _, _ = runs
  _check_step_against_jax(ranks, case, *jax_side[case], NET_GRAD_RTOL[case])


@pytest.mark.parametrize('shape', NODE_MESHES)
@pytest.mark.parametrize('case', NODE_CASES)
def test_gathering_nodes_and_losses_match_jax(runs, case, shape):
  """A Crop, a Mix and an L2 SpectralLoss across ranks: the loss on every
  rank and every parameter's reduced gradient against jax.value_and_grad
  of the JAX sp_forward_with_losses on a mesh of the same shape. A gather
  whose backward summed where it must not would scale the gradients by the
  ranks of a row."""
  ranks, jax_side, _, _ = runs
  _check_step_against_jax(ranks, (case, shape), *jax_side[case, shape],
                          NET_GRAD_RTOL['sp_trainer'])


@pytest.mark.parametrize('case', CASES + STRADDLE_CASES)
def test_steps_match_the_one_process_port(runs, case):
  """Both steps' losses and the first step's reduced gradients against the
  same steps with every shard in one process: R ranks take the
  one-process step."""
  ranks, _, port_side, _ = runs
  want = port_side[case]
  for r in _holders(case):
    np.testing.assert_allclose(ranks[r][case]['losses'][0],
                               want['losses'][0], rtol=ONE_PROCESS_LOSS_RTOL)
    np.testing.assert_allclose(ranks[r][case]['losses'][1],
                               want['losses'][1], rtol=SECOND_LOSS_RTOL)
  got, ref = _flat(ranks[0][case]['grads']), _flat(want['grads'])
  assert sorted(got) == sorted(ref)
  whole = lambda d: np.concatenate([d[k].ravel() for k in sorted(got)])
  assert _rel_l2(whole(got), whole(ref)) <= ONE_PROCESS_GRAD_RTOL[case]
  assert ranks[0][case]['losses'][1] < ranks[0][case]['losses'][0]


@pytest.mark.parametrize('case', CASES + ('cli',) + tuple(ROWS_CASES) +
                         STRADDLE_CASES)
def test_parameters_equal_across_ranks(runs, case):
  ranks = runs[0]
  first = ranks[0][case]['params']
  for r in _holders(case)[1:]:
    for k, p in ranks[r][case]['params'].items():
      assert torch.equal(p, first[k]), (case, r, k)


def test_whole_rows_shift_within_the_process(runs):
  """The (4 x 2) SP step over two ranks, two whole rows a rank: every halo
  shift runs among the rank's own shards, none between ranks."""
  for r in _holders('rows_sp'):
    counts = runs[0][r]['rows_shifts']
    assert counts['local'] > 0 and counts['remote'] == 0, counts


def test_multihost_cli_trains_and_rank_zero_writes(runs):
  ranks, files = runs[0], runs[3]
  assert ranks[0]['cli']['step'] == ranks[1]['cli']['step'] == 2
  assert {'ckpt-00000002.pt', 'metrics.jsonl',
          'operative_spec.json'} <= set(files)
  assert not [f for f in files if 'tmp' in f]


@pytest.mark.parametrize('mode', ['eval', 'sample'])
def test_multihost_cli_evaluates_and_samples(runs, mode):
  """--multihost --mode eval|sample of the CLI's training run on its two
  ranks: the same result on both, rank 0's files in the save_dir."""
  ranks, files = runs[0], runs[3]
  got = [ranks[r]['cli'][mode] for r in _holders('cli')]
  assert got[0] == got[1]
  if mode == 'eval':
    assert 'losses/total_loss' in got[0]
    assert np.isfinite(got[0]['losses/total_loss'])
    assert 'eval/metrics.jsonl' in files
  else:
    assert got[0] == {}
    assert {'samples/step_2/0_original.wav',
            'samples/step_2/0_synth.wav'} <= set(files)


@pytest.mark.parametrize('shape', SP_EVAL_MESHES)
def test_eval_across_ranks_matches_jax(runs, shape):
  """evaluate_or_sample on a mesh of ranks against the JAX package's on a
  mesh of the same shape, with the same noise: every rank's scalars."""
  ranks, jax_side = runs[0], runs[1]
  want = jax_side['eval', shape][0]
  for r in range(N_RANKS):
    got = ranks[r]['eval'][shape, 'noise'][0]
    assert set(got) == set(want) - {'step'} == {'losses/spectral_loss',
                                                 'losses/total_loss'}
    for key, value in got.items():
      np.testing.assert_allclose(value, want[key], rtol=JAX_EVAL_RTOL,
                                 err_msg=key)


def test_straddled_eval_matches_jax(runs):
  """evaluate_or_sample on the (3 x 2) mesh over two ranks, with the JAX
  comparison's noise, against the JAX package's on a (3 x 2) mesh: the
  scalars on both ranks, the audio rank 0's evaluators saw, and rank 0
  alone writing."""
  ranks, jax_side = runs[0], runs[1]
  want, want_audio = jax_side['eval', STRADDLE_MESH]
  for r in (0, 1):
    got = ranks[r]['straddle_eval'][0]
    assert set(got) == set(want) - {'step'}
    for key, value in got.items():
      np.testing.assert_allclose(value, want[key], rtol=JAX_EVAL_RTOL,
                                 err_msg=key)
  (audio,) = ranks[0]['straddle_eval'][1]
  assert audio.shape == want_audio.shape == (STRADDLE_BATCH, N_SAMPLES)
  np.testing.assert_allclose(audio, want_audio, atol=JAX_AUDIO_ATOL)
  assert ranks[0]['straddle_eval'][2] == ['eval/metrics.jsonl']
  assert ranks[1]['straddle_eval'][1:] == ([], [])


@pytest.mark.parametrize('shape', EVAL_MESHES)
def test_eval_across_ranks_matches_one_process(runs, shape):
  """With each rank's own noise (the global batch's draw, its rows kept)
  against the port's eval with every shard in one process: the scalars on
  every rank and the audio the evaluators saw, gathered on rank 0."""
  ranks, port_side = runs[0], runs[2]
  want, (want_audio,), _ = port_side['eval'][shape]
  for r in range(N_RANKS):
    got = ranks[r]['eval'][shape, 'eval'][0]
    assert set(got) == set(want)
    for key, value in got.items():
      np.testing.assert_allclose(value, want[key],
                                 rtol=ONE_PROCESS_EVAL_RTOL, err_msg=key)
  (audio,) = ranks[0]['eval'][shape, 'eval'][1]
  assert audio.shape == want_audio.shape == (EVAL_BATCH, N_SAMPLES)
  np.testing.assert_allclose(audio, want_audio, atol=ONE_PROCESS_AUDIO_ATOL)


@pytest.mark.parametrize('shape', EVAL_MESHES)
def test_only_rank_zero_evaluates_and_writes(runs, shape):
  ranks = runs[0]
  assert ranks[0]['eval'][shape, 'eval'][2] == ['eval/metrics.jsonl']
  for r in range(1, N_RANKS):
    _, audio, files = ranks[r]['eval'][shape, 'eval']
    assert audio == [] and files == []


def test_sample_across_ranks_writes_the_one_process_files(runs):
  ranks, port_side = runs[0], runs[2]
  scalars, _, files = ranks[0]['eval'][(1, 4), 'sample']
  assert scalars == {}
  assert files == port_side['eval']['sample'][2]
  assert {f'samples/step_0/{i}_{kind}.wav' for i in range(EVAL_BATCH)
          for kind in ('original', 'synth')} <= set(files)
  for r in range(1, N_RANKS):
    assert ranks[r]['eval'][(1, 4), 'sample'][2] == []


# ---------------------------------------------------------------------------
# The rules of a mesh over ranks, without a process group
# ---------------------------------------------------------------------------
def _ranks_mesh(shape, rank, per_rank=1):
  from ddsp_torch.parallel import distributed  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel.mesh import Mesh
  n_data, n_time = shape
  ranks = distributed.Ranks(rank, n_data * n_time // per_rank, n_data,
                            n_time)
  return Mesh(['cpu'] * per_rank, n_data, n_time, ranks)


@pytest.mark.parametrize('rank,direction,want', [
    (0, +1, (0, 1, 0, None)), (0, -1, (0, None, 0, 1)),
    (2, +1, (0, 3, 0, 1)), (3, +1, (0, None, 0, 2)),
    (3, -1, (0, 2, 0, None))])
def test_edge_of_a_rank_on_a_1x4_mesh(rank, direction, want):
  """(send, to, recv, frm) of a rank's remote part: the first and last time
  shards have no neighbour on their open side."""
  from ddsp_torch.kernels import halo as kh  # pylint: disable=g-import-not-at-top
  edge = kh._edge(_ranks_mesh((1, 4), rank), direction)  # pylint: disable=protected-access
  assert (edge.send, edge.to, edge.recv, edge.frm) == want


def test_a_rank_holding_two_shards_sends_its_edge_shard():
  from ddsp_torch.kernels import halo as kh  # pylint: disable=g-import-not-at-top
  mesh = _ranks_mesh((1, 4), 0, per_rank=2)
  assert [mesh.shard_coords(j) for j in range(2)] == [(0, 0), (0, 1)]
  edge = kh._edge(mesh, +1)  # pylint: disable=protected-access
  assert (edge.send, edge.to, edge.recv, edge.frm) == (1, 1, 0, None)
  edge = kh._edge(mesh, -1)  # pylint: disable=protected-access
  assert (edge.send, edge.to, edge.recv, edge.frm) == (0, None, 1, 1)


def test_process_local_placement_on_a_2x2_mesh():
  """Rank 3 of a (2 x 2) mesh holds shard (1, 1): the second half of the
  global batch's rows and the second half of the samples."""
  from ddsp_torch.parallel import mesh as mesh_lib  # pylint: disable=g-import-not-at-top
  mesh = _ranks_mesh((2, 2), 3)
  assert mesh.first_shard == 3 and mesh.shard_coords(0) == (1, 1)
  x = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
  part = mesh_lib.shard_batch(mesh, {'audio': x, 'f0': x[:, :3]},
                              n_samples=8)
  np.testing.assert_array_equal(part['audio'], x[2:, 4:])
  np.testing.assert_array_equal(part['f0'], x[2:, :3])
  local = torch.from_numpy(part['audio'])
  assert mesh_lib.batch_is_sharded(mesh, 1)
  (shard,) = mesh_lib.split_time(mesh, local)
  assert torch.equal(shard, local)
  assert torch.equal(mesh_lib.concat_time(mesh, [shard], 2), local)
  assert torch.equal(mesh_lib.local_time(mesh, torch.from_numpy(x)),
                     torch.from_numpy(x[:, 4:]))
  with pytest.raises(ValueError, match='does not divide'):
    mesh_lib.local_rows(mesh, 3)


def test_a_rank_holds_shards_of_one_data_row():
  from ddsp_torch.parallel import distributed  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel.mesh import Mesh
  with pytest.raises(NotImplementedError, match='item 8'):
    Mesh(['cuda:0', 'cuda:1'], 1, 2, distributed.Ranks(0, 1, 1, 2))
  with pytest.raises(ValueError, match='needs 2 devices'):
    Mesh(['cpu'], 1, 4, distributed.Ranks(0, 2, 1, 4))


def test_row_draws_are_the_global_draw_cut_to_rows():
  """A rank's FilteredNoise draw is one process's draw for the global
  batch, cut to its rows; unbatched draws are the generator's own."""
  from ddsp_torch.proc.synths import RowDraws, uniform_noise  # pylint: disable=g-import-not-at-top
  full = uniform_noise((4, 16), 'cpu',
                       generator=torch.Generator().manual_seed(3))
  gen = RowDraws('cpu').manual_seed(3)
  gen.n_rows, gen.rows = 4, slice(2, 3)
  got = uniform_noise((1, 16), 'cpu', generator=gen, batched=True)
  assert torch.equal(got, full[2:3])
  alone = torch.Generator().manual_seed(3)
  gen.manual_seed(3)
  assert torch.equal(uniform_noise((1, 16), 'cpu', generator=gen),
                     uniform_noise((1, 16), 'cpu', generator=alone))
  with pytest.raises(ValueError, match='keeps rows'):
    uniform_noise((2, 16), 'cpu', generator=gen, batched=True)


def _whole_rows_mesh(rank):
  """Rank `rank` of a (4 x 2) mesh over two ranks: two whole rows each."""
  from ddsp_torch.parallel import distributed  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel.mesh import Mesh
  return Mesh(['cpu'] * 4, 4, 2, distributed.Ranks(rank, 2, 4, 2))


def test_process_local_placement_of_whole_rows():
  """Rank 1 of a (4 x 2) mesh over two ranks holds rows 2 and 3 of the
  mesh, every sample: a run of two whole rows."""
  from ddsp_torch.parallel import mesh as mesh_lib  # pylint: disable=g-import-not-at-top
  mesh = _whole_rows_mesh(1)
  run = mesh.run
  assert (list(run.rows), run.span, run.whole_rows) == ([2, 3], (0, 2), True)
  assert not mesh.ranks.shares_rows
  assert [mesh.shard_coords(j) for j in range(4)] == [
      (2, 0), (2, 1), (3, 0), (3, 1)]
  x = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
  part = mesh_lib.shard_batch(mesh, {'audio': x}, n_samples=6)['audio']
  np.testing.assert_array_equal(part, x[4:])
  assert mesh_lib.global_rows(mesh, 4) == (8, slice(4, 8))
  assert mesh_lib.time_span(mesh, 6) == slice(0, 6)
  shards = mesh_lib.split_time(mesh, torch.from_numpy(part))
  np.testing.assert_array_equal(shards[1].numpy(), x[4:6, 3:])
  np.testing.assert_array_equal(shards[2].numpy(), x[6:, :3])
  assert torch.equal(mesh_lib.concat_time(mesh, shards, 4),
                     torch.from_numpy(part))


@pytest.mark.parametrize('shape,per_rank', [((2, 2), 1), ((4, 2), 4),
                                            ((1, 4), 2)])
def test_assemble_and_own_block_are_inverse(shape, per_rank):
  """The global signal from every rank's time-local shards, and each
  rank's block back from it (shard_batch: its own block of the global
  batch); a value replicated over 'time' reads each row's first shard."""
  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel import distributed
  from ddsp_torch.parallel import mesh as mesh_lib
  n_data, n_time = shape
  n_ranks = n_data * n_time // per_rank
  x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
  shards, rows = [], []
  for r in range(n_ranks):
    mesh = _ranks_mesh(shape, r, per_rank)
    block = mesh_lib.shard_batch(mesh, {'x': x}, n_samples=12)['x']
    assert torch.equal(block, x[mesh_lib.local_rows(mesh, 8),
                                mesh_lib.time_span(mesh, 12)])
    shards += mesh_lib.split_time(mesh, block)
    rows += mesh_lib.split_batch(mesh, block)
  assert torch.equal(distributed.assemble(shards, n_data, n_time), x)
  replicated = distributed.assemble(rows, n_data, n_time, time_local=False)
  assert torch.equal(replicated, torch.cat(
      [rows[i] for i in range(0, n_data * n_time, n_time)]))
