#!/usr/bin/env python3
"""Drive the ddsp_torch port on one NVIDIA GPU: build, check, serve, train,
report.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py            # what the acceptance check runs
    python3 chip_smoke.py --profile  # also print per-kernel breakdowns
    python3 chip_smoke.py --prefetch-pairs 10  # only phase 6c's timing,
                                               # prefetch 0 against 2

Phases (any failed check exits non-zero before the result lines):
  1. build the kernels of ddsp_torch/csrc with nvcc (all sources at once);
  2. K1: the fused harmonic synth (K1f) and its backward kernels (K1t
     amplitude taps, K1p phase) against their plain PyTorch versions, both
     methods, hops 32, 64, 100, 128, 320 and 1280, B in {1, 2, 4, 16}, H in
     {13, 60, 100, 160, 256}, on wrapped (angular cumsum) and unwrapped
     (cumsum) phases; K1t's dham bit-equal across two launches, written
     without fold_taps or a [B, F, 2, H] tensor;
  2c. K3: the halo shift against its plain version, bit for bit, on (1, 4),
     (2, 4) and (1, 8) meshes of one card, both directions, values and
     gradients, at the main path's three blocks and the long-audio step's
     two; the local launch on the runs of the ranks that straddle a data
     row of a (3 x 4) mesh over four ranks (a run that starts inside a
     row), float32 and bf16, both directions; the (2 data x 2 time) row
     rule through the time-sharded fft_convolve;
  3. K2: the fused GRU sequence (K2f) and its backward (K2b) against their
     plain PyTorch versions, both dtypes, at H = 512, T = 1000 and B in
     {1, 4, 16, 40, 128} (a ragged tile, and past the old kernels' batch
     limit) and at H = 64, T = 24; bf16 at H = 512, T = 125 (the ae
     encoder's GRU), B in {1, 16}, and T = 250 (the inverse_synthesis
     RnnSandwich's GRU), B in {1, 16, 32}, and T = 7500 (the long-audio
     step's decoder, 30 s), B = 2; bf16 at H = 96 and 384 (the cluster
     kernels, zero-padded to 128 and 512) and 640, 768 and 1024 (the
     cooperative kernels), B in {1, 16, 40}, and float32 at H = 768 and
     1024, B = 16; the launches of each route; with bf16 streams K2b's two
     passes, the serial reverse-time kernel (cluster or cooperative) and the
     weight-gradient kernel, each against its own plain version; the
     clusters and the cooperative plans chosen; gradients through FastGRU
     and harmonic_synthesis on the card against the port on the CPU;
  3c. K2b's weight-gradient kernel (TMA + wgmma, split K over a cluster per
     output tile) against its plain version at H = 512, T = 1000, B in
     {1, 16, 40, 128}, at H = 64 and through the padded H = 96 and 384,
     with its plan and bit-equal repeats; K2f's step kernel (float32,
     T = 1, no exchange between CTAs) against its plain version at B in
     {1, 4, 40}
     and H in {64, 512, 1024} with a non-zero h0;
  3d. the JAX package's public surface on the card, through the flat names
     only: ddsp_torch.ops.harmonic_synthesis at the K1 phase's shapes
     (B = 16, 64000 samples, 1000 frames, 60 harmonics) against K1f's
     plain version, and a user's head on ddsp_torch.nn.OutputSplitsModule
     (FastGRU(512) in bf16 at B = 16, T = 1000, a Dense to
     solo_instrument's splits) against the same head on the plain
     recurrence; K1f and K2f once each, nothing else;
  4. serve 4 requests of 4 s through the full-width solo_instrument
     autoencoder (AutoencoderInference on a params-format export), check the
     audio, and check that K1f and K2f carried the path;
  4b. VST streaming: the full-width vst preset from its own params-format
     export, 250 hops (5 s) of a 440 Hz tone through VSTExtractFeatures ->
     VSTStatelessPredictControls -> VSTSynthesize with the state and the
     phase carried on the card; check every hop, the state, VSTPredictControls
     and reset() bit for bit, the launches (K2f once a hop on its step
     kernel, no other kernel), the phase carry against one synthesis of the
     whole span, the stream against the port on the CPU, and the whole-clip
     forward (K2f once on its bf16 route); print per-hop latency against the
     20 ms hop period and K2f's one-hop entry (GRUCell and the cooperative
     route beside it);
  4c. CREPE (ops/crepe.py) on 1000 frames with TF32 turned on for the
     process around the call, against the port on the CPU (CREPE pins full
     float32 itself); then the vst preset streamed with its own f0: 250
     hops of a 440 Hz tone through VSTExtractFeatures() (CREPE on) ->
     VSTStatelessPredictControls -> VSTSynthesize; check f0 within 20 cents
     of 440 Hz, the features against the CPU port hop for hop, K2f once a
     hop; print the hop's latency, the extract stage's and CREPE's device
     ms;
  4d. export phase 4's model as a torch.export program
     (export_model(fmt='torch_export'), autoencoder.pt2) on the card, load
     it (load_program) and serve phase 4's four requests through it: one
     harmonic_fwd and one gru_fwd node in its graph, K1f and K2f once a
     request inside the program and no backward kernel, the audio against
     the eager class on the card (the same baked noise) and against the
     CPU port; time the program's request beside the eager one in turns,
     and the ops' dispatch beside the launch functions called directly;
  4e. the six VST programs of phase 4b's export, exported on the card and
     loaded; the tone streamed for 250 hops through vst_extract_features
     (CREPE) -> vst_stateless_predict_controls -> vst_synthesize against
     the eager classes (controls, state, f0, audio), K2f once a hop on its
     step kernel inside the predict program; vst_predict_controls,
     vst_synthesize_harmonic and vst_synthesize_noise against theirs; the
     extract program with TF32 on for the process (its full-float32 pin);
     per-hop time of the programs beside the eager classes in turns;
  5. the synthesis chain (Harmonic + FilteredNoise + Add + Reverb, batch 16,
     4 s) forward and gradient with respect to every control, f0 included:
     the path of K1p;
  6. train full-width solo_instrument (bf16, loudness from the audio) on a
     synthetic batch of 16 x 4 s through Trainer and train(); check the
     losses, the gradients, the kernels' launch counts, a step against the
     port on the CPU (the reverb IR's gradient too: check_ir_gradient), and
     a checkpoint round trip;
  6c. train the same model from a TFRecord dataset: 48 examples of 4 s
     written in 3 shards by the port's writer (the native codec's CRC
     against the pure-Python one), 12 steps of train() from
     TFRecordProvider through the pinned-memory prefetch; check the
     batches bit for bit against the host provider, on the card in
     float32, the launches per step, that train() closed the prefetch
     and started no thread, and the losses against prefetch=0; time train() steps with prefetch 0 and 2 in
     turns, from the records and from one repeated batch; export the
     checkpoint (export_model), serve a 4 s request from it through K1f
     and K2f against the train directory on the CPU, and check the
     impulse-response wav against the trained reverb IR;
  6d. evaluate_or_sample of that checkpoint at batch 4, 4 batches of 4 s,
     BasicEvaluator and F0LdEvaluator on CREPE with Viterbi: 'eval' on the
     card against the same evaluation by the CPU port (the scalars; the
     first batch's audio and its loss's mag term), K1f and K2f once a
     batch, then 'sample' (the wavs); print ms per eval batch and the
     shares of CREPE's network and the Viterbi decode;
  6f. the CLI in this process (ddsp_torch.run.main, ddsp-torch-run) on
     phase 6c's records: --mode train (full-width solo_instrument, batch
     16, 4 steps: K1f, K1t, K2f, K2b and its weight-gradient pass each
     step; metrics.jsonl and the checkpoint), --mode eval --run_once and
     --mode sample (one batch through K1f and K2f each), then the train
     directory exported with fmt='torch_export' and one request served
     through the program; then --preset ae: 2 steps (K1f, K1t once, K2f,
     K2b and its weight-gradient pass twice a step) and --mode eval
     --run_once (K1f once, K2f twice); its torch_export skipped, the
     refusal printed;
  6g. the ae preset at full width (MFCC-RNN encoder over 125 frames, z of
     16, 100 harmonics, bf16), one state dict from torch.Generator(0) on
     the card and on the CPU: 4 reconstruction requests of 4 s at B = 1
     through the model's forward (audio in, an explicit noise) against
     the CPU port, K1f once and K2f twice a request and no backward
     kernel, ms per request; train() 24 steps at batch 16 x 4 s (finite
     losses; K1f, K1t once, K2f, K2b, K2b's weight-gradient pass twice a
     step), a B = 2 step against the CPU port with gradients reaching the
     encoder, ms per step; evaluate_or_sample of the checkpoint, one eval
     and one sample batch; AutoencoderInference and export_model refuse
     the directory;
  6i. the midiae preset at full width (dilated-conv synthcoder, MIDI
     encoder and decoder, 60 harmonics, a trainable FilteredNoiseReverb),
     float32 with cuDNN's TF32 on for the process (the stacks pin full
     float32), one state dict from torch.Generator(0) on the card and on
     the CPU: 4 MIDI requests of 4 s (seeded note sequences through
     midi_to_audio: K1f once) and 4 reconstruction requests (the forward on
     phase 6's tones: K1f twice, q_pitch equal to the CPU port's but at
     ties) against the CPU port, ms per request; 24 Trainer.train_steps at
     16 x 4 s with a piano roll from the tones' f0 (K1f twice, K1t once a
     step), step ms beside phase 6's, a B = 2 step against the CPU port
     (the loss; the MIDI encoder's and decoder's gradients; the
     synthcoder's and the reverb's with the mag term alone);
     evaluate_or_sample of the checkpoint with MidiAutoencoderEvaluator and
     MidiHeuristicEvaluator, the predicted note sequences against the CPU
     port's, and one sample batch; ddsp-torch-run --preset midiae, 2 steps
     and an eval; the serving classes refuse the directory;
  6j. the inverse_synthesis preset at full width (a ResNet sinusoidal
     encoder over 250 log-mel frames, 100 sinusoids, an RnnSandwich's GRU
     of 512 over the 250 frames, 100 harmonics), full float32 pinned for
     the process, one state dict from torch.Generator(0) on the card and on
     the CPU: 4 requests of 4 s at B = 1 on phase 6's tones (K2f once),
     their controls against the CPU port and each level's audio against the
     CPU port's synthesis of the card's controls (the audio against the CPU
     port's own printed), ms per request; 24 Trainer.train_steps at
     16 x 4 s on each of three feeds (phase 6's tones; synthetic notes at
     250 frames; both zipped, 32 rows), K2f, K2b and its weight-gradient
     pass once a step, median ms, peak memory, the ratio to phase 6's step;
     a zipped step of 2 + 2 rows against the CPU port (every loss term; the
     encoders' gradients with the mag term alone); evaluate_or_sample of
     the self-supervised checkpoint with the default evaluators
     (BasicEvaluator, TWMEvaluator), the TWM f0 on the card against the
     CPU; ddsp-torch-run --preset inverse_synthesis --data synthetic_notes,
     2 steps and an eval; the serving classes refuse the directory;
  6h. the processors without a TPU kernel (TensorToAudio, Wavetable,
     Sinusoidal, ExpDecayReverb, FIRFilter, ModDelay, Mix) at batch 4 x
     4 s, forward and gradient on the card against the CPU port, no kernel
     launched;
  6e. prepare_records of a 20 s wav of harmonic glides on the card (CREPE
     with Viterbi, loudness) into 2 shards, read back with
     TFRecordProvider, against the CPU port's prepare_records of the same
     file; print the seconds of audio prepared per second;
  6a. one B = 2 training step at rnn_channels 384 and 1024 against the port
     on the CPU, with the launches of each GRU route;
  6l. the training step of full-width solo_instrument at 16 x 4 s through
     Trainer.train_step at compute_dtype='float32' and at rnn_channels=1024
     (bf16), both on the cooperative K2 kernels: median ms of 12 steps
     after 3, launches per step, beside phase 6's bf16 step (device busy
     under --profile);
  6b. train the same model sequence-parallel: Trainer on a (1 data x 4 time)
     mesh whose shards share the card, halo_impl='pallas'; check the losses,
     the kernels' launches per step (K3 as counted from the code, K1 none),
     the first step against the dense step, the sharded loss against the
     dense SpectralLoss, and a step against the same SP step on the CPU
     (the reverb IR's gradient too, and against the dense step); the
     trained state is saved for 6k;
  6k. long audio on one card: parallel.make_sp_train_step with
     solo_instrument's decoder and torch.optim.Adam on the long-audio
     example's target at 30 s, B = 2, on a (1 x 4) mesh of the card (K2f,
     K2b at T = 7500, K3): the mag term's decoder gradient and the first
     loss against the dense pipeline on the card, the first loss against
     the CPU port at 2 s, the loss falling, the launches per step, ms per
     step and peak memory; evaluate_or_sample of 6b's checkpoint on its
     mesh ('eval': the scalars and the mag term against the dense eval,
     K2f once and K3 per batch; 'sample': the dense run's files), ms per
     eval batch beside the dense one; a ProcessorGroup with FIRFilter on
     the mesh against the dense group (K3 only);
  6m. four torch.distributed ranks on the one card (gloo: NCCL refuses two
     ranks on one card), spawned processes on cuda:0: (a) K3's remote copy
     (CUDA IPC slots, csrc/halo.cu ddsp_halo_remote) first in this process
     as a loopback (its own slot as its neighbour) at the long-audio
     step's blocks, bit for bit against the block, timed by windows of
     CUDA events (queued: the card's own time; and as the host issues
     them); then on the ranks against its torch.distributed plain
     version, both directions, values and adjoints bit for bit, one
     remote launch each way, and ms per shift by windows of the kernels
     and the plain version; last, after (b)-(j), a fault
     drill in ranks of its own (one rank makes a call the others do not;
     one rank never sends): every rank raises naming a call within its
     deadline and every process ends; (b) the dense Trainer step of
     full-width solo_instrument on a (4 x 1) mesh of the ranks, 4 of phase
     6's 16 rows each, 3 steps against the one-process step on the 16
     rows (the loss and the reduced gradient norm of the first step, the
     later losses),
     the parameters bit for bit equal across ranks, K1f, K1t, K2f and K2b
     once a step on every rank; (c) make_sp_train_step at 30 s x B = 2 on
     a (1 x 4) mesh of the ranks against phase 6k's one-process steps, the
     remote copy launched 22 times a step on every rank and the local
     shift none; ms per step and per shift, labelled as four ranks
     time-sliced on one card; (d) phase 6b's checkpoint evaluated on a
     (1 x 4) mesh of the ranks against phase 6k's one-process SP eval (the
     scalars, the audio gathered on rank 0, K2f once and the remote copy as
     counted from the code a batch, no local K3, only rank 0 writing) and
     sampled on one batch (rank 0 writes phase 6k's files); (e) the same
     checkpoint on a (4 x 1) mesh against phase 6k's dense eval (K1f and
     K2f once a batch on every rank); (f) the vst preset at full width
     (bf16, 3.9 s: see RANKS_VST_SECONDS) for 3 Trainer steps at B = 4 on a
     (1 x 4) mesh of the ranks against one step of the same mesh in one
     process (the first loss, the decoder's gradient norm, K2f, K2b and the
     remote copy a step, the Crop's signal gathered and sliced); (g) one
     step of solo_instrument with an L2 SpectralLoss on a (1 x 4) mesh of
     the ranks against one process; (h) one SP Trainer step on a (4 x 2)
     mesh over two ranks, two whole rows each, against one process (the
     local K3 only); (i) make_sp_train_step at 30 s x B = 3 on a (3 x 4)
     mesh of the four ranks, three shards a rank, so that ranks 1 and 2
     straddle a data row, for 3 steps against one process's (3 x 4) mesh
     (the first loss and the decoder's gradient norm, the losses and the
     parameters equal on every rank, K2f and K2b once and the local shift
     and the remote copy each as counted from the code a step, ms per
     step and peak memory a rank); (j) phase 6b's checkpoint evaluated on
     that mesh of ranks against one process's eval on it; ms per eval
     batch and per vst step a rank; a failed rank fails the phase;
  7. report per-request and per-step times, the kernels line and the device
     line.

Exits 1 without a CUDA device or outside a checkout of the repository.
"""

import argparse
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9  # each way, to another card of the host
PEAK_FLOPS = {'float32': 67e12, 'bfloat16': 989e12}

SR = 16000
N_FRAMES = 1000       # 4 s at 250 frames/s
N_SAMPLES = 64000     # 4 s at 16 kHz
N_HARMONICS = 60
HIDDEN = 512
BATCH = 16            # the training and chain batch
N_NOISE = 65
REVERB_LENGTH = 48000
TRAIN_STEPS = 24
# The ae preset (phase 6g): its encoder's GRU runs over 125 MFCC frames,
# its Harmonic has 100 harmonics.
AE_Z_STEPS = 125
AE_HARMONICS = 100
# The inverse_synthesis preset (phase 6j): its RnnSandwich's GRU runs over
# the encoder's log-mel frames at 4 s (hop 256).
INV_FRAMES = 250
# The long-audio step (phase 6k): 30 s at 250 frames/s, B = 2.
LONG_SECONDS = 30
LONG_FRAMES = LONG_SECONDS * 250
LONG_BATCH = 2
# K1f sums up to 60 harmonics whose sines come from the Chebyshev recurrence
# against the plain version's sinf of h * phase (the JAX package's tolerance
# for its Pallas kernel against its jnp path).
K1_ATOL = 4e-3
# K1t, K1p: the same recurrence against sinf/cosf, then sums of 64..320
# samples (taps) or 60 harmonics weighted by h (phase) in another order;
# relative to the largest element of the plain result.
K1_BWD_RTOL = 2e-3
# K1_ATOL is set on 60 harmonics. The float32 chain drifts by up to
# ~h * 6e-8 / |sin phi| rad in harmonic h (cos phi rounded to float32), so
# its absolute error grows ~h^2 while the cases' unnormalized amplitudes
# (~0.25 a harmonic) grow the audio ~H: past the Pallas kernel's 128 lanes
# K1f is held, as K1t and K1p are, to K1_BWD_RTOL relative to the largest
# plain element (tests/test_torch_harmonic_tiles.py runs the float32 chain
# on the CPU at H = 60, 160 and 256 and prints both errors).
K1_WIDE_HARMONICS = 128
# K2f: float32 differs by summation order only; bf16 rounds h and wh.
K2_ATOL = {'float32': 1e-4, 'bfloat16': 5e-2}
# K2b, relative to the largest element of each plain result: float32 is
# summation order over 1000 steps; in bf16 dxp and dhp are rounded to bf16
# (3 significant digits) where the two versions' float32 values differ in
# the last bits.
K2_BWD_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
# K2b's weight-gradient pass against its plain version (one float32
# matmul) on the same bf16 streams: exact products, float32 sums of up to
# T * B = 128000 rows in another order (the kernel adds 16 rows at a time
# in wgmma's chains over each K slice, then the slices in order); 3.7e-5
# at B = 128 on an H100.
K2_WGRAD_RTOL = 1e-3
E2E_REL_L2 = 5e-2
# One training step on the card against the port on the CPU (plain
# versions), B = 2: bf16 activations round at the same places, the kernels
# sum in another order, and the logmag term amplifies both.
STEP_LOSS_RTOL = 5e-3
STEP_GRAD_NORM_RTOL = 5e-2
# Sequence-parallel training (phase 6b): a (1 data x 4 time) mesh on the
# card, 2 warm-up steps and 8 measured ones.
SP_MESH = (1, 4)
SP_WARMUP, SP_STEPS = 2, 8
# A mesh whose runs straddle data rows over phase 6m's four ranks: three
# shards a rank, so ranks 1 and 2 each hold the tail of one row and the
# head of the next; one row of the batch a data row.
STRADDLE_MESH = (3, 4)
STRADDLE_BATCH = 3
# The first SP step against the dense step at the same parameters and
# noise (the JAX package's tier, tests/test_sp_model.py:84-85): the shards'
# phase carries and the logmag term's 1/|bin| in near-silent bins.
SP_DENSE_RTOL = 0.1
# The sharded mag-only loss against a float32 SpectralLoss on the gathered
# audio: the same FFTs of the same frames, summed per shard and then over
# shards; two float32 sums of ~10^6 terms in another order (the JAX package
# holds its CPU version to 2e-5).
SP_MAG_LOSS_RTOL = 1e-4
# The reverb IR's gradient in the B = 2 checks of phases 6 and 6b. With the
# full loss it is conditioned by the logmag term, so it is printed and not
# held: the logmag term's gradient is 1/|X| per STFT bin, the audio has
# bins near 1e-6 (DC bins of frames whose mean crosses zero) against a
# median of ~2e-3, and those few bins carry the IR gradient: on one and the
# same dry signal the two devices' float32 FFT rounding alone moves it by
# 1.6e-2 (H100). (Before ops/oscillator.py's phase_cumsum, the card's
# float32 cumsum also left the training phase 0.165 rad off at 4 s against
# the CPU's 2.4e-4, which moved the harmonic audio by half its norm.)
IR_NAME = 'processor_group.reverb.ir'
NOISE_PERTURBATION = 1e-6
# Held, relative L2:
# - the whole step with the mag term only, GPU against the CPU port, and
#   (SP) against the dense step on the card: the two forwards' float32
#   rounding and the SP shards' own phase sums move the audio by ~1e-3,
#   and L1 signs flip where two magnitudes meet (SP against dense on the
#   CPU: 8.9e-3);
IR_MAG_STEP_RTOL = 2e-2
# - on the dry signal of the CPU port (its `add` output), where the card
#   computes the reverb, the loss and their backward from the same input:
#   the mag term's IR gradient (float32 FFT rounding; measured 5e-7 on an
#   H100), and with all terms the reverb on the card (dense, or
#   time-sharded through K3) pulling the CPU's loss cotangent back to the
#   IR (a linear map; 8e-6) and the loss itself (two float32 sums of ~10^6
#   terms in another order; 2e-7).
IR_MAG_RTOL = 1e-3
IR_PULLBACK_RTOL = 1e-4
IR_CHAIN_LOSS_RTOL = 1e-4


class CheckFailed(Exception):
  pass


def check(cond, what):
  if not cond:
    raise CheckFailed(what)
  print(f'  ok: {what}', flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
  """Mean milliseconds per fn() call between CUDA events, host work included
  (a call that launches less device work than its host overhead measures
  the host)."""
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def device_rows(prof):
  """(device ms, count, name) of every device activity in a profile."""
  from torch.autograd import DeviceType
  rows = [(e.self_device_time_total / 1e3, e.count, e.key)
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
  return sorted(rows, reverse=True)


def device_ms(torch, fn, iters, warmup=2):
  """Mean device milliseconds per fn() call: the summed time of the kernels,
  copies and fills it launched (torch.profiler), without host overhead.

  A profiler session now and then comes back without any device activity;
  it is repeated, and after three empty sessions the calls are timed
  between CUDA events instead (which adds the launch spacing to kernels
  shorter than it), with a note."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(warmup):
    fn()
  for _ in range(3):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(iters):
        fn()
      torch.cuda.synchronize()
    rows = device_rows(prof)
    if rows:
      return sum(r[0] for r in rows) / iters
    print('  note: torch.profiler recorded no device time; repeating',
          flush=True)
  print('  note: three empty profiler sessions; timing with CUDA events',
        flush=True)
  return cuda_ms(torch, fn, iters, warmup=0)


def kernel_ms(torch, fn, iters, name, before=None):
  """Mean device ms per fn() of the kernels whose name holds `name`
  (torch.profiler); `before()` runs ahead of each call, uncounted. None
  after three sessions without such a kernel."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  for _ in range(3):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      for _ in range(iters):
        if before is not None:
          before()
        fn()
      torch.cuda.synchronize()
    rows = [r for r in device_rows(prof) if name in r[2]]
    if rows:
      return sum(r[0] for r in rows) / iters
    print(f'  note: no {name} kernel in the profile; repeating', flush=True)
  return None


def k1_inputs(torch, batch, n_frames, seed, dev, n_harmonics=N_HARMONICS,
              kind='angular', f0_lo=80.0):
  """phase0, f0_env [B, N] and ham [B, F, H] as the synth's factored path
  builds them; f0 spans f0_lo to 20 f0_lo Hz (80-1600 by default) so the
  Nyquist mask cuts harmonics.
  kind 'angular' accumulates the phase as serving does (angular_cumsum,
  wrapped to a few radians); 'cumsum' as the training step does
  (presets.py: use_angular_cumsum=False), up to ~2e4 rad at 4 s."""
  from ddsp_torch.ops.oscillator import angular_cumsum
  from ddsp_torch.ops.resample import resample
  g = torch.Generator(dev).manual_seed(seed)
  f0 = f0_lo * 20.0**torch.rand((batch, n_frames, 1), generator=g,
                                device=dev)
  ham = (torch.rand((batch, n_frames, 1), generator=g, device=dev) *
         torch.rand((batch, n_frames, n_harmonics), generator=g, device=dev))
  f0_env = resample(f0, N_SAMPLES)
  omega = f0_env * 2 * np.pi / SR
  phase0 = (angular_cumsum(omega) if kind == 'angular' else
            torch.cumsum(omega, dim=1))
  return phase0[..., 0].contiguous(), f0_env[..., 0].contiguous(), ham


def wrapped64(torch, phase0):
  """phase0 mod 2 pi, taken in float64 and rounded once.

  The plain forward takes sin(h * phase) of the phase it is given, as the
  JAX package's jnp path does; at ~1e4 rad the float32 product h * phase
  alone is off by up to ~0.03 rad at h = 60, more than K1_ATOL allows. The
  kernels wrap the phase first. On unwrapped phases K1f is therefore held
  against the plain forward fed this phase, which holds the kernel's own
  error and not the plain version's."""
  return torch.remainder(phase0.double(), 2 * np.pi).float()


def bound(n_bytes, ops, dtype_name):
  """(least ms, 'bytes' or 'operations') for work of n_bytes moved once and
  ops operations at the card's peak rate for dtype_name."""
  t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype_name]
  return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def k1_bound(torch, kernel, f0_env, ham):
  """Least time for a K1 kernel's work on these inputs.

  Bytes: the [B, N] float32 streams it reads and writes (fwd: phase, f0 in,
  audio out; taps: phase, f0, g in; phase: phase, f0, g in, dphase out) plus
  the frame array it reads (fwd, phase) or writes (taps: dham [B, F, H],
  folded inside the kernel). Operations per sample per harmonic below
  Nyquist (the kernels stop at the first muted harmonic, so count this
  data's share): recurrence 2, mask 1, two taps' FMAs 4 (fwd and taps: 6,
  counting the mask and one FMA as one each with the recurrence's two),
  plus the multiply by h for the phase kernel (8).
  """
  n = f0_env.numel()
  batch, n_frames, n_harmonics = ham.shape
  streams = {'fwd': 3, 'bwd_taps': 3, 'bwd_phase': 4}[kernel]
  n_bytes = 4 * (streams * n + ham.numel())
  hmax = (SR / 2.0) / torch.clamp(f0_env, min=1e-20)
  active = torch.clamp(torch.ceil(hmax) - 1, 0, n_harmonics).sum().item()
  ops = (8.0 if kernel == 'bwd_phase' else 6.0) * active
  return bound(n_bytes, ops, 'float32')


def k1_issue_floor_ms(torch, f0_env, ham, instructions):
  """Least time to issue `instructions` fp32 instructions per audible
  sample-harmonic of these inputs on the card's CUDA cores: 128 lanes per
  SM at its maximum SM clock (nvidia-smi clocks.max.sm)."""
  n_harmonics = ham.shape[-1]
  hmax = (SR / 2.0) / torch.clamp(f0_env, min=1e-20)
  active = torch.clamp(torch.ceil(hmax) - 1, 0, n_harmonics).sum().item()
  mhz = float(subprocess.run(
      ['nvidia-smi', '--query-gpu=clocks.max.sm',
       '--format=csv,noheader,nounits'],
      capture_output=True, text=True, check=True).stdout.split()[0])
  sms = torch.cuda.get_device_properties(f0_env.device).multi_processor_count
  return 1e3 * instructions * active / (sms * 128 * mhz * 1e6)


def k2_inputs(torch, batch, dtype, seed, dev, hidden=HIDDEN,
              seq_len=N_FRAMES):
  g = torch.Generator(dev).manual_seed(seed)
  xp = 0.5 * torch.randn((seq_len, batch, 3 * hidden), generator=g,
                         device=dev)
  wh = torch.randn((hidden, 3 * hidden), generator=g, device=dev) / np.sqrt(
      hidden)
  bn = 0.1 * torch.randn((hidden,), generator=g, device=dev)
  h0 = 0.1 * torch.randn((batch, hidden), generator=g, device=dev)
  return xp.to(dtype), wh.to(dtype), bn, h0


def k2_bound(xp, wh, dtype_name, part='fwd'):
  """Least time for a K2 kernel's work: bytes vs operations at the peak
  rate of the operands' type.

  'fwd': xp, wh, bn, h0 in, ys out; one recurrent product and ~12 gate
  operations per unit per step. 'serial' (K2b's reverse-time pass): g, xp,
  h_prev, wh, bn in, dxp, the dhn stream, dh0 and the tiles' dbn out; two
  products per step (the recomputed h @ wh and dhp @ wh^T) and ~30 gate
  operations per unit. 'wgrad' (its weight-gradient pass): h_prev, two
  thirds of dxp, dhn and the tiles' dbn in, dwh and dbn out; h^T dhp over
  T * B rows.
  """
  seq_len, batch, three_h = xp.shape
  hidden = three_h // 3
  item = xp.element_size()
  rows = seq_len * batch
  weights = wh.numel() * wh.element_size()
  small = 4 * (hidden + batch * hidden)
  tiles = 4 * hidden * -(-batch // 16)
  if part == 'serial':
    n_bytes = (rows * (4 * hidden + 2 * three_h * item + 2 * hidden * item) +
               weights + 2 * small + tiles)
    ops = rows * (2 * 2.0 * hidden * three_h + 30.0 * hidden)
  elif part == 'wgrad':
    n_bytes = (rows * item * (hidden + 2 * hidden + hidden) + tiles +
               4 * (wh.numel() + hidden))
    ops = rows * 2.0 * hidden * three_h
  else:
    n_bytes = (xp.numel() * item + weights + small + 4 * rows * hidden)
    ops = rows * (2.0 * hidden * three_h + 12.0 * hidden)
  return bound(n_bytes, ops, dtype_name)


def phase_build():
  from ddsp_torch.kernels import _build
  print('[1] build', flush=True)
  t0 = time.time()
  built = _build.build(['harmonic', 'gru', 'halo'])
  seconds = time.time() - t0
  for name, (path, log) in built.items():
    print(f'  {name}: {path}')
    for line in log.splitlines():
      if any(k in line for k in ('entry function', 'registers', 'spill',
                                 'smem')):
        print(f'    {line.strip()}')
  print(f'  build seconds: {seconds:.1f}', flush=True)


def rel_err(out, ref):
  """max |out - ref| over the largest |ref|."""
  return ((out.float() - ref.float()).abs().max() /
          ref.float().abs().max().clamp(min=1e-30)).item()


def k1_backward(torch, phase0, f0_env, ham, g, method):
  """(dham, dphase) from the kernels and from the plain versions."""
  from ddsp_torch.kernels import harmonic as kh
  p = phase0.detach().requires_grad_()
  a = ham.detach().requires_grad_()
  out = kh.fused_harmonic_synthesis(p, f0_env, a, SR, method)
  dphase, dham = torch.autograd.grad(out, (p, a), g)
  n_frames, n_harmonics = ham.shape[1:]
  ref_dham = kh.fold_taps(kh.harmonic_bwd_taps_plain(
      phase0, f0_env, g, n_frames, n_harmonics, SR, method))
  ref_dphase = kh.harmonic_bwd_phase_plain(phase0, f0_env, ham, g, SR, method)
  return dham, dphase, ref_dham, ref_dphase


def k1_case(torch, dev, method, n_frames, batch, n_harmonics, kind, seed=1,
            f0_lo=80.0):
  """One K1 case: each kernel against its plain version; returns
  (inputs, g, errors) after checking the tolerances. errors: 'K1f' max
  |err|; 'K1t', 'K1p' relative to the largest plain element, and the same
  keys + ' abs' max |err|."""
  from ddsp_torch.kernels import harmonic as kh
  hop = N_SAMPLES // n_frames
  what = f'{method} hop {hop} B={batch} H={n_harmonics} {kind}'
  phase0, f0_env, ham = k1_inputs(torch, batch, n_frames, seed, dev,
                                  n_harmonics, kind, f0_lo)
  out = kh.fused_harmonic_synthesis(phase0, f0_env, ham, SR, method)
  ref_phase = phase0 if kind == 'angular' else wrapped64(torch, phase0)
  ref = kh.harmonic_synthesis_plain(ref_phase, f0_env, ham, SR, method)
  torch.cuda.synchronize()
  errs = {'K1f': (out - ref).abs().max().item(),
          'K1f rel': rel_err(out, ref)}
  if n_harmonics <= K1_WIDE_HARMONICS:
    check(torch.isfinite(out).all().item() and errs['K1f'] <= K1_ATOL,
          f'K1f {what}: max |err| {errs["K1f"]:.3e} within {K1_ATOL}')
  else:
    check(torch.isfinite(out).all().item() and
          errs['K1f rel'] <= K1_BWD_RTOL,
          f'K1f {what}: relative max err {errs["K1f rel"]:.3e} within '
          f'{K1_BWD_RTOL} (max |err| {errs["K1f"]:.3e})')
  g = torch.randn(phase0.shape, device=dev,
                  generator=torch.Generator(dev).manual_seed(7))
  dham, dphase, ref_dham, ref_dphase = k1_backward(torch, phase0, f0_env,
                                                   ham, g, method)
  torch.cuda.synchronize()
  for name, got, want in (('K1t dham', dham, ref_dham),
                          ('K1p dphase', dphase, ref_dphase)):
    errs[name[:3]] = rel_err(got, want)
    errs[name[:3] + ' abs'] = (got - want).abs().max().item()
    check(torch.isfinite(got).all().item() and
          errs[name[:3]] <= K1_BWD_RTOL,
          f'{name} {what}: relative max err {errs[name[:3]]:.3e} within '
          f'{K1_BWD_RTOL}')
  return (phase0, f0_env, ham), g, errs


def phase_k1(torch, dev):
  from ddsp_torch.kernels import harmonic as kh
  print('[2] K1 fused harmonic synth vs plain: forward, taps and phase '
        'backward', flush=True)
  # Hop 64 is the serving and training shape, 320 the VST hop, 100 a hop
  # that K1t's 8-sample tile does not divide (and the Pallas kernel does
  # not take); 32 and 128 bracket 64. B = 1 and H = 13 (not a multiple of
  # K1f's float4 of harmonics) are the edges.
  for method in ('window', 'linear'):
    for hop in (64, 320, 100):
      for batch, n_harmonics in ((4, N_HARMONICS), (1, 13)):
        k1_case(torch, dev, method, N_SAMPLES // hop, batch, n_harmonics,
                'angular')
      k1_case(torch, dev, method, N_SAMPLES // hop, 4, N_HARMONICS,
              'cumsum')
  for method, hop in (('window', 32), ('linear', 128)):
    k1_case(torch, dev, method, N_SAMPLES // hop, 4, N_HARMONICS, 'angular')
  # A hop over 1024 samples: K1t adds a second pass into the same partials.
  for method in ('window', 'linear'):
    k1_case(torch, dev, method, N_SAMPLES // 1280, 4, N_HARMONICS, 'cumsum')
  # More than 128 harmonics, f0 from 30 Hz so that harmonics past 128 are
  # audible: at hop 64 in one K1t block, at hop 100 (13 threads a hop, 128
  # partial rows) more than the card's shared memory holds in one, so K1t
  # splits them over the grid.
  for method, hop, n_harmonics in (('window', 64, 160), ('linear', 100, 256)):
    k1_case(torch, dev, method, N_SAMPLES // hop, 2, n_harmonics, 'cumsum',
            f0_lo=30.0)
  # The ae preset's 100 harmonics at hop 64, a request's B = 1 and a
  # step's B = 16, on the plain cumsum phases it serves and trains on.
  for batch in (1, BATCH):
    k1_case(torch, dev, 'window', N_FRAMES, batch, AE_HARMONICS, 'cumsum')

  # K1t folds the taps inside the kernel, in a fixed order: two launches
  # give the same bits, and the CUDA backward neither calls fold_taps nor
  # holds a [B, F, 2, H] tensor.
  (phase0, f0_env, ham), g, _ = k1_case(torch, dev, 'window', N_FRAMES,
                                        BATCH, N_HARMONICS, 'cumsum', seed=3)
  shape = (N_FRAMES, N_HARMONICS, SR, 'window')
  first = kh._launch('bwd_taps', (phase0, f0_env, g), torch.empty_like(ham),
                     *shape)
  second = kh._launch('bwd_taps', (phase0, f0_env, g), torch.empty_like(ham),
                      *shape)
  torch.cuda.synchronize()
  check(torch.equal(first, second), 'K1t: two launches give bit-equal dham')
  folds = []
  fold = kh.fold_taps
  kh.fold_taps = lambda dtaps: folds.append(1) or fold(dtaps)
  try:
    a = ham.detach().requires_grad_()
    out = kh.fused_harmonic_synthesis(phase0, f0_env, a, SR)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (dham,) = torch.autograd.grad(out, (a,), g)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
  finally:
    kh.fold_taps = fold
  two_taps = 2 * ham.numel() * 4
  print(f'  K1t backward at [{BATCH}, {N_FRAMES}, {N_HARMONICS}]: peak '
        f'device memory grew {grown} B (dham {ham.numel() * 4} B, a [B, F, '
        f'2, H] tensor {two_taps} B); fold_taps calls {len(folds)}')
  check(not folds and tuple(dham.shape) == tuple(ham.shape) and
        grown < two_taps and torch.equal(dham, first),
        'K1t on CUDA writes dham itself: no fold_taps, no [B, F, 2, H] '
        'tensor, the same bits as the direct launch')


def k3_blocks(torch, n_shards, dtype, dev, seed):
  """The main path's K3 blocks per shard, as (name, leaves, shards,
  embed): the reverb's tail carry [16, 64000]; the STFT halo, a strided
  [16, 2047] view of a [16, 16000] shard; the delta-time boundary frame, slot
  31 of [16, 32, 1025] magnitudes; and the long-audio step's (phase 6k,
  B = 2, 30 s over 4 shards): the noise filter's tail carry [2, 120000] and
  the STFT halo, a [2, 2047] view of a [2, 120000] shard. embed(adj) puts a
  block's cotangent where its leaf holds the block."""
  gen = torch.Generator(dev).manual_seed(seed)
  rand = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(dtype)

  def zeros_but(leaf, where):
    def embed(adj):
      out = torch.zeros_like(leaf)
      out[where] = adj
      return out
    return embed

  carry = [rand(BATCH, 4 * SR).requires_grad_() for _ in range(n_shards)]
  audio = [rand(BATCH, SR).requires_grad_() for _ in range(n_shards)]
  mags = [rand(BATCH, 32, 1025).requires_grad_() for _ in range(n_shards)]
  long_t = LONG_FRAMES * (SR // 250) // 4
  long_carry = [rand(LONG_BATCH, long_t).requires_grad_()
                for _ in range(n_shards)]
  long_audio = [rand(LONG_BATCH, long_t).requires_grad_()
                for _ in range(n_shards)]
  halo_cols = (slice(None), slice(0, 2047))
  slot = (slice(None), slice(31, 32))
  return [('reverb carry', carry, carry, lambda adj: adj),
          ('STFT halo view', audio, [a[halo_cols] for a in audio],
           zeros_but(audio[0], halo_cols)),
          ('boundary frame', mags, [m[slot] for m in mags],
           zeros_but(mags[0], slot)),
          ('long-audio noise carry', long_carry, long_carry,
           lambda adj: adj),
          ('long-audio STFT halo view', long_audio,
           [a[halo_cols] for a in long_audio],
           zeros_but(long_audio[0], halo_cols))]


def phase_k3(torch, dev):
  """K3 against its plain version on meshes of one card: the results and
  the gradients (the adjoint shift) must be equal bit for bit, a copy has
  no rounding; the boundary shards get zeros. Then the data-row rule
  through the whole time-sharded fft_convolve on a (2 x 2) mesh."""
  from ddsp_torch.kernels import halo as kk
  from ddsp_torch.ops.fftconv import fft_convolve
  from ddsp_torch.parallel import create_mesh, halo, time_shard
  from ddsp_torch.parallel.distributed import Run
  print('[2c] K3 halo shift vs plain: meshes (1, 4), (2, 4), (1, 8), both '
        'directions, values and gradients; the runs of the straddling ranks '
        f'of a {STRADDLE_MESH} mesh over {RANKS} ranks', flush=True)
  cases = [(shape, torch.float32) for shape in ((1, 4), (2, 4), (1, 8))]
  cases.append(((1, 4), torch.bfloat16))
  for shape, dtype in cases:
    mesh = create_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
    for name, leaves, shards, embed in k3_blocks(torch, mesh.size, dtype, dev,
                                                 17):
      for direction in (+1, -1):
        what = f'K3 {shape} {str(dtype)[6:]} {name} {direction:+d}'
        kk.reset_launches()
        out = halo.neighbor_shift(shards, mesh, direction, impl='pallas')
        want = kk.halo_shift_plain([x.detach() for x in shards], mesh.run,
                                   direction)
        torch.cuda.synchronize()
        check(kk.launches['shift'] == 1 and all(
            torch.equal(o, w) for o, w in zip(out, want)),
              f'{what}: one launch, bit-equal to the plain version')
        edge = [o for i, o in enumerate(out)
                if not 0 <= mesh.coords(i)[1] - direction < mesh.n_time]
        check(len(edge) == mesh.n_data and all(
            torch.count_nonzero(o).item() == 0 for o in edge),
              f'{what}: the boundary shards receive zeros')
        cot = [torch.randn(o.shape, device=dev).to(dtype) for o in out]
        grads = torch.autograd.grad(out, leaves, cot)
        adj = kk.halo_shift_plain(cot, mesh.run, -direction)
        torch.cuda.synchronize()
        check(kk.launches['shift'] == 2 and all(
            torch.equal(g, embed(a)) for g, a in zip(grads, adj)),
              f'{what}: the gradient is the plain adjoint, bit for bit')

  # The local launch of a rank whose run straddles a data row: ranks 1 and
  # 2 of STRADDLE_MESH over RANKS ranks hold shards (0, 3), (1, 0), (1, 1)
  # and (1, 2), (1, 3), (2, 0); the launch starts at the run's first time
  # position and leaves the edge the remote copy fills as zeros.
  per_rank = STRADDLE_MESH[0] * STRADDLE_MESH[1] // RANKS
  for rank in (1, 2):
    run = Run(rank * per_rank, per_rank, *STRADDLE_MESH)
    for dtype in (torch.float32, torch.bfloat16):
      for name, _, shards, _ in k3_blocks(torch, per_rank, dtype, dev, 23):
        shards = [x.detach() for x in shards]
        for direction in (+1, -1):
          kk.reset_launches()
          out = kk._launch(shards, run, direction)
          want = kk.halo_shift_plain(shards, run, direction)
          torch.cuda.synchronize()
          check(kk.launches['shift'] == 1 and all(
              torch.equal(o, w) for o, w in zip(out, want)),
                f'K3 the run of rank {rank} of {STRADDLE_MESH} '
                f'{str(dtype)[6:]} {name} {direction:+d}: one launch, '
                'bit-equal to the plain version')

  # tests/test_time_shard.py's test_pallas_halo_dp_stays_in_data_row on the
  # card: distinct rows catch a halo that leaks between data rows.
  gen = torch.Generator(dev).manual_seed(18)
  audio = torch.randn((2, 4000), generator=gen, device=dev)
  ir = (torch.randn((2, 1, 500), generator=gen, device=dev) *
        torch.exp(-torch.arange(500, device=dev) / 100.0))
  mesh = create_mesh(2, 2, devices=[dev] * 4)
  kk.reset_launches()
  got = time_shard.time_sharded_fft_convolve(mesh, audio, ir,
                                             halo_impl='pallas')
  err = (got - fft_convolve(audio, ir, padding='same')).abs().max().item()
  print(f'  (2 x 2) time-sharded fft_convolve vs dense: max |err| {err:.3e}, '
        f'K3 launches {kk.launches["shift"]}')
  check(err <= 2e-4 and kk.launches['shift'] > 0,
        'the (2 x 2) sharded fft_convolve through K3 within 2e-4 of dense')


def k2_backward(torch, xp, wh, bn, h0, g):
  """(dxp, dwh, dbn, dh0) from K2b and from its plain version."""
  from ddsp_torch.kernels import gru as kg
  leaves = [t.detach().requires_grad_() for t in (xp, wh.float(), bn, h0)]
  ys = kg.gru_sequence(*leaves)
  got = torch.autograd.grad(ys, leaves, g)
  h_prev = kg.h_prev_stream(h0, ys.detach(), kg.stream_dtype(xp.dtype))
  return got, kg.gru_bwd_plain(g, xp, h_prev, wh, bn)


def k2_passes(torch, xp, wh, bn, h0, g):
  """bf16 K2b's two kernels, each against its plain version on the same
  inputs: {name: relative max err}. The serial pass (the cluster kernel, or
  the cooperative one past 512 units) takes the plain forward's h_prev
  stream; the weight-gradient pass takes the serial kernel's outputs."""
  from ddsp_torch.kernels import gru as kg
  bn32, h032 = bn.float().contiguous(), h0.float().contiguous()
  ys = kg.gru_sequence_plain(xp, wh, bn, h0)
  h_prev = kg.h_prev_stream(h032, ys, torch.bfloat16)
  serial = (kg._launch_bwd_serial if wh.shape[0] in kg.CLUSTER_HIDDEN else
            kg._launch_coop_bwd)
  got = serial(g, xp, h_prev, wh, bn32)
  want = kg.gru_bwd_serial_plain(g, xp, h_prev, wh, bn)
  errs = {f'serial {k}': rel_err(a, b) for k, a, b in
          zip(('dxp', 'dhn', 'dbn tiles', 'dh0'), got, want)}
  dwh, dbn = kg._launch_wgrad_any(h_prev, *got[:3])
  want_w = kg.gru_wgrad_plain(h_prev, *got[:3])
  errs.update({f'wgrad {k}': rel_err(a, b) for k, a, b in
               zip(('dwh', 'dbn'), (dwh, dbn), want_w)})
  return errs


def k2_expected_launches(torch, hidden, batch, dtype, dev):
  """{'K2f', 'K2b', 'K2b_w'}: the launches one forward and backward of K2
  make on this route (the cluster route: one each, both passes of K2b;
  the cooperative route: one K2f and one K2b per launch of its plan, and
  with bf16 streams one weight-gradient pass)."""
  from ddsp_torch.kernels import gru as kg
  bf16 = dtype == torch.bfloat16
  if bf16 and kg.bf16_route(hidden)[0] == 'cluster':
    return {'K2f': 1, 'K2b': 1, 'K2b_w': 1}
  return {'K2f': kg.pick_cooperative(dev, hidden, batch, False,
                                     bf16)['launches'],
          'K2b': kg.pick_cooperative(dev, hidden, batch, True,
                                     bf16)['launches'],
          'K2b_w': 1 if bf16 else 0}


def k2_route_name(torch, hidden, dtype):
  from ddsp_torch.kernels import gru as kg
  if dtype == torch.bfloat16:
    route, h_pad = kg.bf16_route(hidden)
    return f'{route} (H padded to {h_pad})' if h_pad != hidden else route
  return 'cooperative'


# K2 cases of phase 3: (H, T, batches, dtypes). H = 512 and 64 are the
# cluster kernels' own sizes; 96 and 384 run on them zero-padded (to 128
# and 512); 640, 768 and 1024 are past any cluster and take the cooperative
# kernels (768: the widest H at which the JAX package runs its Pallas
# kernel), in bf16 and in float32 (float32 takes them at every H, here
# 512, 64, 768 and 1024). T = 125 is the ae encoder's GRU (its MFCC frames),
# T = 250 the inverse_synthesis RnnSandwich's at a request's, a step's and
# a zipped step's batch, T = 7500 the long-audio step's (30 s, phase 6k).
K2_CASES = (
    (HIDDEN, N_FRAMES, (1, 4, 16, 40, 128), ('float32', 'bfloat16')),
    (HIDDEN, AE_Z_STEPS, (1, 16), ('bfloat16',)),
    (HIDDEN, INV_FRAMES, (1, 16, 32), ('bfloat16',)),
    (HIDDEN, LONG_FRAMES, (LONG_BATCH,), ('bfloat16',)),
    (64, 24, (1, 4, 16, 40, 128), ('float32', 'bfloat16')),
    (96, N_FRAMES, (1, 16), ('bfloat16',)),
    (96, 24, (40,), ('bfloat16',)),
    (384, N_FRAMES, (1, 16), ('bfloat16',)),
    (384, 24, (40,), ('bfloat16',)),
    (640, N_FRAMES, (1, 16), ('bfloat16',)),
    (640, 24, (40,), ('bfloat16',)),
    (768, N_FRAMES, (1, 16), ('bfloat16',)),
    (768, 24, (40,), ('bfloat16',)),
    (768, N_FRAMES, (16,), ('float32',)),
    (1024, N_FRAMES, (1, 16), ('bfloat16',)),
    (1024, 24, (40,), ('bfloat16',)),
    (1024, N_FRAMES, (16,), ('float32',)),
)


def phase_k2(torch, dev):
  from ddsp_torch.kernels import gru as kg
  print('[3] K2 fused GRU vs plain: forward and backward, both dtypes, '
        'H in {64, 96, 384, 512, 640, 768, 1024}, B in {1, 2, 4, 16, 32, 40, '
        '128}, T in {24, 125, 250, 1000, 7500}', flush=True)
  for hidden in (HIDDEN, 64):
    for backward in (False, True):
      c = kg.pick_cluster(dev, hidden, backward)
      print(f"  bf16 {'K2b serial' if backward else 'K2f'} H={hidden}: "
            f"cluster of {c['cluster']} CTAs x u = {c['units']} units, "
            f"{c['smem_bytes']} B shared memory per CTA, at most "
            f"{c['max_active_clusters']} clusters resident", flush=True)
  for name, hidden, batch in (('bfloat16', 640, 40), ('bfloat16', 768, 16),
                              ('bfloat16', 1024, 16), ('bfloat16', 1024, 40),
                              ('float32', HIDDEN, 16), ('float32', HIDDEN, 128),
                              ('float32', 1024, 16)):
    for backward in (False, True):
      plan = kg.pick_cooperative(dev, hidden, batch, backward,
                                 name == 'bfloat16')
      print(f"  cooperative {name} {'K2b' if backward else 'K2f'} "
            f"H={hidden} B={batch}: plan {plan}", flush=True)
  for hidden, seq_len, batches, dtypes in K2_CASES:
    for name in dtypes:
      dtype = getattr(torch, name)
      for batch in batches:
        what = (f'{name} H={hidden} T={seq_len} B={batch}, '
                f'{k2_route_name(torch, hidden, dtype)}')
        xp, wh, bn, h0 = k2_inputs(torch, batch, dtype, 2, dev, hidden,
                                   seq_len)
        ys = kg.gru_sequence(xp, wh, bn, h0)
        ref = kg.gru_sequence_plain(xp, wh, bn, h0)
        torch.cuda.synchronize()
        err = (ys - ref).abs().max().item()
        g = torch.randn(ys.shape, device=dev,
                        generator=torch.Generator(dev).manual_seed(8)) / 30.0
        reset_launches()  # one forward and one backward from here
        got, want = k2_backward(torch, xp, wh, bn, h0, g)
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items()
                    if k.startswith('K2')}
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        print(f'  K2f {what}: max |err| {err:.3e} (atol {K2_ATOL[name]}); '
              f'K2b relative max err dxp {errs[0]:.3e} dwh {errs[1]:.3e} '
              f'dbn {errs[2]:.3e} dh0 {errs[3]:.3e} (rtol '
              f'{K2_BWD_RTOL[name]}); launches {launches}', flush=True)
        check(torch.isfinite(ys).all().item() and err <= K2_ATOL[name],
              f'K2f {what} within {K2_ATOL[name]}')
        check(got[0].dtype == xp.dtype and all(
            t.dtype == torch.float32 for t in got[1:]),
              f'K2b {what}: dxp at the stream dtype, dwh/dbn/dh0 float32')
        check(all(torch.isfinite(a).all().item() for a in got) and
              max(errs) <= K2_BWD_RTOL[name],
              f'K2b {what} within {K2_BWD_RTOL[name]}')
        expected = k2_expected_launches(torch, hidden, batch, dtype, dev)
        check(launches == expected,
              f'K2 {what}: launches {expected}, the kernels of its route '
              '(no plain version)')
        if dtype == torch.bfloat16 and (hidden in kg.CLUSTER_HIDDEN or
                                        hidden > kg.CLUSTER_HIDDEN[-1]):
          passes = k2_passes(torch, xp, wh, bn, h0, g)
          print('  K2b passes ' + ', '.join(f'{k} {v:.3e}'
                                            for k, v in passes.items()))
          check(max(v for k, v in passes.items() if k.startswith('serial'))
                <= K2_BWD_RTOL['bfloat16'] and
                max(v for k, v in passes.items() if k.startswith('wgrad'))
                <= K2_WGRAD_RTOL,
                f'K2b {what}: the serial pass within '
                f"{K2_BWD_RTOL['bfloat16']} and the weight-gradient pass "
                f'within {K2_WGRAD_RTOL} of their plain versions')


# Phase 3d: the JAX package's public surface, as a user calls it.
SURFACE_SPLITS = (('amps', 1), ('harmonic_distribution', N_HARMONICS),
                  ('noise_magnitudes', N_NOISE))  # solo_instrument's head


def phase_surface(torch, dev):
  """ddsp_torch.ops.harmonic_synthesis at the K1 phase's shapes reaches
  K1f, and a head built on ddsp_torch.nn.OutputSplitsModule (FastGRU(512)
  in bf16, then a Dense to solo_instrument's splits) reaches K2f; each is
  held against its plain version on the same inputs. Returns the launches
  of the two calls."""
  import ddsp_torch
  from ddsp_torch import nn as dnn
  from ddsp_torch import ops
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import harmonic as kh
  from ddsp_torch.nn import layers as nn_layers
  print('[3d] the public surface on the card: ops.harmonic_synthesis (K1f) '
        'and a head on nn.OutputSplitsModule (K2f)', flush=True)
  check(ddsp_torch.ops is ops and not isinstance(ops.resample, type(ops)),
        'ddsp_torch.ops is the flat namespace, ops.resample its function')

  class Head(dnn.OutputSplitsModule):
    """A user's head: (ld_scaled, f0_scaled) -> GRU -> Dense -> splits."""

    def __init__(self):
      super().__init__(input_keys=('ld_scaled', 'f0_scaled'),
                       output_splits=SURFACE_SPLITS)
      self.gru = dnn.FastGRU(2, HIDDEN, compute_dtype='bfloat16')
      self.dense_out = dnn.Dense(HIDDEN, self.n_out)

    def compute_output(self, ld_scaled, f0_scaled):
      return self.dense_out(self.gru(torch.cat([ld_scaled, f0_scaled], -1)))

  g = torch.Generator(dev).manual_seed(21)
  f0 = 80.0 * 20.0**torch.rand((BATCH, N_FRAMES, 1), generator=g, device=dev)
  amps = torch.rand((BATCH, N_FRAMES, 1), generator=g, device=dev)
  dist = torch.rand((BATCH, N_FRAMES, N_HARMONICS), generator=g, device=dev)
  features = {k: torch.rand((BATCH, N_FRAMES, 1), generator=g, device=dev)
              for k in ('ld_scaled', 'f0_scaled')}
  torch.manual_seed(22)
  head = Head().to(dev)
  reset_launches()
  audio = ops.harmonic_synthesis(f0, amps, harmonic_distribution=dist,
                                 n_samples=N_SAMPLES, sample_rate=SR,
                                 use_angular_cumsum=True)
  with torch.no_grad():
    out = head(features)
  torch.cuda.synchronize()
  launches = read_launches()
  # The plain versions on the same inputs: the phase as the op builds it,
  # and the head with the plain recurrence in place of K2f.
  f0_env = ops.resample(f0, N_SAMPLES)
  phase0 = ops.angular_cumsum(f0_env * (2.0 * np.pi) / float(SR))
  ref = kh.harmonic_synthesis_plain(phase0[..., 0], f0_env[..., 0],
                                    amps * dist, SR, 'window')
  kernel_route = nn_layers.gru_sequence
  nn_layers.gru_sequence = kg.gru_sequence_plain
  try:
    with torch.no_grad():
      ref_out = head(features)
  finally:
    nn_layers.gru_sequence = kernel_route
  torch.cuda.synchronize()
  err_k1 = (audio - ref).abs().max().item()
  err_k2 = max((out[k] - ref_out[k]).abs().max().item() for k in out)
  print(f'  ops.harmonic_synthesis [{BATCH}, {N_SAMPLES}] from {N_FRAMES} '
        f'frames x {N_HARMONICS} harmonics: max |err| {err_k1:.3e} (atol '
        f'{K1_ATOL}); head {[(k, tuple(v.shape)) for k, v in out.items()]}: '
        f"max |err| {err_k2:.3e} (atol {K2_ATOL['bfloat16']}); launches "
        f'{launches}', flush=True)
  check(audio.device == ref.device and tuple(audio.shape) == (
      BATCH, N_SAMPLES) and torch.isfinite(audio).all().item() and
        err_k1 <= K1_ATOL,
        f'ops.harmonic_synthesis on the card within {K1_ATOL} of the plain '
        'version')
  check(list(out) == [k for k, _ in SURFACE_SPLITS] and all(
      tuple(out[k].shape) == (BATCH, N_FRAMES, n) and
      out[k].device == ref.device and torch.isfinite(out[k]).all().item()
      for k, n in SURFACE_SPLITS) and err_k2 <= K2_ATOL['bfloat16'],
        f"the OutputSplitsModule head within {K2_ATOL['bfloat16']} of its "
        'plain route')
  check(launches['K1f'] == 1 and launches['K2f'] == 1 and
        sum(launches.values()) == 2,
        'the flat names launched K1f once and K2f once, and nothing else')
  return launches


# Phase 3c: K2b's weight-gradient kernel (H, T, batches; H = 96 and 384
# through the zero padding to 128 and 512) and K2f's step kernel (H,
# batches).
WGRAD_CASES = ((HIDDEN, N_FRAMES, (1, 16, 40, 128)), (64, 24, (40,)),
               (64, N_FRAMES, (16,)), (96, N_FRAMES, (16,)),
               (384, N_FRAMES, (16,)))
STEP_CASES = ((64, (1, 4, 40)), (HIDDEN, (1, 4, 40)), (1024, (1, 4, 40)))


def wgrad_streams(torch, hidden, seq_len, batch, seed, dev):
  """K2b (a)'s outputs as the weight-gradient pass takes them: h_prev, dxp,
  dhn in bf16 (h in [-1, 1], gradients ~1e-2) and the tiles' dbn sums."""
  from ddsp_torch.kernels import gru as kg
  g = torch.Generator(dev).manual_seed(seed)
  shape = (seq_len, batch)
  return ((torch.rand(shape + (hidden,), generator=g, device=dev) * 2 -
           1).bfloat16(),
          (torch.randn(shape + (3 * hidden,), generator=g, device=dev) *
           1e-2).bfloat16(),
          (torch.randn(shape + (hidden,), generator=g, device=dev) *
           1e-2).bfloat16(),
          torch.randn((kg.batch_tiles(batch), hidden), generator=g,
                      device=dev) * 0.1)


def phase_k2_hopper(torch, dev):
  from ddsp_torch.kernels import gru as kg
  print('[3c] K2b weight-gradient kernel (TMA + wgmma, split K) and K2f step '
        'kernel vs plain', flush=True)
  for hidden, seq_len, batches in WGRAD_CASES:
    h_pad = kg.bf16_route(hidden)[1]
    for batch in batches:
      streams = wgrad_streams(torch, hidden, seq_len, batch, 12, dev)
      padded = (kg.pad_units(streams[0], h_pad).contiguous(),
                kg.pad_gates(streams[1], h_pad).contiguous(),
                kg.pad_units(streams[2], h_pad).contiguous(),
                kg.pad_units(streams[3], h_pad).contiguous())
      kg.reset_launches()
      got = kg._launch_wgrad(*padded)
      again = kg._launch_wgrad(*padded)
      torch.cuda.synchronize()
      got = (kg.unpad_gates(got[0][:hidden], hidden), got[1][:hidden])
      again = (kg.unpad_gates(again[0][:hidden], hidden), again[1][:hidden])
      want = kg.gru_wgrad_plain(*streams)
      errs = [rel_err(a, b) for a, b in zip(got, want)]
      plan = kg.pick_wgrad(dev, h_pad, seq_len * batch)
      what = (f'H={hidden}' + (f' (padded to {h_pad})' if h_pad != hidden
                               else '') + f' T={seq_len} B={batch}')
      print(f"  weight gradient {what}: plan {plan['bm']} x {plan['bn']} "
            f"tiles x {plan['tiles']}, {plan['splits']} K slices of "
            f"{plan['chunk']}-row chunks ({plan['tiles'] * plan['splits']} "
            f'CTAs); relative max err dwh {errs[0]:.3e} dbn {errs[1]:.3e}',
            flush=True)
      check(max(errs) <= K2_WGRAD_RTOL and
            all(torch.isfinite(a).all().item() for a in got),
            f'weight gradient {what} within {K2_WGRAD_RTOL}')
      check(all(torch.equal(a, b) for a, b in zip(got, again)) and
            kg.launches['wgrad'] == 2,
            f'weight gradient {what}: two launches, bit-equal results')
  for hidden, batches in STEP_CASES:
    for batch in batches:
      xp, wh, bn, h0 = k2_inputs(torch, batch, torch.float32, 13, dev,
                                 hidden, 1)
      h0 = 3.0 * h0  # |h0| up to ~1, as a streamed state
      kg.reset_launches()
      ys = kg.gru_sequence(xp, wh, bn, h0)
      torch.cuda.synchronize()
      err = (ys - kg.gru_sequence_plain(xp, wh, bn, h0)).abs().max().item()
      what = f'K2f step kernel H={hidden} B={batch}'
      print(f'  {what} (h0 |max| {h0.abs().max().item():.3f}): max |err| '
            f'{err:.3e}; launches {dict(kg.launches)}', flush=True)
      check(torch.isfinite(ys).all().item() and err <= K2_ATOL['float32'],
            f"{what} within {K2_ATOL['float32']}")
      check(kg.launches['fwd'] == kg.launches['fwd_step'] == 1 and
            kg.launches['fwd_cooperative'] == 0,
            f'{what}: one launch of the step kernel, none cooperative')


def phase_gradients_reach_parameters(torch, dev):
  """loss.backward() through FastGRU and through harmonic_synthesis on the
  card leaves the gradients the port computes on the CPU."""
  from ddsp_torch.nn.layers import FastGRU
  from ddsp_torch.ops import oscillator as osc
  print('[3b] gradients through the kernels on the card vs the CPU port',
        flush=True)
  gen = torch.Generator().manual_seed(11)
  x = torch.randn((2, 200, 64), generator=gen)
  for dtype, rtol in (('float32', 1e-3), ('bfloat16', 5e-2)):
    grads = {}
    for where in ('cpu', 'cuda'):
      gru = FastGRU(64, HIDDEN, compute_dtype=dtype)
      gru.reset_parameters(torch.Generator().manual_seed(12))
      gru = gru.to(where)
      ys, state = gru(x.to(where), return_state=True)
      (ys.float().pow(2).mean() + state.float().pow(2).mean()).backward()
      grads[where] = {k: p.grad.cpu() for k, p in gru.named_parameters()}
    for k, g_cpu in grads['cpu'].items():
      g_gpu = grads['cuda'][k]
      err = rel_err(g_gpu, g_cpu)
      print(f'  FastGRU {dtype} {k}.grad: |max| {g_gpu.abs().max():.3e}, '
            f'relative max err vs CPU {err:.3e} (rtol {rtol})')
      check(torch.isfinite(g_gpu).all().item() and g_gpu.abs().max() > 0
            and err <= rtol, f'FastGRU {dtype} {k}.grad non-zero and within '
            f'{rtol} of the CPU port')
  amps = torch.rand((2, 250, 1), generator=gen)
  dist = torch.rand((2, 250, N_HARMONICS), generator=gen)
  f0 = 200.0 + 300.0 * torch.rand((2, 250, 1), generator=gen)
  grads = {}
  for where in ('cpu', 'cuda'):
    leaves = [t.detach().to(where).requires_grad_()
              for t in (amps, dist, f0)]
    audio = osc.harmonic_synthesis(leaves[2], leaves[0],
                                   harmonic_distribution=leaves[1],
                                   n_samples=16000, sample_rate=SR,
                                   use_angular_cumsum=True)
    audio.pow(2).mean().backward()
    grads[where] = [t.grad.cpu() for t in leaves]
  for name, g_cpu, g_gpu in zip(('amplitudes', 'harmonic_distribution',
                                 'f0_hz'), grads['cpu'], grads['cuda']):
    err = rel_err(g_gpu, g_cpu)
    # The two devices sum the phase in another order; harmonic h multiplies
    # that difference, in the audio (the cotangent here) and in the sines.
    rtol = 2e-2
    print(f'  harmonic_synthesis {name}.grad: |max| {g_gpu.abs().max():.3e}, '
          f'relative max err vs CPU {err:.3e} (rtol {rtol})')
    check(torch.isfinite(g_gpu).all().item() and g_gpu.abs().max() > 0 and
          err <= rtol, f'harmonic_synthesis {name}.grad non-zero and within '
          f'{rtol} of the CPU port')


def reset_launches():
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import halo as kk
  from ddsp_torch.kernels import harmonic as kh
  kh.reset_launches()
  kg.reset_launches()
  kk.reset_launches()


def read_launches():
  """{'K1f': n, 'K1t': n, 'K1p': n, 'K2f': n, 'K2b': n, 'K2b_w': n, 'K3': n}
  since the reset; K2b_w is K2b's weight-gradient pass."""
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import halo as kk
  from ddsp_torch.kernels import harmonic as kh
  return {'K1f': kh.launches['fwd'], 'K1t': kh.launches['bwd_taps'],
          'K1p': kh.launches['bwd_phase'], 'K2f': kg.launches['fwd'],
          'K2b': kg.launches['bwd'], 'K2b_w': kg.launches['wgrad'],
          'K3': kk.launches['shift']}


def read_rank_launches():
  """read_launches() and 'K3r', K3's remote copy between ranks."""
  from ddsp_torch.kernels import halo as kk
  return dict(read_launches(), K3r=kk.launches['remote_shift'])


def requests():
  """4 requests of 4 s of (f0_hz, loudness_db) frames; the first is flat."""
  rng = np.random.RandomState(0)
  t = np.arange(N_FRAMES) / 250.0
  out = [{'f0_hz': np.full(N_FRAMES, 440.0, np.float32),
          'loudness_db': np.full(N_FRAMES, -20.0, np.float32)}]
  for i in range(3):
    f0 = 110.0 * 2.0**(i + 0.1 * np.sin(2 * np.pi * (3 + i) * t))
    ld = -30.0 + 10.0 * np.sin(2 * np.pi * 0.5 * t) - 5 * rng.rand(N_FRAMES)
    out.append({'f0_hz': f0.astype(np.float32),
                'loudness_db': ld.astype(np.float32)})
  return out


def write_export(torch, export_dir):
  """A params-format export of full-width solo_instrument, seeded weights.

  The head's harmonic-distribution bias favours the fundamental, so the
  flat request's spectral peak is known (random weights would put it on any
  harmonic); everything else is drawn from torch.Generator(seed 0).
  """
  from ddsp_torch.utils import build_model
  model = build_model('solo_instrument', device='cpu', seed=0)
  with torch.no_grad():
    bias = model.decoder.dense_out.bias
    bias[1:1 + N_HARMONICS] = -4.0
    bias[1] = 4.0
  with open(os.path.join(export_dir, 'operative_spec.json'), 'w') as f:
    json.dump({'preset': 'solo_instrument', 'kwargs': {}}, f)
  np.savez(os.path.join(export_dir, 'params.npz'),
           **{k.replace('.', '/'): v.detach().numpy()
              for k, v in model.named_parameters()})


def phase_serve(torch, export_dir):
  from ddsp_torch.infer import AutoencoderInference
  print('[4] serve solo_instrument (full width, 48000-tap reverb)', flush=True)
  port = AutoencoderInference(export_dir, length_seconds=4,
                              remove_reverb=False)
  reqs = requests()
  reset_launches()
  audio = [port.get_audio(r) for r in reqs]
  torch.cuda.synchronize()
  launches = read_launches()
  print(f'  launches over {len(reqs)} requests: {launches}')
  for i, a in enumerate(audio):
    rms = a.float().pow(2).mean().sqrt().item()
    print(f'  request {i}: shape {tuple(a.shape)} rms {rms:.4f}')
    check(tuple(a.shape) == (1, N_SAMPLES) and torch.isfinite(a).all().item()
          and rms > 0, f'request {i} audio [1, {N_SAMPLES}], finite, rms > 0')
  spec = np.abs(np.fft.rfft(audio[0][0].cpu().numpy()))
  peak_hz = np.argmax(spec) * SR / N_SAMPLES
  print(f'  flat 440 Hz request: spectral peak {peak_hz:.2f} Hz '
        f'(bin {SR / N_SAMPLES} Hz)')
  check(abs(peak_hz - 440.0) <= SR / N_SAMPLES, 'peak within one bin of 440')
  check(launches['K1f'] >= 4 and launches['K2f'] >= 4,
        'K1f and K2f each launched >= 4 times on the serving path')
  check(launches['K1t'] == launches['K1p'] == launches['K2b'] ==
        launches['K2b_w'] == 0, 'serving launches no backward kernel')

  # The same request through the port on the CPU (plain versions, same
  # noise): the kernels' path agrees with the reference path end to end.
  cpu_port = AutoencoderInference(export_dir, length_seconds=4,
                                  remove_reverb=False, device='cpu')
  noise = torch.rand((1, N_SAMPLES), generator=torch.Generator().manual_seed(
      3)) * 2 - 1
  out_gpu = port(reqs[1], noise=noise.cuda())['audio_synth'].cpu()
  out_cpu = cpu_port(reqs[1], noise=noise)['audio_synth']
  rel = ((out_gpu - out_cpu).norm() / out_cpu.norm()).item()
  print(f'  GPU vs CPU port, request 1: relative L2 {rel:.3e}')
  check(rel <= E2E_REL_L2, f'GPU path within {E2E_REL_L2} of the CPU path')
  return port, reqs, launches


# The VST streaming path (phase 4b): the vst preset at full width, streamed
# hop by hop as a plugin runs it (ddsp_tpu/infer/inference.py:172-423).
VST_HOP = 320              # 16 kHz / 50 frames per second
VST_FRAME = 1024
VST_HOPS = 250             # 5 s
VST_WARMUP_HOPS = 10
VST_HOP_PERIOD_MS = 1e3 * VST_HOP / SR  # 20 ms: a hop is due every period
VST_CLIP_SAMPLES = 4 * SR + VST_HOP     # the preset's clip: 4 s + one hop
VST_CLIP_FRAMES = VST_CLIP_SAMPLES // VST_HOP + 1  # centered framing: 202
# The vst preset as it is: rnn_channels 512, ch 256, 60 harmonics, 65 noise
# bands, a 24000-tap FilteredNoiseReverb (ddsp_tpu/configs/presets.py:154).
VST_KWARGS = {}
# The streamed state and audio on the card against the port on the CPU over
# the same 250 hops and noise buffer. The state: the GRU runs float32 on
# both devices at T = 1, fed by bf16 FC stacks whose outputs the two
# devices may round apart where a float32 sum lands on a bf16 rounding
# boundary (2^-8 relative); none did on an H100 (4.2e-7), and 1e-3 leaves
# room for one such element damped through the LayerNorm and the gates.
VST_STATE_ATOL = 1e-3
# The audio: CUDA divides a tensor by a scalar as a product with the
# scalar's float32 reciprocal and the CPU divides, so the angular frequency
# 2 pi f / sr rounds apart and a hop's phase (55 rad at 440 Hz) ends about
# a float32 ulp from the CPU's; the carried phase is unwrapped
# (~1257 rad after 250 hops, an ulp of 1.2e-4), and its sums round those
# ulps into whole ulps of the carry now and then: 5.7e-3 rad after 250 hops
# on an H100, the stream 1.7e-2 apart in relative L2 (harmonic h moves h
# times the phase). The serving slice's tolerance.
VST_STREAM_REL_L2 = E2E_REL_L2
# 250 hops of constant controls (amplitude 0.5, the 60 harmonics flat, 18
# of them below Nyquist at 440 Hz) streamed with the phase carried, against
# one streaming_harmonic_synthesis of all 80000 samples. The carry is the
# unwrapped phase, as the JAX package returns it: after 250 hops it is
# ~1257 rad, and adding the next hop's wrapped phase to it rounds to
# float32 (ulp 1.2e-4 rad) once per sample; on an H100 the two syntheses
# end 2.35e-3 rad and 1.12e-2 apart.
VST_CONTINUITY_ATOL = 2e-2


# angular_cumsum's phase over the 80000 samples of the continuity check,
# against a float64 sum: the float32 rounding of each sample (ulp 4.8e-7
# below 2 pi) and of the chunks' carries; 9.1e-5 rad on the CPU.
VST_CUMSUM_ATOL = 1e-3


def angular_cumsum_float32(torch, omega, chunk=1000):
  """ops/oscillator.py angular_cumsum with torch.cumsum's own accumulation
  (float32 on the card) in place of phase_cumsum's float64 sums; omega
  [1, n, 1] with n a multiple of chunk."""
  phase = torch.cumsum(omega.view(1, -1, chunk, 1), dim=2)
  offsets = torch.remainder(phase[:, :, -1:], 2 * np.pi)
  offsets = torch.nn.functional.pad(offsets, (0, 0, 0, 0, 1, 0))[:, :-1]
  offsets = torch.remainder(torch.cumsum(offsets, dim=1), 2 * np.pi)
  return torch.remainder(phase + offsets, 2 * np.pi).view(omega.shape)


def vst_tone(n_samples):
  """A 440 Hz sine at -20 dBFS (RMS 0.1), float32."""
  t = np.arange(n_samples) / SR
  return (0.1 * np.sqrt(2.0) * np.sin(2 * np.pi * 440.0 * t)).astype(
      np.float32)


def write_vst_export(torch, export_dir):
  """A params-format export of the vst preset (VST_KWARGS: its own widths,
  with its reverb), weights drawn from torch.Generator(seed 0)."""
  from ddsp_torch.utils import build_model
  os.makedirs(export_dir, exist_ok=True)
  model = build_model('vst', device='cpu', seed=0, **VST_KWARGS)
  with open(os.path.join(export_dir, 'operative_spec.json'), 'w') as f:
    json.dump({'preset': 'vst', 'kwargs': VST_KWARGS}, f)
  np.savez(os.path.join(export_dir, 'params.npz'),
           **{k.replace('.', '/'): v.detach().numpy()
              for k, v in model.named_parameters()})


def vst_stream(torch, dev, extract, predict, synth, frames, sync_stages,
               state=None):
  """Stream the hops of `frames` [n, 1024] through extract -> predict ->
  synth, carrying the state and the phase on `dev`. predict takes the
  state when `state` is given (stateless), else carries its own.

  Returns {'audio': [n, 320], 'controls': [(amps, hd, noise)], 'state':
  the last state (stateless), 'states': the first and last state, 'ms':
  {stage: [ms per hop]}}. With sync_stages the device is synchronized after
  every stage and each stage is timed; else once per hop, as a plugin
  synchronizes to hand its audio over (on the CPU there is nothing to
  synchronize)."""
  from ddsp_torch.nn.preprocessing import scale_f0_hz
  cuda = dev.type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  f0_hz = torch.full((1,), 440.0, device=dev)
  f0_scaled = scale_f0_hz(f0_hz)
  phase = synth.initial_phase()
  prev = None
  audio, controls, states = [], [], []
  ms = {'extract': [], 'predict': [], 'synth': [], 'total': []}
  for frame in frames:
    t0 = time.perf_counter()
    _, _, _, pw_scaled = extract(frame)
    if sync_stages:
      sync()
      t1 = time.perf_counter()
      ms['extract'].append(1e3 * (t1 - t0))
    if state is None:
      amps, hd, noise = predict(f0_scaled, pw_scaled)
    else:
      amps, hd, noise, state = predict(f0_scaled, pw_scaled, state)
      if not states:
        states.append(state)
    if sync_stages:
      sync()
      t2 = time.perf_counter()
      ms['predict'].append(1e3 * (t2 - t1))
    if prev is None:
      prev = (amps, hd)
    hop, phase = synth(amps, prev[0], hd, prev[1], f0_hz, f0_hz, noise,
                       phase)
    sync()
    t3 = time.perf_counter()
    if sync_stages:
      ms['synth'].append(1e3 * (t3 - t2))
    ms['total'].append(1e3 * (t3 - t0))
    prev = (amps, hd)
    audio.append(hop)
    controls.append((amps, hd, noise))
  if state is not None:
    states.append(state)
  return {'audio': torch.stack(audio), 'controls': controls, 'state': state,
          'states': states, 'ms': ms, 'phase': phase}


def same_controls(torch, a, b):
  """Whether two runs' controls are equal bit for bit, hop by hop."""
  return all(torch.equal(x, y) for ca, cb in zip(a, b)
             for x, y in zip(ca, cb))


def k2f_one_hop_entry(torch, dev, predict, frame_state, launches):
  """The kernels line's entry for K2f at one hop: T = 1, B = 1, H = 512,
  float32 streams (the step kernel), on the operands of one hop of the
  stream (the GRU's input and state as the decoder hands them over).
  Library: one torch.nn.GRUCell step on the same operands (weight_ih = the
  bf16-rounded wi^T, bias_ih = bi, weight_hh = wh^T, bias_hh = [0, 0,
  bn]); it includes the input projection, which the port runs as a GEMM
  beside K2f, so the port's whole FastGRU step is timed beside it. The
  cooperative kernel (the float32 route from T = 2) is timed on the same
  operands."""
  from ddsp_torch.kernels import gru as kg
  gru = predict.model.decoder.rnn.FastGRU_0
  seen = {}

  def grab(module, args, kwargs):
    seen['x'], seen['h0'] = args[0], kwargs['initial_state']

  hook = gru.register_forward_pre_hook(grab, with_kwargs=True)
  predict(*frame_state)
  hook.remove()
  with torch.no_grad():
    x, h0 = seen['x'], seen['h0'].float().contiguous()
    hidden = gru.dims
    wi = gru.wi.to(gru.dtype).float()
    xp = (x.to(gru.dtype).float() @ wi + gru.bi).transpose(0, 1).contiguous()
    wh, bn = gru.wh.detach().contiguous(), gru.bn.detach().contiguous()
    ys = kg._launch_fwd(xp, wh, bn, h0)
    err = (ys - kg.gru_sequence_plain(xp, wh, bn, h0)).abs().max().item()
    check(err <= K2_ATOL['float32'] and tuple(ys.shape) == (1, 1, hidden),
          f"K2f at one hop (T = 1, B = 1, H = {hidden}, float32, a non-zero "
          f"h0) within {K2_ATOL['float32']} of its plain version")
    cell = torch.nn.GRUCell(x.shape[-1], hidden).to(dev)
    cell.weight_ih.copy_(wi.t())
    cell.bias_ih.copy_(gru.bi)
    cell.weight_hh.copy_(wh.t())
    cell.bias_hh.zero_()
    cell.bias_hh[2 * hidden:].copy_(bn)
    x2 = x[:, 0].to(gru.dtype).float()
    cell_err = (cell(x2, h0) - ys[0]).abs().max().item()
    check(cell_err <= K2_ATOL['float32'],
          f"torch.nn.GRUCell yardstick computes the same step (max |err| "
          f"{cell_err:.3e})")
    entry = kernel_entry(
        torch, 'gru_sequence forward, one hop (K2f step kernel, float32, '
        'T = 1, B = 1)',
        'ddsp_torch/csrc/gru.cu', 'ddsp_tpu/ops/pallas_kernels/gru.py:124',
        launches['K2f'], err, lambda: kg._launch_fwd(xp, wh, bn, h0),
        lambda: kg.gru_sequence_plain(xp, wh, bn, h0),
        *k2_bound(xp, wh, 'float32'),
        device_ms(torch, lambda: cell(x2, h0), 200), 200, 50)
    entry['library'] = ('torch.nn.GRUCell, one step with its input '
                        'projection')
    entry['library_call_ms'] = cuda_ms(torch, lambda: cell(x2, h0), 200)
    entry['port_step_ms'] = device_ms(
        torch, lambda: gru(x, initial_state=h0, return_state=True), 200)
    coop = lambda: kg._launch_coop_fwd(xp, wh, bn, h0)
    coop_err = (coop() - ys).abs().max().item()
    check(coop_err <= K2_ATOL['float32'],
          f'the cooperative route agrees with the step kernel at one hop '
          f'(max |err| {coop_err:.3e})')
    entry['cooperative_ms'] = device_ms(torch, coop, 200)
    entry['cooperative_call_ms'] = cuda_ms(torch, coop, 200)
    entry['launches_per_hop'] = launches['K2f'] / VST_HOPS
  entry['launches_by_path'] = {'vst': launches['K2f']}
  print_entry(entry)
  print(f"  one FastGRU step of the port (projection GEMM + K2f): "
        f"{entry['port_step_ms']:.4f} ms device; GRUCell per call with host "
        f"{entry['library_call_ms']:.4f} ms; the cooperative kernel "
        f"{entry['cooperative_ms']:.4f} ms device, "
        f"{entry['cooperative_call_ms']:.4f} ms per call", flush=True)
  return entry


def latency_line(name, values):
  v = np.asarray(values)
  return (f'{name} median {np.median(v):.4f} ms, p99 '
          f'{np.percentile(v, 99):.4f} ms, max {v.max():.4f} ms')


def phase_vst(torch, dev, export_dir, profile=False):
  """Stream 250 hops of a 440 Hz tone through the vst preset at full width
  (extract -> stateless predict -> synthesize), check the hops, the state,
  the stateful class, the launches, the phase carry, the CPU port, and the
  whole-clip forward; report per-hop latency and K2f's one-hop entry."""
  from ddsp_torch import infer
  from ddsp_torch.infer.inference import load_params
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.ops import oscillator as osc
  from ddsp_torch.utils import load_jax_params, registry
  write_vst_export(torch, export_dir)
  spec_model = registry.model_from_spec(export_dir, device='cpu')
  reverb_length = spec_model.processor_group.reverb.reverb_length
  print(f'[4b] VST streaming: the vst preset (GRU '
        f'{spec_model.decoder.rnn.FastGRU_0.dims}, '
        f'{N_HARMONICS} harmonics, {VST_HOPS} hops of {VST_HOP} samples, '
        f'{reverb_length}-tap reverb on the whole clip)', flush=True)
  tone = vst_tone(VST_FRAME + (VST_HOPS - 1) * VST_HOP)
  frames = np.stack([tone[i * VST_HOP:i * VST_HOP + VST_FRAME]
                     for i in range(VST_HOPS)])
  where = {}
  for name in ('cuda', 'cpu'):
    d = dev if name == 'cuda' else torch.device('cpu')
    where[name] = {
        'dev': d, 'frames': torch.from_numpy(frames).to(d),
        'extract': infer.VSTExtractFeatures(export_dir, compute_f0=False,
                                            device=d),
        'predict': infer.VSTStatelessPredictControls(export_dir, device=d),
        'synth': infer.VSTSynthesize(export_dir, device=d)}
  gpu, cpu = where['cuda'], where['cpu']
  cpu['synth'].noise_signal = gpu['synth'].noise_signal.cpu()

  def run(side, sync_stages, stateful=None):
    predict = stateful or side['predict']
    return vst_stream(torch, side['dev'], side['extract'], predict,
                      side['synth'], side['frames'], sync_stages,
                      None if stateful else predict.initial_state())

  # K2f's routes at one hop and at one batch row, with a non-zero h0: the
  # float32 step kernel (every hop) and the bf16 cluster route (the whole
  # clip's T >= 8 streams take it; here at T = 1).
  for name, route in (('float32', 'step'), ('bfloat16', 'cluster')):
    xp, wh, bn, h0 = k2_inputs(torch, 1, getattr(torch, name), 21, dev,
                               HIDDEN, 1)
    reset_launches()
    ys = kg.gru_sequence(xp, wh, bn, h0)
    torch.cuda.synchronize()
    n_fwd, n_coop = kg.launches['fwd'], kg.launches['fwd_cooperative']
    n_step = kg.launches['fwd_step']
    err = (ys - kg.gru_sequence_plain(xp, wh, bn, h0)).abs().max().item()
    print(f'  K2f {name} T=1 B=1 H={HIDDEN} (h0 |max| '
          f'{h0.abs().max().item():.3f}): max |err| {err:.3e}; launches '
          f'{n_fwd}, step {n_step}, cooperative {n_coop}', flush=True)
    check(err <= K2_ATOL[name] and n_fwd == 1 and n_coop == 0 and
          n_step == (1 if route == 'step' else 0),
          f'K2f {name} at T = 1, B = 1 within {K2_ATOL[name]}, one launch '
          f'on the {route} route')

  # Warm-up (not counted): the first launches, K2f's plan, cuFFT's plans.
  run({**gpu, 'frames': gpu['frames'][:VST_WARMUP_HOPS]}, True)
  reset_launches()
  stream = run(gpu, True)
  torch.cuda.synchronize()
  launches = read_launches()
  n_coop, n_step = kg.launches['fwd_cooperative'], kg.launches['fwd_step']
  print(f'  launches over {VST_HOPS} hops: {launches}, K2f on the step '
        f'kernel {n_step}, on the cooperative route {n_coop}', flush=True)
  audio = stream['audio']
  per_hop_ok = all(
      tuple(a.shape) == (VST_HOP,) and torch.isfinite(a).all().item() and
      a.abs().max().item() > 0 for a in audio)
  check(per_hop_ok, f'every hop is [{VST_HOP}], finite and not all zero')
  first, last = stream['states']
  moved = (last - first).abs().max().item()
  print(f'  state: |first| {first.abs().max().item():.4f}, |last - first| '
        f'{moved:.4f}; audio rms {audio.pow(2).mean().sqrt().item():.4f}')
  check(moved > 1e-3, 'the GRU state moves over the stream')
  check(launches['K2f'] == n_step == VST_HOPS and n_coop == 0,
        'K2f launched once per predict call, on the step kernel (float32, '
        'T = 1), never on the cooperative route')
  check(all(launches[k] == 0 for k in ('K1f', 'K1t', 'K1p', 'K2b', 'K2b_w',
                                       'K3')),
        'no K1f, K1t, K1p, K2b, K2b_w or K3 launch on the streaming path')
  print('  (K1f: the streaming synth is harmonic_oscillator_bank, plain '
        'torch as the JAX package\'s jnp; the JAX package reaches no Pallas '
        'kernel per hop)')

  # As a plugin runs it: the stateful class, one synchronization per hop.
  stateful = infer.VSTPredictControls(export_dir, device=dev)
  plugin = run(gpu, False, stateful)
  check(same_controls(torch, plugin['controls'], stream['controls']) and
        torch.equal(plugin['audio'], audio),
        'VSTPredictControls repeats the stateless run bit for bit')
  stateful.reset()
  again = run(gpu, False, stateful)
  check(same_controls(torch, again['controls'], stream['controls']),
        'after reset() VSTPredictControls repeats that run bit for bit')
  for name in ('extract', 'predict', 'synth', 'total'):
    print('  per hop, ' + latency_line(
        f'{name} (synchronized after each stage)', stream['ms'][name]))
  total = plugin['ms']['total'] + again['ms']['total']
  print('  per hop, ' + latency_line(
      f'total with one synchronization per hop ({len(total)} hops)', total) +
        f'; the hop period is {VST_HOP_PERIOD_MS:.1f} ms (median '
        f'{100 * np.median(total) / VST_HOP_PERIOD_MS:.1f} % of it)',
        flush=True)
  if profile:
    profile_steps(torch, lambda: run({**gpu, 'frames': gpu['frames'][:1]},
                                     False),
                  20, float(np.median(total)), 'hop')

  # Phase continuity: constant controls streamed with the phase carried,
  # against one synthesis of the whole span.
  harmonic = infer.VSTSynthesizeHarmonic(export_dir, device=dev)
  amps = torch.full((1,), 0.5, device=dev)
  hd = torch.full((N_HARMONICS,), 1.0 / N_HARMONICS, device=dev)
  f0 = torch.full((1,), 440.0, device=dev)
  phase = harmonic.initial_phase()
  hops = []
  for _ in range(VST_HOPS):
    hop, phase = harmonic(amps, amps, hd, hd, f0, f0, phase)
    hops.append(hop)
  streamed = torch.cat(hops)
  whole, whole_phase = osc.streaming_harmonic_synthesis(
      torch.full((1, 2, 1), 440.0, device=dev),
      torch.full((1, 2, 1), 0.5, device=dev),
      torch.full((1, 2, N_HARMONICS), 1.0 / N_HARMONICS, device=dev),
      torch.zeros((1, 1, 1), device=dev), n_samples=VST_HOPS * VST_HOP,
      sample_rate=SR)
  cont_err = (streamed - whole[0]).abs().max().item()
  phase_err = abs(np.angle(np.exp(1j * (phase.double().item() -
                                        whole_phase.double().item()))))
  edges = torch.diff(streamed).abs()
  print(f'  phase carry: {VST_HOPS} streamed hops vs one synthesis of '
        f'{VST_HOPS * VST_HOP} samples: max |err| {cont_err:.3e} (atol '
        f'{VST_CONTINUITY_ATOL}), final phase {phase.item():.4f} rad, '
        f'{phase_err:.3e} rad from the whole span\'s (mod 2 pi); largest '
        f'step at a hop edge {edges[VST_HOP - 1::VST_HOP].max().item():.4f}, '
        f'within hops {edges.max().item():.4f}', flush=True)
  check(cont_err <= VST_CONTINUITY_ATOL,
        f'streamed hops match one synthesis within {VST_CONTINUITY_ATOL}: no '
        'phase jump at the hop edges')

  # The angular cumsum over the span on the card: phase_cumsum's float64
  # sums, and float32 sums (torch.cumsum of float32 on the card) in the
  # same chunked scheme, against a float64 phase.
  omega = torch.full((1, VST_HOPS * VST_HOP, 1), 440.0 * 2 * np.pi / SR,
                     device=dev)
  exact = torch.cumsum(omega.double(), dim=1)
  cumsum_err = {}
  for name, phase64 in (
      ('float64 sums', osc.angular_cumsum(omega).double()),
      ('float32 sums', angular_cumsum_float32(torch, omega).double())):
    apart = torch.remainder(phase64 - exact + np.pi, 2 * np.pi) - np.pi
    cumsum_err[name] = apart.abs().max().item()
  print(f'  angular cumsum of {VST_HOPS * VST_HOP} samples at 440 Hz on the '
        f"card: {cumsum_err['float64 sums']:.3e} rad from a float64 phase "
        f"(ops/oscillator.py); float32 sums {cumsum_err['float32 sums']:.3e}"
        ' rad', flush=True)
  check(cumsum_err['float64 sums'] <= VST_CUMSUM_ATOL,
        f'angular_cumsum on the card within {VST_CUMSUM_ATOL} rad of a '
        'float64 phase')

  # The same 250 hops through the port on the CPU.
  ref = run(cpu, False)
  state_err = (stream['state'].cpu() - ref['state']).abs().max().item()
  out, want = stream['audio'].cpu().flatten(), ref['audio'].flatten()
  stream_rel = ((out - want).norm() / want.norm()).item()
  phase_apart = abs(stream['phase'].item() - ref['phase'].item())
  print(f'  GPU vs CPU port over {VST_HOPS} hops: state max |err| '
        f'{state_err:.3e} (atol {VST_STATE_ATOL}), stream relative L2 '
        f'{stream_rel:.3e} (rtol {VST_STREAM_REL_L2}), carried phase '
        f'{phase_apart:.3e} rad apart', flush=True)
  check(state_err <= VST_STATE_ATOL,
        f'the streamed state within {VST_STATE_ATOL} of the CPU port')
  check(stream_rel <= VST_STREAM_REL_L2,
        f'the streamed audio within relative L2 {VST_STREAM_REL_L2} of the '
        'CPU port')

  # The whole clip: the vst model (bf16, with its reverb) from audio and f0.
  clip = {}
  params = load_params(export_dir)
  gen = torch.Generator().manual_seed(5)
  noise = {'filtered_noise': torch.rand((1, VST_CLIP_SAMPLES),
                                        generator=gen) * 2 - 1,
           'reverb': torch.rand((1, reverb_length), generator=gen) * 2 - 1}
  features = {'audio': torch.from_numpy(vst_tone(VST_CLIP_SAMPLES))[None],
              'f0_hz': torch.full((1, VST_CLIP_FRAMES), 440.0),
              'f0_confidence': torch.ones((1, VST_CLIP_FRAMES))}
  for name, d in (('cuda', dev), ('cpu', torch.device('cpu'))):
    model = registry.model_from_spec(export_dir, device='cpu')
    load_jax_params(model, params)
    model.to(d).eval()
    reset_launches()
    with torch.no_grad():
      clip[name] = model({k: v.to(d) for k, v in features.items()},
                         training=False,
                         noise={k: v.to(d) for k, v in noise.items()})
    if name == 'cuda':
      torch.cuda.synchronize()
      clip_launches = read_launches()
      clip_coop = kg.launches['fwd_cooperative'] + kg.launches['fwd_step']
  out = clip['cuda']['audio_synth'].cpu()
  want = clip['cpu']['audio_synth']
  clip_rel = ((out - want).norm() / want.norm()).item()
  print(f'  whole clip ({VST_CLIP_SAMPLES} samples, {VST_CLIP_FRAMES} '
        f'frames): audio {tuple(out.shape)}, launches {clip_launches}, K2f '
        f'on a float32 route {clip_coop}; GPU vs CPU port relative '
        f'L2 {clip_rel:.3e}', flush=True)
  print(f'  (K1f: the clip\'s Harmonic renders {VST_CLIP_SAMPLES} samples '
        f'from {VST_CLIP_FRAMES} frames, not a whole number of samples a '
        'frame, so it takes the plain path, as the JAX package takes its '
        'jnp path: harmonic_kernel_supported is False there)')
  check(tuple(out.shape) == (1, VST_CLIP_SAMPLES - VST_HOP) and
        torch.isfinite(out).all().item() and out.abs().max().item() > 0,
        f'the whole clip after Crop is [1, {VST_CLIP_SAMPLES - VST_HOP}], '
        'finite, not all zero')
  check(clip_launches['K2f'] == 1 and clip_coop == 0 and
        clip_launches['K1f'] == 0,
        'the whole clip launches K2f once, on the bf16 cluster route, and '
        'no K1f')
  check(clip_rel <= E2E_REL_L2,
        f'the whole clip on the card within relative L2 {E2E_REL_L2} of the '
        'CPU port')

  from ddsp_torch.nn.preprocessing import scale_f0_hz
  last_hop = (scale_f0_hz(torch.full((1,), 440.0, device=dev)),
              gpu['extract'](gpu['frames'][-1])[3], stream['state'])
  entry = k2f_one_hop_entry(torch, dev, gpu['predict'], last_hop, launches)
  return launches, entry


# Phase 4c: the VST path with its own f0 (CREPE, ops/crepe.py) and CREPE's
# precision on the card. CREPE's activations on the card against the port
# on the CPU: the same float32 convolutions in another order (cuDNN's
# algorithms, oneDNN's; ~1e-7 between XLA and oneDNN on the CPU); TF32
# convolutions would round each product to a 10-bit mantissa and move the
# activations by ~1e-3, so 1e-4 tells the two apart.
CREPE_FRAMES = 1000
CREPE_ACT_ATOL = 1e-4
# f0 of the streamed 440 Hz tone: the plugin's pitch, within 20 cents.
VST_F0_CENTS = 20.0
# The extracted features hop by hop against the CPU port: CREPE's f0 from
# activations within CREPE_ACT_ATOL, decoded to cents (a weighted mean of
# 10 bins, the tests' 1-cent tier), and the frame's power in dB (a mean of
# squares in another order, tests/test_torch_vst.py's 1e-4 dB).
VST_F0_CPU_CENTS = 1.0
VST_POWER_ATOL_DB = 1e-4


def cents_apart(a, b):
  return np.abs(1200.0 * np.log2(np.asarray(a, np.float64) /
                                 np.asarray(b, np.float64)))


def phase_crepe_precision(torch, dev):
  """CREPE's activations on CREPE_FRAMES frames on the card, with TF32
  turned on for the process around the call, against the port on the CPU;
  CREPE pins full float32 itself (ops/crepe.py full_float32). The same
  network without the pin, TF32 on, is printed beside it."""
  from ddsp_torch.ops import crepe
  print(f'[4c] CREPE on the card: {CREPE_FRAMES} frames, TF32 on around '
        'the call', flush=True)
  hop = 160
  n = crepe.CREPE_FRAME_SIZE + (CREPE_FRAMES - 1) * hop
  t = np.arange(n) / SR
  f0 = 110.0 * 2**(3 * t / t[-1])  # three octaves up
  rng = np.random.RandomState(9)
  audio = (0.3 * np.sin(2 * np.pi * np.cumsum(f0) / SR) +
           0.01 * rng.randn(n)).astype(np.float32)[None]
  gpu = crepe.PretrainedCrepe(hop_size=hop)
  cpu = crepe.PretrainedCrepe(hop_size=hop, device='cpu')
  cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
  saved = (cudnn.allow_tf32, matmul.allow_tf32)
  try:
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    acts = gpu.activations(torch.from_numpy(audio).to(dev))
    flags_after = (cudnn.allow_tf32, matmul.allow_tf32)
    frames = gpu.normalize_frames(gpu.batch_frames(
        torch.from_numpy(audio).to(dev)))
    with torch.no_grad():
      unpinned = gpu.model(frames)
    ms = device_ms(torch, lambda: gpu.activations(
        torch.from_numpy(audio).to(dev)), 20)
  finally:
    cudnn.allow_tf32, matmul.allow_tf32 = saved
  want = cpu.activations(torch.from_numpy(audio))
  err = (acts.cpu() - want).abs().max().item()
  tf32_err = (unpinned.cpu() - want[0]).abs().max().item()
  print(f'  activations {tuple(acts.shape)}: max |err| against the CPU port '
        f'{err:.3e} (atol {CREPE_ACT_ATOL}); the network without the pin, '
        f'TF32 on: {tf32_err:.3e}; {ms:.4f} ms device per '
        f'{CREPE_FRAMES} frames', flush=True)
  check(tuple(acts.shape) == (1, CREPE_FRAMES, 360) and
        torch.isfinite(acts).all().item(),
        f'CREPE activations [1, {CREPE_FRAMES}, 360], finite')
  check(flags_after == (True, True),
        "CREPE restored the process's TF32 settings after its call")
  check(err <= CREPE_ACT_ATOL,
        f'CREPE on the card with TF32 on for the process within '
        f'{CREPE_ACT_ATOL} of the CPU port (it runs full float32 itself)')


def vst_stream_own_f0(torch, dev, extract, predict, synth, frames):
  """Stream `frames` [n, 1024] through extract (CREPE on) -> stateless
  predict -> synth, each hop's f0 from the extractor. Returns {'f0': [Hz],
  'pw_db': [dB], 'audio': [n, 320], 'controls': [(amps, hd, noise,
  state)], 'ms': [ms per hop], 'extract_ms': [ms per extract,
  synchronized]}; one synchronization per hop, as a plugin hands its audio
  over."""
  state = predict.initial_state()
  phase = synth.initial_phase()
  prev = None
  out = {'f0': [], 'pw_db': [], 'audio': [], 'ms': [], 'extract_ms': [],
         'controls': []}
  for frame in frames:
    t0 = time.perf_counter()
    f0_hz, f0_scaled, pw_db, pw_scaled = extract(frame)
    amps, hd, noise, state = predict(f0_scaled, pw_scaled, state)
    out['controls'].append((amps, hd, noise, state))
    if prev is None:
      prev = (amps, hd, f0_hz)
    hop, phase = synth(amps, prev[0], hd, prev[1], f0_hz, prev[2], noise,
                       phase)
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    out['ms'].append(1e3 * (time.perf_counter() - t0))
    prev = (amps, hd, f0_hz)
    out['f0'].append(f0_hz)
    out['pw_db'].append(pw_db)
    out['audio'].append(hop)
  for frame in frames[:50]:
    t0 = time.perf_counter()
    extract(frame)
    if dev.type == 'cuda':
      torch.cuda.synchronize()
    out['extract_ms'].append(1e3 * (time.perf_counter() - t0))
  out['f0'] = torch.stack(out['f0']).cpu().numpy()
  out['pw_db'] = torch.stack(out['pw_db']).cpu().numpy()
  out['audio'] = torch.stack(out['audio'])
  return out


def phase_vst_f0(torch, dev, export_dir):
  """[4c] The vst preset streamed with its own f0: VSTExtractFeatures()
  (CREPE on, no Viterbi) -> VSTStatelessPredictControls -> VSTSynthesize
  over VST_HOPS hops of a 440 Hz tone (phase 4b's export)."""
  from ddsp_torch import infer
  from ddsp_torch.kernels import gru as kg
  print(f'[4c] VST streaming with CREPE f0: {VST_HOPS} hops of a 440 Hz '
        'tone', flush=True)
  tone = vst_tone(VST_FRAME + (VST_HOPS - 1) * VST_HOP)
  frames = np.stack([tone[i * VST_HOP:i * VST_HOP + VST_FRAME]
                     for i in range(VST_HOPS)])
  sides = {}
  for name, d in (('cuda', dev), ('cpu', torch.device('cpu'))):
    sides[name] = {
        'extract': infer.VSTExtractFeatures(export_dir, device=d),
        'predict': infer.VSTStatelessPredictControls(export_dir, device=d),
        'synth': infer.VSTSynthesize(export_dir, device=d),
        'frames': torch.from_numpy(frames).to(d)}
  gpu, cpu = sides['cuda'], sides['cpu']
  cpu['synth'].noise_signal = gpu['synth'].noise_signal.cpu()
  run = lambda side, d, n=None: vst_stream_own_f0(
      torch, d, side['extract'], side['predict'], side['synth'],
      side['frames'][:n])
  run(gpu, dev, VST_WARMUP_HOPS)  # warm-up: cuDNN's plans, K2f's
  reset_launches()
  stream = run(gpu, dev)
  torch.cuda.synchronize()
  launches = read_launches()
  n_step = kg.launches['fwd_step']
  ref = run(cpu, torch.device('cpu'))
  voiced = stream['pw_db'] > -60.0
  off = cents_apart(stream['f0'][voiced], 440.0)
  cpu_cents = cents_apart(stream['f0'], ref['f0']).max()
  pw_err = np.abs(stream['pw_db'] - ref['pw_db']).max()
  crepe_model = gpu['extract'].preprocessor.crepe
  one = gpu['frames'][:1]
  crepe_ms = device_ms(torch, lambda: crepe_model.predict_f0_and_confidence(
      one, padding='valid'), 100)
  print(f'  launches over {VST_HOPS} hops: {launches}, K2f on the step '
        f'kernel {n_step}')
  print(f'  f0: median {np.median(stream["f0"]):.3f} Hz, {voiced.sum()} '
        f'voiced hops, at most {off.max():.3f} cents from 440 Hz (limit '
        f'{VST_F0_CENTS}); against the CPU port: f0 {cpu_cents:.4f} cents '
        f'(limit {VST_F0_CPU_CENTS}), power {pw_err:.3e} dB (atol '
        f'{VST_POWER_ATOL_DB})')
  print('  per hop, ' + latency_line('total with CREPE, one synchronization '
                                     'per hop', stream['ms']) +
        f'; the hop period is {VST_HOP_PERIOD_MS:.1f} ms')
  print('  per hop, ' + latency_line('extract alone (CREPE + power), '
                                     'synchronized', stream['extract_ms']) +
        f'; CREPE {crepe_ms:.4f} ms device a hop', flush=True)
  check(voiced.sum() == VST_HOPS and off.max() <= VST_F0_CENTS,
        f'every hop of the tone is voiced and its f0 within {VST_F0_CENTS} '
        'cents of 440 Hz')
  check(cpu_cents <= VST_F0_CPU_CENTS and pw_err <= VST_POWER_ATOL_DB,
        f'the extracted f0 within {VST_F0_CPU_CENTS} cents and the power '
        f'within {VST_POWER_ATOL_DB} dB of the CPU port, hop for hop')
  audio = stream['audio']
  check(tuple(audio.shape) == (VST_HOPS, VST_HOP) and
        torch.isfinite(audio).all().item() and audio.abs().max().item() > 0,
        f'the streamed hops [{VST_HOPS}, {VST_HOP}], finite, not all zero')
  check(launches['K2f'] == n_step == VST_HOPS and
        all(launches[k] == 0 for k in ('K1f', 'K1t', 'K1p', 'K2b', 'K2b_w',
                                       'K3')),
        'K2f once a hop on its step kernel, no other kernel (CREPE and the '
        'synth are plain torch, as the JAX package computes them)')
  return launches


# Phases 4d and 4e: the exported programs (infer/export.py,
# fmt='torch_export'), loaded with load_program and served on the card.
# The program against the eager classes on the card: the same kernels on
# the same operands, the rest of the graph as aten ops; the graph may run a
# composite op as its decomposition (a linear as mm + add), which rounds
# the last float32 bits otherwise. Audio and controls are ~1e-1; a float32
# rounding there is ~1e-8, a few of them through the decoder's stacks ~1e-6.
PROGRAM_ATOL = 1e-5
# The streamed VST controls and audio of the programs against the eager
# classes', 250 hops with the GRU state carried through the program: the
# same per-hop rounding carried by the state (a contraction), no growth.
VST_PROGRAM_ATOL = 1e-4
PROGRAM_TIMED_CALLS = 20
DISPATCH_CALLS = 200


def graph_ops(program):
  """{op name: nodes} of the program's graph, and its node count."""
  ops = {}
  for node in program.program.graph.nodes:
    if node.op == 'call_function':
      ops[str(node.target)] = ops.get(str(node.target), 0) + 1
  return ops, len(program.program.graph.nodes)


def host_ms_per_call(torch, fn, n):
  """Median host ms per call of fn over n calls, synchronized every call."""
  times = []
  for _ in range(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
  return float(np.median(times))


def op_dispatch_ms(torch, dev):
  """Host ms per call of each forward op beside its launch function called
  directly (the wrappers' path before the ops), in turns, at a request's
  K1f shape and a hop's K2f shape: the cost of the op's dispatch."""
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import harmonic as kh
  phase0, f0_env, ham = k1_inputs(torch, 1, N_FRAMES, 3, dev)
  xp, wh, bn, h0 = k2_inputs(torch, 1, torch.float32, 4, dev, HIDDEN, 1)
  pairs = {
      'K1f (B = 1, 64000 samples)': (
          lambda: kh.harmonic_fwd(phase0, f0_env, ham, float(SR), 'window'),
          lambda: kh._launch('fwd', (phase0, f0_env, ham),
                             torch.empty_like(phase0), N_FRAMES,
                             N_HARMONICS, SR, 'window')),
      'K2f step (T = 1, B = 1, H = 512)': (
          lambda: kg.gru_fwd(xp, wh, bn, h0),
          lambda: kg._launch_fwd(xp, wh, bn, h0))}
  for name, (op, direct) in pairs.items():
    runs = {'op': [], 'direct': []}
    for which in ('direct', 'op', 'op', 'direct'):
      fn = op if which == 'op' else direct
      runs[which].append(host_ms_per_call(torch, fn, DISPATCH_CALLS))
    print(f'  dispatch, {name}: host ms per call through the op '
          f'{runs["op"]}, the launch function called directly '
          f'{runs["direct"]} (medians of {DISPATCH_CALLS} calls, '
          'synchronized each; two turns each)', flush=True)


def phase_program(torch, dev, export_dir, port, reqs):
  """[4d] autoencoder.pt2 of phase 4's export (full-width solo_instrument,
  reverb kept), exported on the card, loaded and served: phase 4's four
  requests through the program."""
  from ddsp_torch.infer import export as ex
  print('[4d] torch.export program of the autoencoder, on the card',
        flush=True)
  t0 = time.time()
  path = ex.export_model(export_dir, os.path.join(export_dir, 'program'),
                         fmt='torch_export', length_seconds=4,
                         remove_reverb=False)
  export_s = time.time() - t0
  t0 = time.time()
  program = ex.load_program(path)
  load_s = time.time() - t0
  ops, n_nodes = graph_ops(program)
  mine = {k: v for k, v in ops.items() if k.startswith('ddsp_torch.')}
  print(f'  exported in {export_s:.2f} s ({os.path.getsize(path) / 1e6:.2f} '
        f'MB), loaded in {load_s:.2f} s; {n_nodes} graph nodes, the kernels '
        f'{mine}')
  check(mine == {'ddsp_torch.harmonic_fwd.default': 1,
                 'ddsp_torch.gru_fwd.default': 1},
        'the program holds one harmonic_fwd and one gru_fwd node')
  inputs = [tuple(torch.from_numpy(r[k])[None, :, None].to(dev)
                  for k in ('f0_hz', 'loudness_db')) for r in reqs]
  program(*inputs[0])  # warm-up, not counted
  reset_launches()
  audio = [program(*x) for x in inputs]
  torch.cuda.synchronize()
  launches = read_launches()
  print(f'  launches over {len(reqs)} requests: {launches}')
  check(launches['K1f'] == launches['K2f'] == len(reqs),
        'K1f and K2f launched once per request inside the program')
  check(all(launches[k] == 0 for k in ('K1t', 'K1p', 'K2b', 'K2b_w', 'K3')),
        'the program launches no backward kernel')
  eager = [port.get_audio(r) for r in reqs]
  errs = [(a - e).abs().max().item() for a, e in zip(audio, eager)]
  print(f'  program against the eager class on the card (the same baked '
        f'noise): max |diff| per request {errs}')
  check(all(tuple(a.shape) == (1, N_SAMPLES) and
            torch.isfinite(a).all().item() for a in audio) and
        max(errs) <= PROGRAM_ATOL,
        f'the program renders the eager audio within {PROGRAM_ATOL}')
  # The CPU port with the same noise.
  from ddsp_torch.infer import AutoencoderInference
  cpu_port = AutoencoderInference(export_dir, length_seconds=4,
                                  remove_reverb=False, device='cpu')
  noise = {k: v.cpu() for k, v in ex.autoencoder_noise(port).items()}
  out_cpu = cpu_port(reqs[1], noise=noise)['audio_synth']
  rel = ((audio[1].cpu() - out_cpu).norm() / out_cpu.norm()).item()
  print(f'  program on the card against the CPU port, request 1: relative '
        f'L2 {rel:.3e}')
  check(rel <= E2E_REL_L2, f'the program within {E2E_REL_L2} of the CPU '
        'port')
  ms = {'eager': [], 'program': []}
  for which in ('eager', 'program', 'program', 'eager'):
    fn = ((lambda: port.get_audio(reqs[1])) if which == 'eager' else
          (lambda: program(*inputs[1])))
    ms[which].append(host_ms_per_call(torch, fn, PROGRAM_TIMED_CALLS))
  print(f'  ms per 4 s request (host clock, synchronized, median of '
        f'{PROGRAM_TIMED_CALLS} calls, two turns each): program '
        f'{ms["program"]}, eager {ms["eager"]}', flush=True)
  op_dispatch_ms(torch, dev)
  return launches


def phase_vst_programs(torch, dev, export_dir):
  """[4e] The six VST programs of phase 4b's export, exported on the card
  and loaded; phase 4b's tone streamed for VST_HOPS hops through
  vst_extract_features (CREPE) -> vst_stateless_predict_controls ->
  vst_synthesize against the eager classes; vst_predict_controls and the
  harmonic and noise programs against theirs; CREPE's pin with TF32 on."""
  from ddsp_torch import infer
  from ddsp_torch.infer import export as ex
  from ddsp_torch.kernels import gru as kg
  print(f'[4e] the six VST programs, on the card: {VST_HOPS} hops',
        flush=True)
  programs = {}
  for name in ex.INFERENCE_MODELS[1:]:
    t0 = time.time()
    path = ex.export_model(export_dir, os.path.join(export_dir, 'programs'),
                           fmt='torch_export', inference_model=name)
    programs[name] = ex.load_program(path)
    ops, n_nodes = graph_ops(programs[name])
    print(f'  {name}: exported and loaded in {time.time() - t0:.2f} s, '
          f'{n_nodes} graph nodes, '
          f'{ {k: v for k, v in ops.items() if "ddsp" in k} }', flush=True)
  eager = {'extract': infer.VSTExtractFeatures(export_dir),
           'predict': infer.VSTStatelessPredictControls(export_dir),
           'synth': infer.VSTSynthesize(export_dir)}
  prog = {'extract': programs['vst_extract_features'],
          'predict': programs['vst_stateless_predict_controls'],
          'synth': programs['vst_synthesize']}
  prog['predict'].initial_state = eager['predict'].initial_state
  prog['synth'].initial_phase = eager['synth'].initial_phase
  tone = vst_tone(VST_FRAME + (VST_HOPS - 1) * VST_HOP)
  frames = torch.from_numpy(np.stack([
      tone[i * VST_HOP:i * VST_HOP + VST_FRAME]
      for i in range(VST_HOPS)])).to(dev)
  run = lambda side, n=None: vst_stream_own_f0(
      torch, dev, side['extract'], side['predict'], side['synth'],
      frames[:n])
  run(prog, VST_WARMUP_HOPS)  # warm-up, not counted
  run(eager, VST_WARMUP_HOPS)
  reset_launches()
  stream = run(prog)
  torch.cuda.synchronize()
  launches = read_launches()
  n_step = kg.launches['fwd_step']
  ref = run(eager)
  print(f'  launches over {VST_HOPS} hops of the programs: {launches}, K2f '
        f'on the step kernel {n_step}')
  check(launches['K2f'] == n_step == VST_HOPS and
        all(launches[k] == 0 for k in ('K1f', 'K1t', 'K1p', 'K2b', 'K2b_w',
                                       'K3')),
        'K2f once a hop on its step kernel inside the predict program, no '
        'other kernel')
  apart = {'f0 cents': cents_apart(stream['f0'], ref['f0']).max(),
           'audio': (stream['audio'] - ref['audio']).abs().max().item()}
  for i, part in enumerate(('amps', 'hd', 'noise', 'state')):
    apart[part] = max((a[i] - b[i]).abs().max().item() for a, b in zip(
        stream['controls'], ref['controls']))
  print(f'  programs against the eager classes, whole clip: max |diff| '
        f'{apart}')
  check(apart['f0 cents'] <= VST_F0_CPU_CENTS and
        max(v for k, v in apart.items() if k != 'f0 cents') <=
        VST_PROGRAM_ATOL,
        f'the streamed controls and audio of the programs within '
        f'{VST_PROGRAM_ATOL} of the eager classes, f0 within '
        f'{VST_F0_CPU_CENTS} cents')
  ms = {'eager': [], 'program': []}
  for which in ('eager', 'program', 'program', 'eager'):
    side = eager if which == 'eager' else prog
    ms[which].append(float(np.median(run(side, 50)['ms'])))
  print(f'  per hop, median ms over 50 hops, one synchronization a hop, two '
        f'turns each: programs {ms["program"]}, eager {ms["eager"]}')

  # The stateful name exports the stateless signature; the harmonic and
  # noise programs against their eager classes on the stream's controls.
  state = eager['predict'].initial_state()
  stateful = programs['vst_predict_controls']
  same = True
  for (amps, hd, noise, want_state), frame in zip(stream['controls'][:20],
                                                  frames[:20]):
    _, f0_scaled, _, pw_scaled = prog['extract'](frame)
    out = stateful(f0_scaled, pw_scaled, state)
    same &= all(torch.equal(a, b) for a, b in zip(
        out, prog['predict'](f0_scaled, pw_scaled, state)))
    state = out[3]
  check(same, 'vst_predict_controls.pt2 repeats the stateless program bit '
        'for bit over 20 hops')
  f0 = torch.full((1,), 440.0, device=dev)
  amps, hd, noise, _ = stream['controls'][5]
  phase = torch.full((1,), 1.25, device=dev)
  for name, cls, args in (
      ('vst_synthesize_harmonic', infer.VSTSynthesizeHarmonic,
       (amps, amps, hd, hd, f0, f0, phase)),
      ('vst_synthesize_noise', infer.VSTSynthesizeNoise, (noise,))):
    got, want = programs[name](*args), cls(export_dir)(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f'  {name}: max |diff| against the eager class {err:.3e}')
    check(err <= PROGRAM_ATOL, f'{name}.pt2 within {PROGRAM_ATOL} of its '
          'eager class')

  # CREPE's pin in the program: TF32 on for the process around the calls.
  extract = prog['extract']
  cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
  saved = (cudnn.allow_tf32, matmul.allow_tf32)
  try:
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    pinned = torch.stack([extract(f)[0] for f in frames]).cpu().numpy()
    with torch.no_grad():
      bare = torch.stack([extract.module(f)[0]
                          for f in frames]).cpu().numpy()
    flags_after = (cudnn.allow_tf32, matmul.allow_tf32)
  finally:
    cudnn.allow_tf32, matmul.allow_tf32 = saved
  pinned_cents = cents_apart(pinned, ref['f0']).max()
  bare_cents = cents_apart(bare, ref['f0']).max()
  print(f'  vst_extract_features.pt2 with TF32 on for the process: f0 '
        f'{pinned_cents:.4f} cents from the eager class (limit '
        f'{VST_F0_CPU_CENTS}); its graph called without the pin: '
        f'{bare_cents:.4f} cents', flush=True)
  check(flags_after == (True, True) and pinned_cents <= VST_F0_CPU_CENTS,
        'the extract program keeps CREPE in full float32 with TF32 on and '
        "restores the process's settings")
  return launches


def phase_chain(torch, dev):
  """Harmonic(60) + FilteredNoise(65) + Add + Reverb(48000), batch 16, 4 s:
  forward and the gradient with respect to every control, f0_hz included,
  so the phase needs a gradient and K1p runs."""
  from ddsp_torch import proc
  print('[5] synthesis chain forward + gradient wrt all controls (K1p)',
        flush=True)
  group = proc.ProcessorGroup([
      (proc.Harmonic(n_samples=N_SAMPLES, sample_rate=SR,
                     use_angular_cumsum=True, name='harmonic'),
       ['amps', 'harmonic_distribution', 'f0_hz']),
      (proc.FilteredNoise(n_samples=N_SAMPLES, window_size=0,
                          name='filtered_noise'), ['noise_magnitudes']),
      (proc.Add(name='add'), ['filtered_noise/signal', 'harmonic/signal']),
      (proc.Reverb(trainable=True, reverb_length=REVERB_LENGTH,
                   name='reverb'), ['add/signal']),
  ]).to(dev)
  gen = torch.Generator(dev).manual_seed(21)
  controls = {
      'amps': torch.randn((BATCH, N_FRAMES, 1), generator=gen, device=dev),
      'harmonic_distribution': torch.randn((BATCH, N_FRAMES, N_HARMONICS),
                                           generator=gen, device=dev),
      'noise_magnitudes': torch.randn((BATCH, N_FRAMES, N_NOISE),
                                      generator=gen, device=dev),
      'f0_hz': 110.0 * 8.0**torch.rand((BATCH, N_FRAMES, 1), generator=gen,
                                       device=dev),
  }
  leaves = {k: v.requires_grad_() for k, v in controls.items()}
  noise_gen = torch.Generator(dev).manual_seed(22)

  def step():
    audio = group(leaves, generator=noise_gen)
    params = list(leaves.values()) + list(group.parameters())
    return audio, torch.autograd.grad(audio.pow(2).mean(), params)

  n_steps = 3
  reset_launches()
  for _ in range(n_steps):
    audio, grads = step()
  torch.cuda.synchronize()
  launches = read_launches()
  print(f'  launches over {n_steps} steps: {launches}')
  check(tuple(audio.shape) == (BATCH, N_SAMPLES) and
        torch.isfinite(audio).all().item(),
        f'chain audio [{BATCH}, {N_SAMPLES}], finite')
  for name, g in zip(list(leaves) + ['reverb.ir'], grads):
    check(torch.isfinite(g).all().item() and g.abs().max().item() > 0,
          f'chain gradient wrt {name} finite and non-zero')
  check(launches['K1f'] == launches['K1t'] == launches['K1p'] == n_steps,
        'K1f, K1t and K1p each launched once per chain step')
  ms = cuda_ms(torch, step, 10)
  print(f'  chain forward + gradient: {ms:.3f} ms per step, '
        f'{BATCH * N_SAMPLES / (ms / 1e3):.4e} audio samples/s')
  return launches, n_steps


def training_batch(batch=BATCH, seed=0):
  """Harmonic tones with a gliding f0 plus noise: 'audio' [B, 64000] and
  'f0_hz' [B, 1000] at 250 frames/s, made with numpy from a seed."""
  rng = np.random.RandomState(seed)
  t = np.arange(N_FRAMES) / 250.0
  f0 = 110.0 * 2.0**(2.0 * rng.rand(batch, 1) + 0.15 * np.sin(
      2 * np.pi * (0.5 + rng.rand(batch, 1)) * t[None]))
  phase = 2 * np.pi * np.cumsum(np.repeat(f0, N_SAMPLES // N_FRAMES, axis=1),
                                axis=1) / SR
  envelope = 0.5 + 0.4 * np.sin(2 * np.pi * 0.7 * np.arange(N_SAMPLES) / SR)
  audio = sum(0.25 / h * np.sin(h * phase) for h in range(1, 9))
  audio = envelope[None] * audio + 0.01 * rng.randn(batch, N_SAMPLES)
  return {'audio': audio.astype(np.float32), 'f0_hz': f0.astype(np.float32)}


def one_step_gradients(torch, model, batch, noise):
  """(total_loss, {name: grad}) of one training step's forward/backward."""
  _, losses = model(batch, training=True, return_losses=True, noise=noise)
  names = [k for k, _ in model.named_parameters()]
  grads = torch.autograd.grad(losses['total_loss'],
                              [p for _, p in model.named_parameters()])
  return losses['total_loss'].item(), dict(zip(names, grads))


def global_norm(torch, grads, part=''):
  """The float64 norm of the gradients whose names hold `part`."""
  return float(torch.sqrt(sum(g.double().pow(2).sum()
                              for k, g in grads.items() if part in k)))


def flat_grads(torch, grads, part):
  """The gradients whose names start with `part`, flattened into one
  float64 vector on the host."""
  return torch.cat([g.double().flatten().cpu() for k, g in grads.items()
                    if k.startswith(part)])


def rel_l2(a, b):
  """|a - b| / |b| in float64."""
  return ((a.double() - b.double()).norm() / b.double().norm()).item()


def audible_ir(torch):
  """An audible reverb IR (seed 6), so the reverb's path carries signal."""
  ir = 0.02 * torch.randn(REVERB_LENGTH,
                          generator=torch.Generator().manual_seed(6))
  return ir * torch.exp(-torch.arange(REVERB_LENGTH) / 8000.0)


def step_gradients(torch, model, batch, noise, mesh=None):
  """One training step's (total_loss, {name: grad}): dense, or on `mesh`."""
  if mesh is None:
    return one_step_gradients(torch, model, batch, noise)
  return sp_step_gradients(torch, model, batch, noise, mesh)


def mag_only_losses(torch, model):
  """The model's SpectralLoss with its mag term only (sizes, dtype kept)."""
  from ddsp_torch.losses import SpectralLoss
  loss = model.losses[0]
  return torch.nn.ModuleList([SpectralLoss(
      fft_sizes=loss.fft_sizes, loss_type=loss.loss_type,
      compute_dtype=loss.compute_dtype, mag_weight=loss.mag_weight)])


def reverb_chain(torch, model, dry, target, mesh=None, cotangent=None):
  """The model's reverb, then its loss (all terms), on a given dry signal,
  dense or time-sharded on `mesh`: (loss, d loss / d wet, d loss / d ir,
  and the reverb's pullback of `cotangent` to the IR, if given)."""
  from ddsp_torch.parallel import sp_model
  reverb = model.processor_group.reverb
  controls = reverb.get_controls(dry.detach())
  loss_obj = model.losses[0]
  if mesh is None:
    wet = reverb.get_signal(**controls)
    loss = loss_obj(target, wet)
  else:
    wet = sp_model._sp_get_signal(reverb, controls, mesh, 'pallas')  # pylint: disable=protected-access
    loss = sp_model._sp_loss(loss_obj, target, wet, mesh, 'pallas')  # pylint: disable=protected-access
  g_wet, g_ir = torch.autograd.grad(loss, [wet, reverb.ir],
                                    retain_graph=cotangent is not None)
  pulled = None
  if cotangent is not None:
    (pulled,) = torch.autograd.grad(wet, [reverb.ir], cotangent)
  return loss.item(), g_wet, g_ir, pulled


def phase_errors_rad(torch, batch, dev):
  """Max |phase - float64 cumsum| (rad) of this batch's phase, as the
  Harmonic synth forms it (ops/oscillator.py), summed on `dev` by a plain
  float32 cumsum and by the port's phase_cumsum."""
  from ddsp_torch.ops.oscillator import phase_cumsum
  from ddsp_torch.ops.resample import resample
  f0 = resample(batch['f0_hz'].float()[..., None], N_SAMPLES)
  omega = f0 * 2 * np.pi / SR
  exact = torch.cumsum(omega.double(), dim=1)
  return tuple((fn(omega.to(dev)).cpu().double() - exact).abs().max().item()
               for fn in (lambda w: torch.cumsum(w, dim=1), phase_cumsum))


def check_ir_gradient(torch, dev, label, gpu_model, cpu_model, batch, noise,
                      grads_gpu, grads_cpu, meshes=(None, None)):
  """The reverb IR's gradient of a B = 2 step on the card against the CPU
  port (see IR_NAME): the full loss's printed; the mag term's whole step,
  and the reverb and the loss on one dry signal, held. meshes: (card mesh,
  CPU mesh) for the SP step."""
  from ddsp_torch.parallel import sp_forward_with_losses
  mesh_gpu, mesh_cpu = meshes
  on_dev = {k: v.to(dev) for k, v in batch.items()}
  ir_gpu, ir_cpu = grads_gpu[IR_NAME], grads_cpu[IR_NAME]
  pert = noise + NOISE_PERTURBATION * torch.randn(
      noise.shape, generator=torch.Generator().manual_seed(33))
  _, grads_pert = step_gradients(torch, gpu_model, on_dev, pert.to(dev),
                                 mesh_gpu)
  ir_pert = grads_pert[IR_NAME]
  outputs = {}
  with torch.no_grad():
    for where, model, feats, mesh, n in (
        ('cpu', cpu_model, batch, mesh_cpu, noise),
        ('gpu', gpu_model, on_dev, mesh_gpu, noise.to(dev))):
      if mesh is None:
        outputs[where], _ = model(feats, training=True, return_losses=True,
                                  noise=n)
      else:
        outputs[where], _ = sp_forward_with_losses(
            model, feats, mesh, halo_impl='pallas', noise=n)
  harm = rel_l2(outputs['gpu']['harmonic']['signal'].cpu(),
                outputs['cpu']['harmonic']['signal'])
  f32, port = phase_errors_rad(torch, batch, dev)
  print(f'  {label}: harmonic audio GPU vs CPU relative L2 {harm:.3e}; the '
        f'phase of this batch over {N_SAMPLES} samples on the card departs '
        f'from a float64 sum by {port:.3e} rad (phase_cumsum), {f32:.3e} '
        'rad summed in float32')
  print(f'  {label}: reverb IR gradient of the whole step, full loss (not '
        f'held, conditioned by the logmag term): norm GPU '
        f'{ir_gpu.norm():.5f} CPU {ir_cpu.norm():.5f}, relative L2 '
        f'{rel_l2(ir_gpu.cpu(), ir_cpu):.3e};'
        f' noise moved by {NOISE_PERTURBATION}: GPU norm '
        f'{ir_pert.norm():.5f}, relative L2 change {rel_l2(ir_pert, ir_gpu):.3e}')

  # The mag term only: the whole step.
  losses = {m: m.losses for m in (gpu_model, cpu_model)}
  try:
    for m in losses:
      m.losses = mag_only_losses(torch, m)
    _, mag_gpu = step_gradients(torch, gpu_model, on_dev, noise.to(dev),
                                mesh_gpu)
    _, mag_cpu = step_gradients(torch, cpu_model, batch, noise, mesh_cpu)
    errs = {'the CPU port': rel_l2(mag_gpu[IR_NAME].cpu(), mag_cpu[IR_NAME])}
    if mesh_gpu is not None:
      _, mag_dense = one_step_gradients(torch, gpu_model, on_dev,
                                        noise.to(dev))
      errs['the dense step on the card'] = rel_l2(mag_gpu[IR_NAME],
                                                  mag_dense[IR_NAME])
    print(f'  {label}, mag term only: reverb IR gradient of the whole step '
          f'norm GPU {mag_gpu[IR_NAME].norm():.5f} CPU '
          f'{mag_cpu[IR_NAME].norm():.5f}; relative L2 against ' +
          ', '.join(f'{k} {v:.3e}' for k, v in errs.items()))
    for against, err in errs.items():
      check(torch.isfinite(mag_gpu[IR_NAME]).all().item() and
            err <= IR_MAG_STEP_RTOL,
            f'{label}, mag term only: the reverb IR gradient of the whole '
            f'step within {IR_MAG_STEP_RTOL} of {against}')

    # Held: the mag term on the CPU's dry signal.
    dry = outputs['cpu']['add']['signal']
    _, _, mag_c, _ = reverb_chain(torch, cpu_model, dry, batch['audio'],
                                  mesh_cpu)
    _, _, mag_g, _ = reverb_chain(torch, gpu_model, dry.to(dev),
                                  on_dev['audio'], mesh_gpu)
  finally:
    for m, old in losses.items():
      m.losses = old
  mag_err = rel_l2(mag_g.cpu(), mag_c)
  print(f'  {label}, mag term only, on the dry signal of the CPU port: the '
        f'reverb IR gradient through the reverb and the loss on the card '
        f'departs by {mag_err:.3e} (relative L2)')
  check(torch.isfinite(mag_g).all().item() and mag_err <= IR_MAG_RTOL,
        f'{label}, mag term: the reverb IR gradient on the card within '
        f'{IR_MAG_RTOL} of the CPU port (one dry signal)')

  # Held: all terms on the CPU's dry signal.
  loss_c, g_wet_c, g_ir_c, _ = reverb_chain(torch, cpu_model, dry,
                                            batch['audio'], mesh_cpu)
  loss_g, g_wet_g, g_ir_g, pulled = reverb_chain(
      torch, gpu_model, dry.to(dev), on_dev['audio'], mesh_gpu,
      cotangent=g_wet_c.to(dev))
  pull_err = rel_l2(pulled.cpu(), g_ir_c)
  print(f'  {label}, all terms, on the dry signal of the CPU port: loss GPU '
        f'{loss_g:.6f} CPU {loss_c:.6f}; the reverb on the card pulls the '
        f'CPU cotangent back to the IR within {pull_err:.3e} (relative L2); '
        f'the IR gradient of the card alone departs by '
        f'{rel_l2(g_ir_g.cpu(), g_ir_c):.3e} and its d loss / d wet by '
        f'{rel_l2(g_wet_g.cpu(), g_wet_c):.3e} (not held: the logmag term)')
  check(abs(loss_g - loss_c) <= IR_CHAIN_LOSS_RTOL * abs(loss_c),
        f'{label}, all terms: the loss of one dry signal on the card within '
        f'{IR_CHAIN_LOSS_RTOL} of the CPU port')
  check(torch.isfinite(pulled).all().item() and pull_err <= IR_PULLBACK_RTOL,
        f'{label}, all terms: the reverb IR gradient through the reverb on '
        f'the card within {IR_PULLBACK_RTOL} of the CPU port (one dry '
        'signal, the CPU loss cotangent)')


def phase_train(torch, dev, work_dir, profile):
  from ddsp_torch.train import Trainer, train
  from ddsp_torch.utils import build_model
  print(f'[6] train solo_instrument (full width, bf16, batch {BATCH} x 4 s, '
        f'{TRAIN_STEPS} steps)', flush=True)
  batch = training_batch()
  model = build_model('solo_instrument', seed=0)
  trainer = Trainer(model, seed=0)
  save_dir = os.path.join(work_dir, 'train')
  reset_launches()
  state = train(itertools.repeat(batch), trainer, num_steps=TRAIN_STEPS,
                steps_per_summary=1, steps_per_save=TRAIN_STEPS,
                save_dir=save_dir)
  torch.cuda.synchronize()
  launches = read_launches()
  with open(os.path.join(save_dir, 'metrics.jsonl')) as f:
    losses = [json.loads(line)['total_loss'] for line in f]
  print(f'  {trainer.param_count(state)} parameters; launches over '
        f'{TRAIN_STEPS} steps: {launches}')
  print(f'  total_loss per step: {[round(l, 3) for l in losses]}')
  check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS,
        f'train() took {TRAIN_STEPS} steps')
  check(all(np.isfinite(losses)), 'every loss is finite')
  first, last = np.mean(losses[:5]), np.mean(losses[-5:])
  print(f'  mean loss, first five steps {first:.4f}, last five {last:.4f}')
  check(last < first, 'the loss falls: last five steps below the first five')
  check(all(launches[k] == TRAIN_STEPS
            for k in ('K1f', 'K1t', 'K2f', 'K2b', 'K2b_w')),
        'K1f, K1t, K2f, K2b and its weight-gradient pass each launched once '
        'per training step')
  check(launches['K1p'] == 0, 'K1p launched no time (f0 is data)')

  # Checkpoint round trip: another trainer restores the final checkpoint
  # and takes the same next step.
  state, next_losses = trainer.train_step(state, batch)
  other = Trainer(build_model('solo_instrument', seed=5), seed=0)
  restored = other.restore(other.init(), save_dir)
  check(restored.step == TRAIN_STEPS, 'the checkpoint restores its step')
  _, losses_again = other.train_step(restored, batch)
  a, b = next_losses['total_loss'].item(), losses_again['total_loss'].item()
  print(f'  next-step loss {a:.6f}, after save and restore {b:.6f}')
  check(abs(a - b) <= 1e-5 * abs(a),
        'a restored checkpoint gives the same next-step loss (rtol 1e-5)')

  # One step on the card against the port on the CPU, B = 2, same
  # parameters and noise; every parameter's gradient is finite and the
  # decoder's are non-zero.
  small = {k: torch.as_tensor(v[:2]) for k, v in batch.items()}
  noise = torch.rand((2, N_SAMPLES),
                     generator=torch.Generator().manual_seed(4)) * 2 - 1
  gpu_model = build_model('solo_instrument', seed=1)
  cpu_model = build_model('solo_instrument', seed=1, device='cpu')
  with torch.no_grad():  # an audible reverb, so its path carries signal
    cpu_model.processor_group.reverb.ir.copy_(audible_ir(torch))
    gpu_model.processor_group.reverb.ir.copy_(audible_ir(torch))
  loss_gpu, grads_gpu = one_step_gradients(
      torch, gpu_model, {k: v.to(dev) for k, v in small.items()},
      noise.to(dev))
  t0 = time.time()
  loss_cpu, grads_cpu = one_step_gradients(torch, cpu_model, small, noise)
  print(f'  the CPU step took {time.time() - t0:.1f} s')
  for name, g in grads_gpu.items():
    check(torch.isfinite(g).all().item(), f'{name}.grad finite')
    if name.startswith('decoder.'):
      check(g.abs().max().item() > 0, f'{name}.grad non-zero')
  norm_gpu, norm_cpu = global_norm(torch, grads_gpu), global_norm(torch, grads_cpu)
  print(f'  one step, B = 2: total_loss GPU {loss_gpu:.5f} CPU {loss_cpu:.5f}; '
        f'global gradient norm GPU {norm_gpu:.5f} CPU {norm_cpu:.5f}')
  check(abs(loss_gpu - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
        f'total_loss within {STEP_LOSS_RTOL} of the CPU port')
  check(abs(norm_gpu - norm_cpu) <= STEP_GRAD_NORM_RTOL * norm_cpu,
        f'global gradient norm within {STEP_GRAD_NORM_RTOL} of the CPU port')
  check_ir_gradient(torch, dev, 'B = 2 step', gpu_model, cpu_model, small,
                    noise, grads_gpu, grads_cpu)

  # Step time: whole steps between CUDA events, host included.
  torch.cuda.reset_peak_memory_stats()
  times = []
  for _ in range(12):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  median_ms = float(np.median(times))
  print(f'  step ms: {[round(t, 2) for t in times]}')
  print(f'  median ms per training step: {median_ms:.3f}; audio samples/s '
        f'trained: {BATCH * N_SAMPLES / (median_ms / 1e3):.4e}; peak device '
        f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
  if profile:
    profile_steps(torch, lambda: trainer.train_step(state, batch), 3,
                  median_ms, 'training step')
  return launches, median_ms


# Phase 6c: train from a TFRecord dataset, export, serve. 48 examples of
# 4 s in 3 shards (~13 MB), 3 batches of 16 an epoch.
DATA_EXAMPLES = 48
DATA_SHARDS = 3
DATA_STEPS = 12
DATA_SEED = 7
# Steps timed per train() run (the first DATA_WARMUP_STEPS intervals are
# not counted), runs in turns: prefetch 0, 2, 2, 0.
DATA_TIMED_STEPS = 24
DATA_WARMUP_STEPS = 4


def write_dataset(data_dir):
  """DATA_EXAMPLES examples of SyntheticSinusoidProvider into DATA_SHARDS
  TFRecord shards with the port's writer; returns the file pattern."""
  from ddsp_torch import native
  from ddsp_torch.data import SyntheticSinusoidProvider, tfrecord
  os.makedirs(data_dir, exist_ok=True)
  examples = list(SyntheticSinusoidProvider(
      n_samples=N_SAMPLES, n_examples=DATA_EXAMPLES,
      seed=DATA_SEED).get_dataset(shuffle=False))
  per_shard = DATA_EXAMPLES // DATA_SHARDS
  paths = []
  t0 = time.time()
  for i in range(DATA_SHARDS):
    paths.append(os.path.join(
        data_dir, f'train.tfrecord-{i:05d}-of-{DATA_SHARDS:05d}'))
    tfrecord.write_examples(paths[-1],
                            examples[i * per_shard:(i + 1) * per_shard])
  seconds = time.time() - t0
  size = sum(os.path.getsize(p) for p in paths)
  codec = native.codec_name()
  print(f'  wrote {DATA_EXAMPLES} examples ({size / 1e6:.2f} MB) into '
        f'{DATA_SHARDS} shards in {seconds:.2f} s; codec: {codec}')
  check(codec == 'native', 'the native TFRecord codec built and ran')
  # The native CRC against the pure-Python one on the first records.
  records = list(tfrecord.read_records(paths[0], verify_crc=True))[:2]
  agree = []
  for record in records:
    crc = tfrecord.crc32c(record)
    python_masked = (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    agree.append(native.crc32c(record) == crc and
                 native.masked_crc(record) == python_masked and
                 native.check_record(native.frame_record(record)) ==
                 len(record))
  check(all(agree), f'the native CRC32C and masked CRC of the first '
        f'{len(records)} records ({len(records[0])} bytes) equal the '
        'pure-Python ones, and their native framing checks')
  return os.path.join(data_dir, 'train.tfrecord*')


def dataset_run(torch, pattern, prefetch, num_steps, save_dir=None,
                record=False, one_batch=False):
  """One train() run of full-width solo_instrument from the dataset (model
  seed 0, provider seed DATA_SEED, batch BATCH), or from its first batch
  repeated (one_batch: no reading or parsing per step).

  Returns {'losses': [float], 'batches': [host copies] if record, 'starts':
  [CUDA event at each step's start], 'end': CUDA event after train(),
  'to_device_s': [host seconds in Trainer.to_device], 'provider_s': [host
  seconds in the provider's next()], 'same_tensors': [to_device returned
  the batch's own tensors], 'prefetches': [the prefetch iterators train()
  made], 'threads': threads alive after train() less before, 'trainer'}.
  """
  import threading
  from ddsp_torch.data import TFRecordProvider, prefetch_to_device
  from ddsp_torch.train import Trainer, train, train_loop
  from ddsp_torch.utils import build_model
  trainer = Trainer(build_model('solo_instrument', seed=0), seed=0)
  run = {'losses': [], 'batches': [], 'starts': [], 'to_device_s': [],
         'provider_s': [], 'same_tensors': [], 'prefetches': [],
         'trainer': trainer}

  def kept_prefetch(*args, **kwargs):
    run['prefetches'].append(prefetch_to_device(*args, **kwargs))
    return run['prefetches'][-1]
  step, to_device = trainer.train_step, trainer.to_device

  def timed_to_device(batch):
    t0 = time.perf_counter()
    out = to_device(batch)
    run['to_device_s'].append(time.perf_counter() - t0)
    run['same_tensors'].append(all(out[k] is v for k, v in batch.items()))
    return out

  def recording_step(state, batch):
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    run['starts'].append(start)
    if record:
      run['batches'].append({k: (v.device.type, v.dtype, v.cpu())
                             if isinstance(v, torch.Tensor) else v
                             for k, v in batch.items()})
    state, losses = step(state, batch)
    run['losses'].append(losses['total_loss'])
    return state, losses

  trainer.to_device = timed_to_device
  trainer.train_step = recording_step
  batches = TFRecordProvider(pattern, example_secs=N_SAMPLES / SR,
                             seed=DATA_SEED).get_batch(BATCH, shuffle=True)
  if one_batch:
    batches = itertools.repeat(next(batches))

  def timed_batches():
    while True:
      t0 = time.perf_counter()
      batch = next(batches)
      run['provider_s'].append(time.perf_counter() - t0)
      yield batch

  threads = threading.active_count()
  train_loop.prefetch_to_device = kept_prefetch
  try:
    train(timed_batches(), trainer, num_steps=num_steps,
          steps_per_summary=num_steps, steps_per_save=num_steps,
          save_dir=save_dir, prefetch=prefetch)
  finally:
    train_loop.prefetch_to_device = prefetch_to_device
  run['threads'] = threading.active_count() - threads
  run['end'] = torch.cuda.Event(enable_timing=True)
  run['end'].record()
  torch.cuda.synchronize()
  run['losses'] = [l.item() for l in run['losses']]
  return run


def timed_runs(torch, pattern, depths, one_batch=False):
  """One dataset_run of DATA_TIMED_STEPS for each prefetch depth in
  `depths`, in order. Steps are timed by CUDA events at each step's start
  (the device's timeline, host stalls included), after DATA_WARMUP_STEPS.

  Returns [(depth, [ms per step], [host ms in to_device], [host ms in the
  source's next()])], one entry per run.
  """
  out = []
  for depth in depths:
    r = dataset_run(torch, pattern, depth, DATA_TIMED_STEPS,
                    one_batch=one_batch)
    marks = r['starts'] + [r['end']]
    out.append((depth, [a.elapsed_time(b) for a, b in zip(
        marks[DATA_WARMUP_STEPS:], marks[DATA_WARMUP_STEPS + 1:])],
                [1e3 * t for t in r['to_device_s'][DATA_WARMUP_STEPS:]],
                [1e3 * t for t in r['provider_s'][DATA_WARMUP_STEPS:]]))
  return out


def phase_prefetch_pairs(torch, work_dir, pairs):
  """train() from the records with prefetch 0 against prefetch 2, in
  `pairs` pairs, the side that runs first alternating; prints each run's
  median ms per step, the pairwise differences and prefetch 0's quartile
  spread. Measures only; checks nothing but the dataset's codec."""
  print(f'[6c pairs] train() from the records, prefetch 0 against 2, '
        f'{pairs} pairs of {DATA_TIMED_STEPS - DATA_WARMUP_STEPS} timed '
        'steps a run', flush=True)
  pattern = write_dataset(os.path.join(work_dir, 'dataset'))
  medians = {0: [], 2: []}
  for i in range(pairs):
    order = (0, 2) if i % 2 == 0 else (2, 0)
    for depth, steps, _, _ in timed_runs(torch, pattern, order):
      medians[depth].append(float(np.median(steps)))
    print(f'  pair {i + 1} ({order[0]} first): prefetch 0 '
          f'{medians[0][-1]:.3f}, prefetch 2 {medians[2][-1]:.3f} ms per '
          'train() step', flush=True)
  diffs = [b - a for a, b in zip(medians[0], medians[2])]
  q1, q3 = np.percentile(medians[0], [25, 75])
  print(f'  median of the run medians: prefetch 0 '
        f'{np.median(medians[0]):.3f}, prefetch 2 {np.median(medians[2]):.3f}'
        f' ms; pairwise prefetch 2 - prefetch 0: median '
        f'{np.median(diffs):.3f} ms, prefetch 2 lower in '
        f'{sum(d < 0 for d in diffs)} of {pairs} pairs; prefetch 0\'s '
        f'quartile spread {q3 - q1:.3f} ms ({q1:.3f}-{q3:.3f})')


def phase_data_train(torch, dev, work_dir):
  """[6c] Train from a TFRecord dataset through the pinned-memory prefetch,
  export the checkpoint and serve it."""
  from ddsp_torch.data import TFRecordProvider
  from ddsp_torch.eval.summaries import write_wav
  from ddsp_torch.infer import (AutoencoderInference,
                                export_impulse_response, export_model)
  from ddsp_torch.utils import save_spec
  print(f'[6c] train solo_instrument from TFRecords (batch {BATCH} x 4 s, '
        f'{DATA_STEPS} steps, prefetch 2), export, serve', flush=True)
  pattern = write_dataset(os.path.join(work_dir, 'dataset'))
  save_dir = os.path.join(work_dir, 'data_train')
  save_spec(save_dir, 'solo_instrument')

  reset_launches()
  run = dataset_run(torch, pattern, 2, DATA_STEPS, save_dir, record=True)
  launches = read_launches()
  print(f'  launches over {DATA_STEPS} steps: {launches}')
  print(f'  total_loss per step: {[round(l, 4) for l in run["losses"]]}')
  check(len(run['losses']) == DATA_STEPS and all(np.isfinite(run['losses'])),
        f'train() took {DATA_STEPS} steps with finite losses')
  check(all(launches[k] == DATA_STEPS
            for k in ('K1f', 'K1t', 'K2f', 'K2b', 'K2b_w')) and
        launches['K1p'] == launches['K3'] == 0,
        'K1f, K1t, K2f, K2b and its weight-gradient pass once per step '
        'from the dataset, K1p and K3 none')
  check(len(run['prefetches']) == 1 and
        run['prefetches'][0].gi_frame is None and run['threads'] == 0,
        'train() closed its prefetch on return and left no thread')
  check(all(run['same_tensors']),
        'Trainer.to_device used the prefetched tensors as they were (no '
        'copy, no cast)')
  reference = TFRecordProvider(pattern, example_secs=N_SAMPLES / SR,
                               seed=DATA_SEED).get_batch(BATCH, shuffle=True)
  differ = []
  for i, got in enumerate(run['batches']):
    want = next(reference)
    differ += [(i, k) for k in sorted(set(got) | set(want))
               if k not in got or k not in want or got[k][:2] != (
                   dev.type, torch.float32) or not np.array_equal(
                       got[k][2].numpy(), want[k].astype(np.float32))]
  check(len(run['batches']) == DATA_STEPS and not differ,
        f'each of the {DATA_STEPS} batches the step received is on '
        f'{dev.type}, float32 and bit for bit the host provider\'s '
        f'(differ: {differ})')

  # The same steps without prefetch, twice: their spread bounds the
  # prefetched run's departure.
  plain = [dataset_run(torch, pattern, 0, DATA_STEPS)['losses']
           for _ in range(2)]
  spread = max(abs(a - b) for a, b in zip(*plain))
  apart = max(abs(a - b) for a, b in zip(run['losses'], plain[0]))
  print(f'  prefetch 2 against prefetch 0: max |loss difference| {apart:.3e}'
        f'; two prefetch 0 runs: {spread:.3e}')
  if spread == 0:
    check(run['losses'] == plain[0], 'prefetch 2 gives the losses of '
          'prefetch 0 bit for bit (two prefetch 0 runs agree bit for bit)')
  else:
    check(all(min(a, b) - spread <= p <= max(a, b) + spread
              for p, a, b in zip(run['losses'], *plain)),
          'prefetch 2 gives the losses of prefetch 0 within the spread of '
          'two prefetch 0 runs')

  # Whole train() steps in turns, from the records, and from their first
  # batch repeated (the prefetch without the reader's work).
  for source in ('records', 'one batch'):
    timed = {0: [], 2: []}
    host_ms = {0: [], 2: []}
    provider_ms = {0: [], 2: []}
    for turn, (depth, steps, to_device_ms, next_ms) in enumerate(timed_runs(
        torch, pattern, (0, 2, 2, 0), one_batch=source == 'one batch')):
      timed[depth] += steps
      host_ms[depth] += to_device_ms
      provider_ms[depth] += next_ms
      print(f'  {source}, turn {turn + 1}, prefetch {depth}: median ms per '
            f'train() step {np.median(steps):.3f}')
    for depth in (0, 2):
      median = float(np.median(timed[depth]))
      print(f'  {source}, prefetch {depth}: median ms per train() step '
            f'{median:.3f} ({1e3 / median:.3f} steps/s, two turns of '
            f'{DATA_TIMED_STEPS - DATA_WARMUP_STEPS} steps); host ms per '
            f'step in to_device: median {np.median(host_ms[depth]):.4f}, '
            f'mean {np.mean(host_ms[depth]):.4f}; in the source\'s next(): '
            f'median {np.median(provider_ms[depth]):.4f}')

  # Export the checkpoint of the prefetched run and serve it.
  export_dir = os.path.join(work_dir, 'data_export')
  seconds = N_SAMPLES / SR
  export_model(save_dir, export_dir, length_seconds=seconds)
  port = AutoencoderInference(export_dir, length_seconds=seconds)
  request = requests()[1]
  noise = torch.rand((1, N_SAMPLES), generator=torch.Generator().manual_seed(
      3)) * 2 - 1
  port.get_audio(request)  # warm-up, not counted
  reset_launches()
  audio = port(request, noise=noise.to(dev))['audio_synth']
  torch.cuda.synchronize()
  serve_launches = read_launches()
  print(f'  one {seconds:g} s request from the export: launches '
        f'{serve_launches}')
  check(serve_launches['K1f'] == serve_launches['K2f'] == 1 and
        serve_launches['K1t'] == serve_launches['K2b'] == 0,
        'the exported model serves a request through K1f and K2f, once each')
  cpu_audio = AutoencoderInference(save_dir, length_seconds=seconds,
                                   device='cpu')(request, noise=noise)[
                                       'audio_synth']
  rel = ((audio.cpu() - cpu_audio).norm() / cpu_audio.norm()).item()
  print(f'  export on the card against the train directory on the CPU: '
        f'relative L2 {rel:.3e}')
  check(tuple(audio.shape) == (1, N_SAMPLES) and
        torch.isfinite(audio).all().item() and rel <= E2E_REL_L2,
        f'served audio finite, [1, {N_SAMPLES}], within {E2E_REL_L2} of the '
        'CPU port')

  ir_dir = os.path.join(work_dir, 'data_ir')
  path = export_impulse_response(save_dir, ir_dir)
  trained_ir = run['trainer'].model.processor_group.reverb.ir.detach().cpu()
  write_wav(os.path.join(ir_dir, 'trained', 'ir.wav'), trained_ir.numpy(),
            SR)
  samples = [wav_samples(p) for p in
             (path, os.path.join(ir_dir, 'trained', 'ir.wav'))]
  check(len(samples[0]) == REVERB_LENGTH and
        np.array_equal(samples[0], samples[1]),
        'the impulse-response wav holds write_wav of the trained reverb IR')
  print(f'  {os.path.basename(path)}: {len(samples[0])} int16 samples equal '
        'to write_wav of the trained IR')
  return launches, serve_launches


# Phase 6f: the CLI (ddsp_torch/run.py, ddsp-torch-run) in this process on
# phase 6c's records: train, eval, sample, then export the train directory
# as a program and serve it.
CLI_STEPS = 4
CLI_AE_STEPS = 2


def phase_cli(torch, dev, work_dir, pattern):
  """[6f] ddsp_torch.run.main: --mode train (solo_instrument at full
  width, batch 16, CLI_STEPS steps from the records), --mode eval
  --run_once, --mode sample, then export_model(fmt='torch_export') of the
  train directory and one request through the program."""
  import glob
  from ddsp_torch import run
  from ddsp_torch.infer import AutoencoderInference
  from ddsp_torch.infer import export as ex
  print(f'[6f] the CLI: train {CLI_STEPS} steps (solo_instrument, batch '
        f'{BATCH}, from the records), eval, sample, export, serve',
        flush=True)
  save_dir = os.path.join(work_dir, 'cli')
  common = ['--save_dir', save_dir, '--data', f'tfrecord:{pattern}',
            '--batch_size', str(BATCH)]
  reset_launches()
  t0 = time.time()
  state = run.main(['--mode', 'train', '--preset', 'solo_instrument',
                    '--num_steps', str(CLI_STEPS), '--steps_per_summary',
                    '2', '--steps_per_save', str(CLI_STEPS)] + common)
  torch.cuda.synchronize()
  train_s = time.time() - t0
  launches = {'train': read_launches()}
  with open(os.path.join(save_dir, 'metrics.jsonl')) as f:
    metrics = [json.loads(line) for line in f]
  print(f'  train: {train_s:.2f} s, step {state.step}, launches '
        f'{launches["train"]}, metrics {metrics}')
  check(state.step == CLI_STEPS and
        all(launches['train'][k] == CLI_STEPS
            for k in ('K1f', 'K1t', 'K2f', 'K2b', 'K2b_w')) and
        launches['train']['K1p'] == launches['train']['K3'] == 0,
        f'the CLI trained {CLI_STEPS} steps, each through K1f, K1t, K2f, K2b '
        'and its weight-gradient pass')
  check([m['step'] for m in metrics] == list(range(2, CLI_STEPS + 1, 2)) and
        all(np.isfinite(m['total_loss']) for m in metrics) and
        os.path.exists(os.path.join(save_dir, f'ckpt-{CLI_STEPS:08d}.pt')),
        'metrics.jsonl has finite losses every 2 steps, and the checkpoint '
        'is written')
  for mode in ('eval', 'sample'):
    reset_launches()
    out = run.main(['--mode', mode, '--run_once', '--num_eval_batches', '1']
                   + common)
    torch.cuda.synchronize()
    launches[mode] = read_launches()
    print(f'  {mode}: launches {launches[mode]}')
    check(launches[mode]['K1f'] == launches[mode]['K2f'] == 1 and
          launches[mode]['K1t'] == launches[mode]['K2b'] == 0,
          f'--mode {mode} ran one batch through K1f and K2f')
    if mode == 'eval':
      print(f'  eval: {out}')
      check(np.isfinite(out['losses/total_loss']),
            '--mode eval gave a finite total_loss')
  wavs = glob.glob(os.path.join(save_dir, 'samples', f'step_{CLI_STEPS}',
                                '*.wav'))
  check(wavs, f'--mode sample wrote wavs ({len(wavs)})')

  path = ex.export_model(save_dir, os.path.join(work_dir, 'cli_export'),
                         fmt='torch_export', length_seconds=N_SAMPLES / SR)
  program = ex.load_program(path)
  request = requests()[2]
  inputs = tuple(torch.from_numpy(request[k])[None, :, None].to(dev)
                 for k in ('f0_hz', 'loudness_db'))
  program(*inputs)  # warm-up, not counted
  reset_launches()
  audio = program(*inputs)
  torch.cuda.synchronize()
  launches['serve'] = read_launches()
  eager = AutoencoderInference(save_dir, length_seconds=N_SAMPLES / SR)
  err = (audio - eager.get_audio(request)).abs().max().item()
  print(f'  the trained directory as a program: launches '
        f'{launches["serve"]}, max |diff| against the eager class {err:.3e}')
  check(launches['serve']['K1f'] == launches['serve']['K2f'] == 1 and
        torch.isfinite(audio).all().item() and err <= PROGRAM_ATOL,
        f'the program of the CLI\'s train directory serves a request '
        f'through K1f and K2f within {PROGRAM_ATOL} of the eager class')

  # The ae preset through the CLI on the same records: train, then one
  # eval batch. Its encoder reads audio, so its train directory has no
  # autoencoder program: the export is skipped, and the reason printed.
  ae_dir = os.path.join(work_dir, 'cli_ae')
  ae_common = ['--save_dir', ae_dir, '--data', f'tfrecord:{pattern}',
               '--batch_size', str(BATCH)]
  reset_launches()
  state = run.main(['--mode', 'train', '--preset', 'ae', '--num_steps',
                    str(CLI_AE_STEPS), '--steps_per_summary', '1',
                    '--steps_per_save', str(CLI_AE_STEPS)] + ae_common)
  torch.cuda.synchronize()
  launches['ae_train'] = read_launches()
  print(f'  ae train: step {state.step}, launches {launches["ae_train"]}')
  per_step = {'K1f': 1, 'K1t': 1, 'K1p': 0, 'K2f': 2, 'K2b': 2, 'K2b_w': 2,
              'K3': 0}
  check(state.step == CLI_AE_STEPS and launches['ae_train'] == {
      k: v * CLI_AE_STEPS for k, v in per_step.items()},
        f'the CLI trained ae {CLI_AE_STEPS} steps, each {per_step}')
  reset_launches()
  out = run.main(['--mode', 'eval', '--run_once', '--num_eval_batches', '1']
                 + ae_common)
  torch.cuda.synchronize()
  launches['ae_eval'] = read_launches()
  print(f'  ae eval: launches {launches["ae_eval"]}, {out}')
  check(launches['ae_eval']['K1f'] == 1 and launches['ae_eval']['K2f'] == 2
        and launches['ae_eval']['K2b'] == 0 and
        np.isfinite(out['losses/total_loss']),
        '--mode eval of ae: one batch through K1f once and K2f twice, a '
        'finite total_loss')
  try:
    ex.export_model(ae_dir, os.path.join(work_dir, 'cli_ae_export'),
                    fmt='torch_export', length_seconds=N_SAMPLES / SR)
    reason = ''
  except ValueError as e:
    reason = str(e)
  print(f'  the ae train directory\'s torch_export skipped: {reason}')
  check('encodes audio' in reason,
        'the ae train directory is not exported as an autoencoder program '
        '(the encoder reads audio)')
  return launches


# Phase 6g: the ae preset (magenta/ddsp gin/models/ae.gin) at full width:
# MFCCs of the audio -> instance norm -> a bf16 GRU of 512 over 125 frames
# -> z (16), resampled to 1000 frames; the decoder with a third FC stack
# for z; Harmonic(100) + FilteredNoise(65). A request launches K2f twice
# (encoder, decoder) and K1f once.
AE_REQUESTS = 4


def ae_requests():
  """AE_REQUESTS clips of 4 s at batch 1 ('audio' [1, 64000], 'f0_hz'
  [1, 1000]): the training batch's tones from another seed."""
  clips = training_batch(AE_REQUESTS, seed=11)
  return [{k: v[i:i + 1] for k, v in clips.items()}
          for i in range(AE_REQUESTS)]


def gru_lengths(torch, model):
  """Hooks recording the sequence length each FastGRU of the model runs
  (encoder, decoder); returns (lengths list, remove())."""
  from ddsp_torch.nn.layers import FastGRU
  lengths = []
  handles = [m.register_forward_hook(
      lambda mod, inputs, out, name=name: lengths.append(
          (name, int(inputs[0].shape[1]), mod.dtype)))
             for name, m in model.named_modules() if isinstance(m, FastGRU)]
  return lengths, lambda: [h.remove() for h in handles]


def phase_ae(torch, dev, work_dir, pattern):
  """[6g] the ae preset: reconstruction requests, training, eval and
  sample, and the serving classes' refusal. Returns the launches of each
  ('ae_serve', 'ae_train', 'ae_eval', 'ae_sample')."""
  from ddsp_torch.data import TFRecordProvider
  from ddsp_torch.eval import evaluate_or_sample
  from ddsp_torch.infer import AutoencoderInference, export_model
  from ddsp_torch.train import Trainer, train
  from ddsp_torch.utils import build_model, save_spec
  print(f'[6g] ae (full width, bf16): {AE_REQUESTS} reconstruction requests '
        f'of 4 s, {TRAIN_STEPS} training steps at batch {BATCH} x 4 s, eval, '
        'sample', flush=True)
  # One state dict (torch.Generator(seed 0)) on the card and on the CPU.
  cpu_model = build_model('ae', device='cpu', seed=0)
  model = build_model('ae')
  model.load_state_dict(cpu_model.state_dict())
  model.eval()
  reqs = ae_requests()
  noise = torch.rand((1, N_SAMPLES),
                     generator=torch.Generator().manual_seed(12)) * 2 - 1

  def request(m, r, d):
    with torch.no_grad():
      return m({k: torch.from_numpy(v).to(d) for k, v in r.items()},
               training=False, noise=noise.to(d))

  lengths, unhook = gru_lengths(torch, model)
  reset_launches()
  outs = [request(model, r, dev) for r in reqs]
  torch.cuda.synchronize()
  launches = {'ae_serve': read_launches()}
  unhook()
  print(f'  launches over {AE_REQUESTS} requests: {launches["ae_serve"]}; '
        f'FastGRU (module, T, dtype) per request: {lengths[:2]}')
  want = {'K1f': AE_REQUESTS, 'K2f': 2 * AE_REQUESTS, 'K1t': 0, 'K1p': 0,
          'K2b': 0, 'K2b_w': 0, 'K3': 0}
  check(launches['ae_serve'] == want,
        'each ae request launched K1f once and K2f twice (encoder and '
        'decoder), no backward kernel')
  check(lengths[:2] == [('encoder.rnn.FastGRU_0', AE_Z_STEPS, torch.bfloat16),
                        ('decoder.rnn.FastGRU_0', N_FRAMES, torch.bfloat16)],
        f'the encoder\'s GRU runs bf16 over {AE_Z_STEPS} MFCC frames, the '
        f'decoder\'s over {N_FRAMES}')
  for i, out in enumerate(outs):
    audio, z = out['audio_synth'], out['z']
    check(tuple(audio.shape) == (1, N_SAMPLES) and
          tuple(z.shape) == (1, N_FRAMES, 16) and
          torch.isfinite(audio).all().item() and
          audio.abs().max().item() > 0,
          f'ae request {i}: audio [1, {N_SAMPLES}] and z [1, {N_FRAMES}, 16] '
          'finite, audio not silent')
  rels = []
  for r, out in zip(reqs, outs):
    cpu_out = request(cpu_model, r, 'cpu')
    rels.append((rel_l2(out['audio_synth'].cpu(), cpu_out['audio_synth']),
                 rel_l2(out['z'].cpu(), cpu_out['z'])))
  print('  card against the CPU port, audio and z relative L2: ' +
        ', '.join(f'({a:.3e}, {b:.3e})' for a, b in rels))
  check(max(a for a, _ in rels) <= E2E_REL_L2,
        f'every ae request\'s audio within {E2E_REL_L2} of the CPU port')
  times = []
  for i in range(14):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    request(model, reqs[i % AE_REQUESTS], dev)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  times = times[2:]
  request_ms = float(np.median(times))
  print(f'  ae request ms: {[round(t, 3) for t in times]}')
  print(f'  median ms per 4 s ae request: {request_ms:.3f}; audio '
        f'samples/s: {N_SAMPLES / (request_ms / 1e3):.4e}', flush=True)

  # Training through Trainer and train(), from a train directory with the
  # spec, as the CLI writes it.
  save_dir = os.path.join(work_dir, 'ae_train')
  save_spec(save_dir, 'ae')
  batch = training_batch()
  trainer = Trainer(build_model('ae', seed=0), seed=0)
  reset_launches()
  state = train(itertools.repeat(batch), trainer, num_steps=TRAIN_STEPS,
                steps_per_summary=1, steps_per_save=TRAIN_STEPS,
                save_dir=save_dir)
  torch.cuda.synchronize()
  launches['ae_train'] = read_launches()
  with open(os.path.join(save_dir, 'metrics.jsonl')) as f:
    losses = [json.loads(line)['total_loss'] for line in f]
  print(f'  {trainer.param_count(state)} parameters; launches over '
        f'{TRAIN_STEPS} steps: {launches["ae_train"]}')
  print(f'  total_loss per step: {[round(l, 3) for l in losses]}; mean of '
        f'the first five {np.mean(losses[:5]):.4f}, of the last five '
        f'{np.mean(losses[-5:]):.4f}')
  check(state.step == TRAIN_STEPS and len(losses) == TRAIN_STEPS and
        all(np.isfinite(losses)),
        f'train() took {TRAIN_STEPS} ae steps, every loss finite')
  want = {'K1f': 1, 'K1t': 1, 'K1p': 0, 'K2f': 2, 'K2b': 2, 'K2b_w': 2,
          'K3': 0}
  check(launches['ae_train'] == {k: v * TRAIN_STEPS for k, v in want.items()},
        f'per ae step: {want} (the encoder\'s and the decoder\'s GRU each '
        'through K2f, K2b and its weight-gradient pass)')

  # One step on the card against the port on the CPU, B = 2, one state
  # dict and noise; the gradients reach the encoder.
  small = {k: torch.as_tensor(v[:2]) for k, v in batch.items()}
  step_noise = torch.rand((2, N_SAMPLES),
                          generator=torch.Generator().manual_seed(13)) * 2 - 1
  gpu_model = build_model('ae')
  gpu_model.load_state_dict(cpu_model.state_dict())
  loss_gpu, grads_gpu = one_step_gradients(
      torch, gpu_model, {k: v.to(dev) for k, v in small.items()},
      step_noise.to(dev))
  t0 = time.time()
  loss_cpu, grads_cpu = one_step_gradients(torch, cpu_model, small,
                                           step_noise)
  print(f'  the CPU step took {time.time() - t0:.1f} s')
  for name in ('encoder.z_norm.scale', 'encoder.z_norm.shift',
               'encoder.rnn.FastGRU_0.wh', 'encoder.dense_out.kernel',
               'encoder.dense_out.bias'):
    g = grads_gpu[name]
    check(torch.isfinite(g).all().item() and g.abs().max().item() > 0,
          f'{name}.grad finite and non-zero')
  check(all(torch.isfinite(g).all().item() for g in grads_gpu.values()),
        'every ae gradient finite')
  norm_gpu, norm_cpu = (global_norm(torch, grads_gpu),
                        global_norm(torch, grads_cpu))
  print(f'  one ae step, B = 2: total_loss GPU {loss_gpu:.5f} CPU '
        f'{loss_cpu:.5f}; global gradient norm GPU {norm_gpu:.5f} CPU '
        f'{norm_cpu:.5f}')
  check(abs(loss_gpu - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
        f'the ae step\'s total_loss within {STEP_LOSS_RTOL} of the CPU port')
  check(abs(norm_gpu - norm_cpu) <= STEP_GRAD_NORM_RTOL * norm_cpu,
        f'the ae step\'s global gradient norm within {STEP_GRAD_NORM_RTOL} '
        'of the CPU port')
  # The encoder's gradient reaches it through z and the whole decoder: with
  # the full loss it is conditioned by the logmag term's 1/|X| on
  # near-silent bins, as the reverb IR's is (check_ir_gradient), so it is
  # printed; the step with the mag term alone is held.
  parts = ('encoder.', 'decoder.')
  full = {p: rel_l2(flat_grads(torch, grads_gpu, p),
                    flat_grads(torch, grads_cpu, p)) for p in parts}
  print(f'  full loss, GPU against CPU, relative L2 (not held): {full}')
  for m in (gpu_model, cpu_model):
    m.losses = mag_only_losses(torch, m).to(next(m.parameters()).device)
  _, mag_gpu = one_step_gradients(
      torch, gpu_model, {k: v.to(dev) for k, v in small.items()},
      step_noise.to(dev))
  _, mag_cpu = one_step_gradients(torch, cpu_model, small, step_noise)
  rels = {p: rel_l2(flat_grads(torch, mag_gpu, p),
                    flat_grads(torch, mag_cpu, p)) for p in parts}
  print(f'  mag term only, GPU against CPU, relative L2: {rels}')
  check(max(rels.values()) <= IR_MAG_STEP_RTOL,
        f'the ae step with the mag term only: the encoder\'s and the '
        f'decoder\'s gradients within {IR_MAG_STEP_RTOL} of the CPU port')
  times = []
  for _ in range(12):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, _ = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  step_ms = float(np.median(times))
  print(f'  ae step ms: {[round(t, 2) for t in times]}')
  print(f'  median ms per ae training step: {step_ms:.3f}; audio samples/s '
        f'trained: {BATCH * N_SAMPLES / (step_ms / 1e3):.4e}', flush=True)

  # Eval and sample of the checkpoint: one batch each, on 6c's records.
  provider = TFRecordProvider(pattern, example_secs=N_SAMPLES / SR)
  eval_noise = torch.rand((EVAL_BATCH, N_SAMPLES),
                          generator=torch.Generator().manual_seed(0)) * 2 - 1
  eval_trainer = Trainer(build_model('ae', seed=1))
  for mode in ('eval', 'sample'):
    reset_launches()
    t0 = time.time()
    out = evaluate_or_sample(provider, eval_trainer,
                             os.path.join(work_dir, 'ae_eval'),
                             restore_dir=save_dir, mode=mode,
                             batch_size=EVAL_BATCH, num_batches=1,
                             noise=eval_noise.to(dev))
    torch.cuda.synchronize()
    launches[f'ae_{mode}'] = read_launches()
    print(f'  {mode}: {time.time() - t0:.2f} s, launches '
          f'{launches[f"ae_{mode}"]}' + (f', {out}' if out else ''))
    check(launches[f'ae_{mode}']['K1f'] == 1 and
          launches[f'ae_{mode}']['K2f'] == 2 and
          launches[f'ae_{mode}']['K2b'] == 0,
          f'ae {mode}: one batch through K1f once and K2f twice')
    if mode == 'eval':
      check(np.isfinite(out['losses/total_loss']),
            'ae eval gave a finite total_loss')
  wavs = [f for f in os.listdir(os.path.join(
      work_dir, 'ae_eval', 'samples', f'step_{TRAIN_STEPS}'))
          if f.endswith('.wav')]
  check(wavs, f'ae sample wrote wavs ({len(wavs)})')

  # An ae directory is served by the model's forward, not by the serving
  # classes: they refuse it, naming the encoder's audio input.
  for what, call in (
      ('AutoencoderInference', lambda: AutoencoderInference(save_dir)),
      ("export_model fmt='params'", lambda: export_model(
          save_dir, os.path.join(work_dir, 'ae_params'))),
      ("export_model fmt='torch_export'", lambda: export_model(
          save_dir, os.path.join(work_dir, 'ae_program'),
          fmt='torch_export'))):
    try:
      call()
      refused = ''
    except ValueError as e:
      refused = str(e)
    print(f'  {what}: {refused[:160]}')
    check('encodes audio' in refused and "'audio'" in refused,
          f'{what} refuses the ae directory with a ValueError naming the '
          'encoder\'s audio input')
  return launches


# Phase 6i: the midiae preset (magenta/ddsp gin/models/midiae/midiae.gin) at
# full width: a dilated-conv synthcoder (ch 128, 2 stacks of 9 layers,
# dilation up to 256), a HarmonicToMidiEncoder and a MidiToHarmonicDecoder
# on DilatedConvStacks of 4 x 5 layers, 60 harmonics, 65 noise bands, a
# trainable FilteredNoiseReverb of 24000 taps; 2 972 799 parameters. A
# forward runs the processor group twice (the synthcoder's branch and the
# MIDI branch): K1f twice; a MIDI request (midi_to_audio) once; a training
# step K1t once (only synth_audio is in a loss) and K1p never (f0 is data,
# midi_audio in no loss). The dilated stacks pin their convolutions to full
# float32 (nn/dilated_conv.py), and the phase runs with cuDNN's TF32 turned
# on, PyTorch's default (main turns it off for the other phases), so the
# checks below hold float32 tolerances through the pin.
MIDI_REQUESTS = 4
MIDIAE_REVERB = 24000  # the preset's FilteredNoiseReverb taps
# Frames where the CPU port's z_pitch lies within this of a half-integer are
# ties: round-half-to-even may take either neighbour there on the two
# devices. The two devices' z_pitch differ by float32 rounding through ~40
# convolutions and layer norms (1e-5 of pitches near 50: a few 1e-5); the
# tie band is 100x that. Every other frame's q_pitch must be equal.
Q_TIE_ATOL = 1e-3
# The MIDI encoder's and decoder's gradients with the full loss: they get
# none from the spectral term (the encoder's inputs are stopped, midi_audio
# is in no loss), only from the f0, amps, hd, noise and margin losses of
# controls that agree to float32 rounding and sums in another order
# (1.9e-6 and 4.5e-7 on an H100). A tie of the B = 2 step's 2000 frames
# rounding the other way on one device would move them past this bound
# and fail the check, naming it; the step's data is fixed and none does.
MIDI_NET_GRAD_RTOL = 1e-3


def midi_pianoroll(f0_hz, velocity=100.0):
  """[B, T, 128] piano roll of the nearest MIDI note of f0_hz [B, T]."""
  notes = np.round(12.0 * np.log2(np.asarray(f0_hz, np.float64) / 440.0)
                   + 69.0).astype(int)
  roll = np.zeros(notes.shape + (128,), np.float32)
  np.put_along_axis(roll, np.clip(notes, 0, 127)[..., None], velocity,
                    axis=-1)
  return roll


def midi_requests():
  """MIDI_REQUESTS seeded note sequences of 4 s: q_pitch [1, 1000, 1] of
  notes 40-80 lasting 0.1-0.6 s, with rests (MIDI 0) between some."""
  rng = np.random.RandomState(21)
  out = []
  for _ in range(MIDI_REQUESTS):
    pitch = np.zeros(N_FRAMES, np.float32)
    t = 0
    while t < N_FRAMES:
      n = rng.randint(25, 150)
      pitch[t:t + n] = 0.0 if rng.rand() < 0.2 else float(rng.randint(40, 80))
      t += n
    out.append(pitch[None, :, None])
  return out


def midi_noise_dict(torch, batch, seed):
  """One branch's noise, {processor name: draw in [-1, 1)}, made on the
  host: FilteredNoise's [batch, 64000] and the reverb IR's [1, 24000]."""
  gen = torch.Generator().manual_seed(seed)
  return {'filtered_noise': torch.rand((batch, N_SAMPLES), generator=gen)
                            * 2 - 1,
          'reverb': torch.rand((1, MIDIAE_REVERB), generator=gen) * 2 - 1}


def on(d, noise):
  """A noise dict's tensors on device d."""
  return {k: v.to(d) for k, v in noise.items()}


def timed_median(torch, fn, calls=14, skip=2):
  """(median ms, the ms list) of calls - skip CUDA-event-timed calls."""
  times = []
  for _ in range(calls):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  times = times[skip:]
  return float(np.median(times)), times


def check_q_pitch(torch, label, q_gpu, q_cpu, z_cpu):
  """q_pitch on the card against the CPU port: equal but at ties."""
  q_gpu, q_cpu, z_cpu = q_gpu.cpu(), q_cpu.cpu(), z_cpu.cpu()
  ties = (torch.abs(torch.abs(z_cpu - torch.floor(z_cpu)) - 0.5) <
          Q_TIE_ATOL)
  differ = q_gpu != q_cpu
  print(f'  {label}: q_pitch frames that differ from the CPU port '
        f'{int(differ.sum())} of {differ.numel()}, ties {int(ties.sum())}')
  check(not bool((differ & ~ties).any()),
        f'{label}: q_pitch equal to the CPU port\'s at every frame that is '
        f'not a tie (z_pitch within {Q_TIE_ATOL} of a half-integer)')


def midiae_step(torch, model, batch, noise, midi_noise, mag_only=False):
  """One training forward/backward: (loss, {name: grad}). mag_only: the
  SpectralLoss of synth_audio with its mag term alone, instead of the
  preset's losses."""
  from ddsp_torch.losses import SpectralLoss
  out, losses = model(batch, training=True, return_losses=True, noise=noise,
                      midi_noise=midi_noise)
  loss = losses['total_loss']
  if mag_only:
    loss = SpectralLoss(loss_type='L1', mag_weight=1.0, logmag_weight=0.0)(
        batch['audio'], out['synth_audio'])
  named = list(model.named_parameters())
  grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
  return loss.item(), {n: g for (n, _), g in zip(named, grads)
                       if g is not None}


def phase_midiae(torch, dev, work_dir, pattern, dense_ms, profile=False):
  """[6i] the midiae preset: MIDI requests, reconstruction requests,
  training, eval and sample with both MIDI evaluators, the CLI, and the
  serving classes' refusal. Returns the launches of each path
  ('midi_request', 'midiae_request', 'midiae_train', 'midiae_eval',
  'midiae_sample', 'cli_midiae_train', 'cli_midiae_eval')."""
  from ddsp_torch.utils import build_model
  print(f'[6i] midiae (full width, float32, cuDNN TF32 on for the process): '
        f'{MIDI_REQUESTS} MIDI requests and {MIDI_REQUESTS} reconstruction '
        f'requests of 4 s, {TRAIN_STEPS} training steps at batch {BATCH} x '
        '4 s, eval and sample, the CLI', flush=True)
  cudnn = torch.backends.cudnn
  saved_tf32, cudnn.allow_tf32 = cudnn.allow_tf32, True
  try:
    # One state dict (torch.Generator(seed 0)) on the card and on the CPU.
    cpu_model = build_model('midiae', device='cpu', seed=0)
    model = build_model('midiae')
    model.load_state_dict(cpu_model.state_dict())
    model.eval()
    launches = midiae_requests(torch, dev, model, cpu_model, profile)
    save_dir = os.path.join(work_dir, 'midiae_train')
    launches['midiae_train'] = midiae_training(torch, dev, cpu_model,
                                               save_dir, dense_ms, profile)
    launches.update(midiae_eval(torch, dev, work_dir, save_dir))
    launches.update(midiae_cli(torch, work_dir, pattern))
  finally:
    cudnn.allow_tf32 = saved_tf32
  return launches


def midiae_requests(torch, dev, model, cpu_model, profile=False):
  """MIDI requests (midi_to_audio) and reconstruction requests (the
  forward on audio) at B = 1 against the CPU port; their launches and
  median ms."""
  notes = midi_requests()
  zeros = torch.zeros(1, N_FRAMES, 1)

  def midi_request(m, q, d, seed):
    with torch.no_grad():
      return m.midi_to_audio(torch.from_numpy(q).to(d), zeros.to(d),
                             noise=on(d, midi_noise_dict(torch, 1, seed)))

  reset_launches()
  audio = [midi_request(model, q, dev, 30 + i) for i, q in enumerate(notes)]
  torch.cuda.synchronize()
  launches = {'midi_request': read_launches()}
  print(f'  launches over {MIDI_REQUESTS} MIDI requests: '
        f'{launches["midi_request"]}')
  check(launches['midi_request'] == {
      'K1f': MIDI_REQUESTS, 'K1t': 0, 'K1p': 0, 'K2f': 0, 'K2b': 0,
      'K2b_w': 0, 'K3': 0},
        'each MIDI request launched K1f once and no other kernel')
  rels = []
  for i, (q, a) in enumerate(zip(notes, audio)):
    check(tuple(a.shape) == (1, N_SAMPLES) and torch.isfinite(a).all().item()
          and a.abs().max().item() > 0,
          f'MIDI request {i}: audio [1, {N_SAMPLES}] finite, not silent')
    rels.append(rel_l2(a.cpu(), midi_request(cpu_model, q, 'cpu', 30 + i)))
  print('  MIDI requests, card against the CPU port, audio relative L2: ' +
        ', '.join(f'{r:.3e}' for r in rels))
  check(max(rels) <= E2E_REL_L2,
        f'every MIDI request\'s audio within {E2E_REL_L2} of the CPU port')
  midi_ms, times = timed_median(
      torch, lambda: midi_request(model, notes[1], dev, 31))
  print(f'  MIDI request ms: {[round(t, 3) for t in times]}')
  print(f'  median ms per 4 s MIDI request: {midi_ms:.3f}', flush=True)

  # Reconstruction requests: the forward on phase 6's tones, both branches.
  clips = training_batch(MIDI_REQUESTS, seed=11)
  clips = [{k: v[i:i + 1] for k, v in clips.items()}
           for i in range(MIDI_REQUESTS)]

  def request(m, clip, d, seed):
    with torch.no_grad():
      return m({k: torch.from_numpy(v).to(d) for k, v in clip.items()},
               training=False, noise=on(d, midi_noise_dict(torch, 1, seed)),
               midi_noise=on(d, midi_noise_dict(torch, 1, seed + 100)))

  reset_launches()
  outs = [request(model, c, dev, 40 + i) for i, c in enumerate(clips)]
  torch.cuda.synchronize()
  launches['midiae_request'] = read_launches()
  print(f'  launches over {MIDI_REQUESTS} reconstruction requests: '
        f'{launches["midiae_request"]}')
  check(launches['midiae_request'] == {
      'K1f': 2 * MIDI_REQUESTS, 'K1t': 0, 'K1p': 0, 'K2f': 0, 'K2b': 0,
      'K2b_w': 0, 'K3': 0},
        'each reconstruction request launched K1f twice (the synthcoder\'s '
        'branch and the MIDI branch) and no other kernel')
  for i, (clip, out) in enumerate(zip(clips, outs)):
    cpu_out = request(cpu_model, clip, 'cpu', 40 + i)
    for key in ('synth_audio', 'midi_audio'):
      check(torch.isfinite(out[key]).all().item() and
            out[key].abs().max().item() > 0, f'request {i}: {key} finite')
    check(tuple(out['pianoroll'].shape) == (1, N_FRAMES, 128),
          f'request {i}: a piano roll [1, {N_FRAMES}, 128]')
    check_q_pitch(torch, f'request {i}', out['q_pitch'], cpu_out['q_pitch'],
                  cpu_out['z_pitch'])
    # midi_audio of the card's q_pitch on both devices (a tie frame's other
    # neighbour would be another note, not an error of the synthesis).
    with torch.no_grad():
      cpu_midi = cpu_model.midi_to_audio(
          out['q_pitch'].cpu(), zeros,
          noise=midi_noise_dict(torch, 1, 140 + i))
    a, b = (rel_l2(out['synth_audio'].cpu(), cpu_out['synth_audio']),
            rel_l2(out['midi_audio'].cpu(), cpu_midi))
    print(f'  request {i}: synth_audio, midi_audio relative L2 to the CPU '
          f'port {a:.3e}, {b:.3e}')
    check(max(a, b) <= E2E_REL_L2,
          f'request {i}: both audios within {E2E_REL_L2} of the CPU port')
  recon_ms, times = timed_median(torch, lambda: request(model, clips[1], dev,
                                                        41))
  print(f'  reconstruction request ms: {[round(t, 3) for t in times]}')
  print(f'  median ms per 4 s reconstruction request: {recon_ms:.3f}',
        flush=True)
  if profile:
    profile_steps(torch, lambda: midi_request(model, notes[1], dev, 31), 3,
                  midi_ms, 'MIDI request')
    profile_steps(torch, lambda: request(model, clips[1], dev, 41), 3,
                  recon_ms, 'reconstruction request')
  return launches


def midiae_training(torch, dev, cpu_model, save_dir, dense_ms,
                    profile=False):
  """TRAIN_STEPS Trainer.train_steps at BATCH x 4 s with a ground-truth
  piano roll in the batch; a B = 2 step against the CPU port; step ms
  beside phase 6's; a checkpoint in save_dir. Returns the launches."""
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model, save_spec
  batch = training_batch()
  batch['note_active_velocities'] = midi_pianoroll(batch['f0_hz'])
  save_spec(save_dir, 'midiae')
  trainer = Trainer(build_model('midiae', seed=0), seed=0)
  state = trainer.init()
  reset_launches()
  losses, times = [], []
  for _ in range(TRAIN_STEPS):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, step_losses = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
    losses.append({k: v.item() for k, v in step_losses.items()})
  launches = read_launches()
  trainer.save(state, save_dir)
  totals = [l['total_loss'] for l in losses]
  print(f'  {trainer.param_count(state)} parameters; launches over '
        f'{TRAIN_STEPS} steps: {launches}')
  print(f'  loss keys {sorted(losses[0])}; total_loss per step: '
        f'{[round(l, 3) for l in totals]}')
  check(sorted(losses[0]) == ['amps_loss', 'f0_loss', 'hd_loss', 'noise_loss',
                              'qpitch_f0rec_loss', 'synth_spectral_loss',
                              'total_loss'],
        'the midiae losses carry the JAX package\'s keys')
  check(all(np.isfinite(totals)), 'every midiae loss finite')
  want = {'K1f': 2, 'K1t': 1, 'K1p': 0, 'K2f': 0, 'K2b': 0, 'K2b_w': 0,
          'K3': 0}
  check(launches == {k: v * TRAIN_STEPS for k, v in want.items()},
        f'per midiae step: {want} (both branches forward, only synth_audio '
        'in a loss)')
  step_ms = float(np.median(times[TRAIN_STEPS // 2:]))
  print(f'  midiae step ms: {[round(t, 2) for t in times]}')
  print(f'  median ms per midiae training step (the last {TRAIN_STEPS // 2})'
        f': {step_ms:.3f} (phase 6\'s solo_instrument step {dense_ms:.3f}); '
        f'audio samples/s trained: {BATCH * N_SAMPLES / (step_ms / 1e3):.4e}',
        flush=True)
  if profile:
    profile_steps(torch, lambda: trainer.train_step(state, batch), 3,
                  step_ms, 'midiae step')

  # One step on the card against the port on the CPU, B = 2, one state
  # dict and noise.
  small = {k: torch.as_tensor(v[:2]) for k, v in batch.items()}
  noise, midi_noise = (midi_noise_dict(torch, 2, 50),
                       midi_noise_dict(torch, 2, 51))
  gpu_model = build_model('midiae')
  gpu_model.load_state_dict(cpu_model.state_dict())
  gpu_small = {k: v.to(dev) for k, v in small.items()}
  loss_gpu, grads_gpu = midiae_step(torch, gpu_model, gpu_small,
                                    on(dev, noise), on(dev, midi_noise))
  t0 = time.time()
  loss_cpu, grads_cpu = midiae_step(torch, cpu_model, small, noise,
                                    midi_noise)
  print(f'  the CPU step took {time.time() - t0:.1f} s; total_loss GPU '
        f'{loss_gpu:.5f} CPU {loss_cpu:.5f}')
  check(all(torch.isfinite(g).all().item() for g in grads_gpu.values()),
        'every midiae gradient finite')
  check(abs(loss_gpu - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
        f'the midiae step\'s total_loss within {STEP_LOSS_RTOL} of the CPU '
        'port')
  parts = ('synthcoder.', 'midi_encoder.', 'midi_decoder.', 'default_pg.')
  full = {p: rel_l2(flat_grads(torch, grads_gpu, p),
                    flat_grads(torch, grads_cpu, p)) for p in parts}
  print(f'  full loss, GPU against CPU, relative L2: {full}')
  check(max(full['midi_encoder.'], full['midi_decoder.']) <=
        MIDI_NET_GRAD_RTOL,
        f'the MIDI encoder\'s and decoder\'s gradients within '
        f'{MIDI_NET_GRAD_RTOL} of the CPU port (no spectral term reaches '
        'them)')
  # The spectral term reaches the synthcoder and the reverb; with the
  # logmag term it is conditioned by 1/|X| (check_ir_gradient), so the mag
  # term alone is held, as phase 6g holds the ae's.
  _, mag_gpu = midiae_step(torch, gpu_model, gpu_small, on(dev, noise),
                           on(dev, midi_noise), mag_only=True)
  _, mag_cpu = midiae_step(torch, cpu_model, small, noise, midi_noise,
                           mag_only=True)
  rels = {p: rel_l2(flat_grads(torch, mag_gpu, p),
                    flat_grads(torch, mag_cpu, p))
          for p in ('synthcoder.', 'default_pg.')}
  print(f'  mag term only, GPU against CPU, relative L2: {rels}')
  check(max(rels.values()) <= IR_MAG_STEP_RTOL,
        f'the midiae step with the mag term only: the synthcoder\'s and the '
        f'reverb\'s gradients within {IR_MAG_STEP_RTOL} of the CPU port')
  return launches


class RecordingMidiEvaluators:
  """Wraps the MIDI evaluators' evaluate() to keep each batch's predicted
  note sequences (the learned piano roll's, the heuristic's)."""

  def __init__(self, learned, heuristic, frame_rate):
    from ddsp_torch.eval.metrics import pianoroll_to_note_sequence
    self.sequences = []

    def learned_eval(batch, outputs, losses, fn=learned.evaluate):
      self.sequences.append(('learned', [
          pianoroll_to_note_sequence(p, frame_rate)
          for p in outputs['pianoroll']]))
      return fn(batch, outputs, losses)

    def heuristic_eval(batch, outputs, losses, fn=heuristic.evaluate):
      self.sequences.append(('heuristic',
                             heuristic.compute_heuristic_notes(outputs)))
      return fn(batch, outputs, losses)

    learned.evaluate, heuristic.evaluate = learned_eval, heuristic_eval


def note_tuples(sequences):
  return [(kind, [[(n.pitch, n.start_time, n.end_time) for n in s.notes]
                  for s in seqs]) for kind, seqs in sequences]


def midiae_eval(torch, dev, work_dir, save_dir):
  """evaluate_or_sample of the checkpoint, one batch of EVAL_BATCH of phase
  6's tones with their piano roll, both MIDI evaluators; the predicted note
  sequences against the CPU port's."""
  from ddsp_torch.data import ArrayDataProvider
  from ddsp_torch.eval import (BasicEvaluator, MidiAutoencoderEvaluator,
                               MidiHeuristicEvaluator, evaluate_or_sample)
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  tones = training_batch(EVAL_BATCH, seed=3)
  tones['note_active_velocities'] = midi_pianoroll(tones['f0_hz'])
  provider = ArrayDataProvider([{k: v[i] for k, v in tones.items()}
                                for i in range(EVAL_BATCH)])
  noise = midi_noise_dict(torch, EVAL_BATCH, 60)
  launches, results = {}, {}
  for label, d in (('card', dev), ('cpu', torch.device('cpu'))):
    evs = [BasicEvaluator(audio_key='synth_audio'),
           MidiAutoencoderEvaluator(), MidiHeuristicEvaluator()]
    recorder = RecordingMidiEvaluators(evs[1], evs[2], 250)
    reset_launches()
    t0 = time.time()
    scalars = evaluate_or_sample(
        provider, Trainer(build_model('midiae', seed=1, device=d), device=d),
        os.path.join(work_dir, 'midiae_eval'), restore_dir=save_dir,
        evaluators=evs, batch_size=EVAL_BATCH, num_batches=1,
        noise=on(d, noise))
    if label == 'card':
      torch.cuda.synchronize()
      launches['midiae_eval'] = read_launches()
    results[label] = (scalars, note_tuples(recorder.sequences))
    print(f'  eval on the {label}: {time.time() - t0:.2f} s; {scalars}')
  scalars, sequences = results['card']
  print(f'  eval launches {launches["midiae_eval"]}; predicted notes per '
        'example (learned, heuristic): ' + str(
            [[len(s) for s in seqs] for _, seqs in sequences]))
  check(launches['midiae_eval']['K1f'] == 2 and
        launches['midiae_eval']['K1t'] == 0,
        'midiae eval: one batch through K1f twice, no backward kernel')
  midi_keys = [k for k in scalars if k.startswith('metrics/midi/')]
  check(len(midi_keys) == 18 and 'losses/total_loss' in scalars and
        all(np.isfinite(v) for v in scalars.values()),
        'midiae eval: the losses and both MIDI evaluators\' 18 metrics, '
        'finite')
  check(sequences == results['cpu'][1],
        'the predicted note sequences (the learned piano roll\'s and the '
        'heuristic\'s) equal the CPU port\'s')
  check(scalars == results['cpu'][0] or all(
      abs(v - results['cpu'][0][k]) <= EVAL_LOSS_RTOL * abs(v)
      for k, v in scalars.items()),
        'the eval scalars agree with the CPU port\'s (the MIDI metrics '
        f'exactly, the losses within {EVAL_LOSS_RTOL})')
  reset_launches()
  evaluate_or_sample(provider, Trainer(build_model('midiae', seed=1)),
                     os.path.join(work_dir, 'midiae_eval'),
                     restore_dir=save_dir, mode='sample',
                     batch_size=EVAL_BATCH, num_batches=1,
                     noise=on(dev, noise))
  torch.cuda.synchronize()
  launches['midiae_sample'] = read_launches()
  files = os.listdir(os.path.join(work_dir, 'midiae_eval', 'samples',
                                  f'step_{TRAIN_STEPS}'))
  print(f'  sample: launches {launches["midiae_sample"]}, '
        f'{len(files)} files')
  check(launches['midiae_sample']['K1f'] == 2 and
        '0_midi_audio.wav' in files and '0_synth_audio.wav' in files,
        'midiae sample: K1f twice, the MIDI and synth wavs written')
  return launches


def midiae_cli(torch, work_dir, pattern):
  """ddsp-torch-run --preset midiae on phase 6c's records: CLI_AE_STEPS
  steps, one eval batch; the serving classes refuse the directory."""
  from ddsp_torch import run
  from ddsp_torch.infer import AutoencoderInference, export_model
  cli_dir = os.path.join(work_dir, 'cli_midiae')
  common = ['--save_dir', cli_dir, '--data', f'tfrecord:{pattern}',
            '--batch_size', str(BATCH)]
  reset_launches()
  state = run.main(['--mode', 'train', '--preset', 'midiae', '--num_steps',
                    str(CLI_AE_STEPS), '--steps_per_summary', '1',
                    '--steps_per_save', str(CLI_AE_STEPS)] + common)
  torch.cuda.synchronize()
  launches = {'cli_midiae_train': read_launches()}
  print(f'  CLI midiae train: step {state.step}, launches '
        f'{launches["cli_midiae_train"]}')
  per_step = {'K1f': 2, 'K1t': 1, 'K1p': 0, 'K2f': 0, 'K2b': 0, 'K2b_w': 0,
              'K3': 0}
  check(state.step == CLI_AE_STEPS and launches['cli_midiae_train'] == {
      k: v * CLI_AE_STEPS for k, v in per_step.items()},
        f'the CLI trained midiae {CLI_AE_STEPS} steps, each {per_step}')
  reset_launches()
  out = run.main(['--mode', 'eval', '--run_once', '--num_eval_batches', '1']
                 + common)
  torch.cuda.synchronize()
  launches['cli_midiae_eval'] = read_launches()
  print(f'  CLI midiae eval: launches {launches["cli_midiae_eval"]}, {out}')
  check(launches['cli_midiae_eval']['K1f'] == 2 and
        np.isfinite(out['losses/total_loss']),
        '--mode eval of midiae: one batch through K1f twice, a finite '
        'total_loss')
  for what, call in (
      ('AutoencoderInference', lambda: AutoencoderInference(cli_dir)),
      ("export_model fmt='params'", lambda: export_model(
          cli_dir, os.path.join(work_dir, 'midiae_params'))),
      ("export_model fmt='torch_export'", lambda: export_model(
          cli_dir, os.path.join(work_dir, 'midiae_program'),
          fmt='torch_export'))):
    try:
      call()
      refused = ''
    except ValueError as e:
      refused = str(e)
    print(f'  {what}: {refused[:120]}')
    check('MidiAutoencoder' in refused and 'midi_to_audio' in refused,
          f'{what} refuses the midiae directory, naming the forward and '
          'midi_to_audio')
  return launches


# Phase 6j: the inverse_synthesis preset (magenta/ddsp
# gin/papers/icml2020/pretrain_model.gin, DDSP-INV) at full width: a
# ResnetSinusoidalEncoder ('small') over a 229-bin log mel of 250 frames at
# 4 s with heads of 100 x 64 frequency logits, 100 amplitudes and 65 noise
# bands; a SinusoidalToHarmonicEncoder on an RnnSandwich (FcStacks of 256,
# a GRU of 512 over the 250 frames: K2f, and K2b with its weight-gradient
# pass in a step) with 100 harmonics; a Sinusoidal + FilteredNoise group
# run at both levels (plain torch: no TPU kernel computes it); SpectralLoss,
# KDE, harmonic and filtered-noise consistency; 60 583 882 parameters. The
# phase pins full float32 for the process (cuDNN's and the matmuls' TF32
# off) and restores the settings after: the 6400-wide frequency head's
# logits pass through a softmax over 64 bins into every sinusoid's
# frequency, and a relative departure of a frequency is multiplied by the
# phase it integrates (~1e4 rad at 4 s).
INV_REQUESTS = 4
INV_SINUSOIDS = 100
INV_NOISE = 65
INV_STEP_BATCH = 2    # the rows of each half of the step held against the CPU
# The controls of the card against the CPU port, relative L2: the sinusoidal
# level's (ResNet and heads in full float32: sums in another order; 1.8e-6
# at most on an H100) and the harmonic level's (the RnnSandwich's GRU on
# bf16 streams, K2 against its plain version, whose h agree to
# K2_ATOL['bfloat16']: f0_hz 3.7e-4, harm_amp 5.3e-4 at most on an H100).
# harm_dist is held on the frames where both devices mute the same
# harmonics: normalize_harmonics mutes a harmonic at or above Nyquist and
# renormalizes the frame, so a harmonic within f0's departure of 8 kHz is
# muted on one device only and moves its whole frame (1.7e-3 without such
# a frame, 1.7e-2 and 3.5e-2 over all frames with one, on an H100). The
# frames muted apart are counted and their f0 held at this tolerance.
INV_SIN_CONTROLS_RTOL = 1e-3
INV_HARM_CONTROLS_RTOL = 2e-2
# The audio of the card's controls against the CPU port's synthesis of the
# same controls: the same plain torch code, but the two devices round the
# resampled frequency envelopes apart by an ulp (1e-7), which the float64
# phase sum carries into up to ~2e5 rad (8 kHz over 4 s): ~1e-2 rad at the
# top, and the phase's own float32 spacing there is 7.8e-3 rad (3.6e-4
# and 2.1e-3 measured on an H100 at the two levels).
INV_SYNTH_RTOL = 1e-2
# The B = 2 + 2 zipped step's gradients, card against the CPU port. The
# synthesis departs between the devices (INV_SYNTH_RTOL), and two paths
# magnify it, so these are printed and not held: the harmonic encoder's
# gradient through the SpectralLoss reaches f0 through the phase of every
# harmonic, and the card's f0 departs by ~3.5e-4 (the GRU's bf16 streams),
# which moves an upper harmonic's phase by radians over 4 s (harm_audio
# departs by ~0.6, the mag term's gradient of the harmonic encoder by 3.2
# on an H100); and the synthetic rows' audio, synthesized on each device,
# reaches the sinusoidal encoder, whose self-supervised KDE gradient
# (gaussians of 0.1 semitone) departs by 4.4e-2. Held at IR_MAG_STEP_RTOL:
# the sinusoidal encoder with the mag term (1.5e-3), the harmonic encoder
# with the consistency losses alone (the controls against each other and
# the ground truth, no phase: 2.0e-3), and the harmonic level's mag term
# from one set of controls, the card's, on both devices: its gradient with
# respect to f0_hz, harm_amp and harm_dist (inv_harm_mag_witness; the same
# gradient from the CPU port's own controls, and from the card's with the
# CPU port's f0 alone, is printed beside it as the measure of the cause).
# The TWM f0 of one eval example's sinusoids, card against CPU: the frames
# whose f0 differs (a near-tie of two candidates' losses can go either way).
INV_TWM_FRAMES_ATOL = 0.01


def inv_noise(torch, batch, seed):
  """One processor-group call's FilteredNoise draw, [batch, 64000] in
  [-1, 1), made on the host."""
  return torch.rand((batch, N_SAMPLES),
                    generator=torch.Generator().manual_seed(seed)) * 2 - 1


def inv_notes(batch, seed):
  """Self-supervised controls at the encoder's 250 frames (the preset's 100
  sinusoids and harmonics, 65 noise bands) from SyntheticNotesProvider,
  made on the host."""
  from ddsp_torch.data.multi import SyntheticNotesProvider
  provider = SyntheticNotesProvider(INV_FRAMES, INV_SINUSOIDS, INV_NOISE,
                                    n_examples=batch, seed=seed,
                                    device='cpu')
  return next(provider.get_batch(batch, shuffle=False))


def inv_on(torch, feats, d):
  """A feed (a dict, or a tuple of dicts) as float32 tensors on d."""
  if isinstance(feats, tuple):
    return tuple(inv_on(torch, f, d) for f in feats)
  return {k: torch.as_tensor(np.asarray(v, np.float32)).to(d)
          for k, v in feats.items()}


def inv_harm_dist(torch, out, cpu_out):
  """harm_dist of the card against the CPU port: (relative L2 over the
  frames where both devices mute the same harmonics at Nyquist, the frames
  muted apart, the largest relative f0 departure on those frames)."""
  nyquist = SR / 2.0
  muted_g = out['harm_freqs'].cpu() >= nyquist
  muted_c = cpu_out['harm_freqs'] >= nyquist
  same = (muted_g == muted_c).all(dim=-1)
  rel = rel_l2(out['harm_dist'].cpu()[same], cpu_out['harm_dist'][same])
  f0_g, f0_c = out['f0_hz'].cpu()[..., 0].double(), cpu_out['f0_hz'][
      ..., 0].double()
  apart = ~same
  f0_apart = ((f0_g[apart] - f0_c[apart]).abs() / f0_c[apart]).max().item() \
      if apart.any() else 0.0
  return rel, int(apart.sum()), f0_apart


def inv_resynthesize(torch, cpu_model, out, level, noise):
  """The CPU port's processor group on the card's controls of one level."""
  amps, freqs = (('sin_amps', 'sin_freqs') if level == 'sin' else
                 ('harm_amps', 'harm_freqs'))
  with torch.no_grad():
    return cpu_model.processor_group({
        'amplitudes': out[amps].cpu(), 'frequencies': out[freqs].cpu(),
        'noise_magnitudes': out['noise_magnitudes'].cpu()}, noise=noise)


def phase_inverse_synthesis(torch, dev, work_dir, dense_ms, profile=False):
  """[6j] the inverse_synthesis preset: requests, training on the plain,
  self-supervised and zipped feeds, a B = 2 step against the CPU port, an
  eval batch (TWMEvaluator and the default evaluators), the CLI, and the
  serving classes' refusal. Returns the launches of each path."""
  from ddsp_torch.utils import build_model
  print(f'[6j] inverse_synthesis (full width, float32 pinned, the GRU on '
        f'bf16 streams): {INV_REQUESTS} requests of 4 s, {TRAIN_STEPS} '
        f'training steps at {BATCH} x 4 s on each of three feeds, a B = '
        f'{INV_STEP_BATCH} step against the CPU port, eval, the CLI',
        flush=True)
  saved = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  try:
    cpu_model = build_model('inverse_synthesis', device='cpu', seed=0)
    model = build_model('inverse_synthesis')
    model.load_state_dict(cpu_model.state_dict())
    model.eval()
    launches = inv_requests(torch, dev, model, cpu_model, profile)
    save_dir = os.path.join(work_dir, 'inv_train')
    launches.update(inv_training(torch, dev, cpu_model, save_dir, dense_ms,
                                 profile))
    inv_step_against_cpu(torch, dev, cpu_model)
    launches.update(inv_eval(torch, dev, work_dir, save_dir))
    launches.update(inv_cli(torch, work_dir))
  finally:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = saved
  return launches


def inv_requests(torch, dev, model, cpu_model, profile=False):
  """INV_REQUESTS requests of 4 s at B = 1 on phase 6's tones: the forward
  of both levels (audio in, explicit noise), against the CPU port."""
  clips = training_batch(INV_REQUESTS, seed=11)['audio']

  def request(m, i, d):
    with torch.no_grad():
      return m({'audio': torch.from_numpy(clips[i:i + 1]).to(d)},
               training=False, noise=inv_noise(torch, 1, 70 + i).to(d),
               harmonic_noise=inv_noise(torch, 1, 80 + i).to(d))

  lengths, unhook = gru_lengths(torch, model)
  reset_launches()
  outs = [request(model, i, dev) for i in range(INV_REQUESTS)]
  torch.cuda.synchronize()
  launches = {'inv_request': read_launches()}
  unhook()
  print(f'  launches over {INV_REQUESTS} requests: '
        f'{launches["inv_request"]}; FastGRU (module, T, dtype): '
        f'{lengths[:1]}')
  check(launches['inv_request'] == {
      'K1f': 0, 'K1t': 0, 'K1p': 0, 'K2f': INV_REQUESTS, 'K2b': 0,
      'K2b_w': 0, 'K3': 0},
        'each inverse_synthesis request launched K2f once (the '
        'RnnSandwich\'s GRU) and no other kernel')
  check(lengths[:1] == [('harmonic_encoder.net.Rnn_0.FastGRU_0', INV_FRAMES,
                         torch.bfloat16)],
        f'the RnnSandwich\'s GRU runs bf16 over the encoder\'s {INV_FRAMES} '
        'frames')
  for i, out in enumerate(outs):
    cpu_out = request(cpu_model, i, 'cpu')
    for key in ('sin_audio', 'harm_audio'):
      check(tuple(out[key].shape) == (1, N_SAMPLES) and
            torch.isfinite(out[key]).all().item() and
            out[key].abs().max().item() > 0,
            f'request {i}: {key} [1, {N_SAMPLES}] finite, not silent')
    check(tuple(out['sin_freqs'].shape) == (1, INV_FRAMES, INV_SINUSOIDS) and
          tuple(out['f0_hz'].shape) == (1, INV_FRAMES, 1),
          f'request {i}: {INV_SINUSOIDS} sinusoids and an f0 at '
          f'{INV_FRAMES} frames')
    controls = {k: rel_l2(out[k].cpu(), cpu_out[k])
                for k in ('sin_freqs', 'sin_amps', 'noise_magnitudes',
                          'f0_hz', 'harm_amp', 'harm_dist')}
    dist_same, n_apart, f0_apart = inv_harm_dist(torch, out, cpu_out)
    sin_c = max(controls['sin_freqs'], controls['sin_amps'],
                controls['noise_magnitudes'])
    harm_c = max(controls['f0_hz'], controls['harm_amp'], dist_same,
                 f0_apart)
    audio = {k: rel_l2(out[k].cpu(), cpu_out[k])
             for k in ('sin_audio', 'harm_audio')}
    synth = {lv: rel_l2(out[f'{lv}_audio'].cpu(), inv_resynthesize(
        torch, cpu_model, out, lv, inv_noise(
            torch, 1, (70 if lv == 'sin' else 80) + i)))
             for lv in ('sin', 'harm')}
    cpu_f0 = rel_l2(inv_resynthesize(torch, cpu_model, dict(
        out, harm_freqs=cpu_out['harm_freqs']), 'harm', inv_noise(
            torch, 1, 80 + i)), inv_resynthesize(
                torch, cpu_model, out, 'harm', inv_noise(torch, 1, 80 + i)))
    print(f'  request {i}, card against the CPU port, relative L2: '
          'controls ' + ', '.join(f'{k} {v:.3e}' for k, v in controls.items())
          + f' (harm_dist {dist_same:.3e} on the frames muted alike, '
          f'{n_apart} frame(s) muted apart, their f0 {f0_apart:.3e} apart)'
          '; audio '
          f'(printed) sin_audio {audio["sin_audio"]:.3e}, harm_audio '
          f'{audio["harm_audio"]:.3e}; the card\'s controls re-synthesized '
          f'on the CPU: sin {synth["sin"]:.3e}, harm {synth["harm"]:.3e}; '
          f'(printed) with the CPU port\'s harmonic frequencies in place of '
          f'the card\'s, harm {cpu_f0:.3e}')
    check(sin_c <= INV_SIN_CONTROLS_RTOL and harm_c <= INV_HARM_CONTROLS_RTOL,
          f'request {i}: the sinusoidal controls within '
          f'{INV_SIN_CONTROLS_RTOL} and the harmonic ones (f0_hz, harm_amp, '
          f'harm_dist on the frames muted alike, f0 on those muted apart) '
          f'within {INV_HARM_CONTROLS_RTOL} of the CPU port')
    check(max(synth.values()) <= INV_SYNTH_RTOL,
          f'request {i}: both levels\' audio within {INV_SYNTH_RTOL} of the '
          'CPU port\'s synthesis of the same controls')
  request_ms, times = timed_median(torch, lambda: request(model, 1, dev))
  print(f'  inverse_synthesis request ms: {[round(t, 3) for t in times]}')
  print(f'  median ms per 4 s inverse_synthesis request: {request_ms:.3f}',
        flush=True)
  if profile:
    profile_steps(torch, lambda: request(model, 1, dev), 3, request_ms,
                  'inverse_synthesis request')
  return launches


def inv_feeds():
  """The three training feeds at BATCH x 4 s: phase 6's tones, synthetic
  notes at the encoder's frames, and both zipped (2 x BATCH rows)."""
  audio = {'audio': training_batch()['audio']}
  notes = inv_notes(BATCH, seed=5)
  return {'plain': audio, 'self_supervised': notes,
          'zipped': (audio, notes)}


def inv_training(torch, dev, cpu_model, save_dir, dense_ms, profile=False):
  """TRAIN_STEPS Trainer.train_steps on each feed from the same start;
  median ms, peak memory and launches per feed; the self-supervised run's
  checkpoint in save_dir. Returns the launches ('inv_train_<feed>')."""
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model, save_spec
  save_spec(save_dir, 'inverse_synthesis')
  model = build_model('inverse_synthesis')
  launches = {}
  ss_keys = ['harm_spectral_loss', 'kde_consistency_loss',
             'sin_spectral_loss', 'ss_f0_hz_loss',
             'ss_filtered_noise_consistency_loss', 'ss_harm_amp_loss',
             'ss_harm_dist_loss', 'ss_kde_consistency_loss', 'total_loss']
  keys = {'plain': ['harm_spectral_loss', 'kde_consistency_loss',
                    'sin_spectral_loss', 'total_loss'],
          'self_supervised': ss_keys, 'zipped': ss_keys}
  for feed, batch in inv_feeds().items():
    model.load_state_dict(cpu_model.state_dict())
    trainer = Trainer(model, seed=0)
    state = trainer.init()
    batch = inv_on(torch, batch, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      state, step_losses = trainer.train_step(state, batch)
      end.record()
      torch.cuda.synchronize()
      times.append(start.elapsed_time(end))
      losses.append({k: v.item() for k, v in step_losses.items()})
    launches[f'inv_train_{feed}'] = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    totals = [l['total_loss'] for l in losses]
    step_ms = float(np.median(times[TRAIN_STEPS // 2:]))
    rows = 2 * BATCH if feed == 'zipped' else BATCH
    print(f'  {feed} ({rows} rows): launches over {TRAIN_STEPS} steps '
          f'{launches[f"inv_train_{feed}"]}; loss keys {sorted(losses[0])}')
    print(f'  {feed}: total_loss per step {[round(l, 2) for l in totals]}')
    print(f'  {feed}: step ms {[round(t, 2) for t in times]}')
    print(f'  {feed}: median ms per step (the last {TRAIN_STEPS // 2}) '
          f'{step_ms:.3f}, {step_ms / dense_ms:.3f}x phase 6\'s '
          f'solo_instrument step ({dense_ms:.3f}); peak device memory '
          f'{peak_gb:.2f} GiB (torch.cuda.max_memory_allocated)', flush=True)
    check(sorted(losses[0]) == keys[feed],
          f'the {feed} feed\'s losses carry the JAX package\'s keys')
    check(all(np.isfinite(totals)), f'every {feed} loss finite')
    want = {'K1f': 0, 'K1t': 0, 'K1p': 0, 'K2f': 1, 'K2b': 1, 'K2b_w': 1,
            'K3': 0}
    check(launches[f'inv_train_{feed}'] == {k: v * TRAIN_STEPS
                                            for k, v in want.items()},
          f'per {feed} step: {want} (one forward of all rows, the GRU '
          'through K2f, K2b and its weight-gradient pass)')
    if profile:
      profile_steps(torch, lambda: trainer.train_step(state, batch), 3,
                    step_ms, f'inverse_synthesis {feed} step')
    if feed == 'self_supervised':
      trainer.save(state, save_dir)
  return launches


def inv_step(torch, model, feats, noise, terms='all'):
  """One zipped training forward/backward: (losses, {name: grad}). terms:
  'all' (the preset's losses), 'mag' (the SpectralLoss with its mag term
  only, the consistency losses kept) or 'consistency' (no SpectralLoss)."""
  saved = model.losses
  if terms == 'mag':
    model.losses = mag_only_losses(torch, model).to(
        next(model.parameters()).device)
  elif terms == 'consistency':
    model.losses = torch.nn.ModuleList()
  try:
    _, losses = model(feats, training=True, return_losses=True, **noise)
  finally:
    model.losses = saved
  named = list(model.named_parameters())
  grads = torch.autograd.grad(losses['total_loss'], [p for _, p in named],
                              allow_unused=True)
  return ({k: v.item() for k, v in losses.items()},
          {n: g for (n, _), g in zip(named, grads) if g is not None})


def inv_harm_level(torch, model, feats, noise):
  """The zipped step's harmonic level on the model's device, every row, no
  gradient: (the audio its loss compares against, the controls)."""
  real, synthetic = model.parse_zipped_features(feats)
  with torch.no_grad():
    audio = torch.cat([real['audio'], model.generate_synthetic_audio(
        synthetic, noise['synthetic_noise'])], dim=0)
    out = model.forward_levels({'audio': audio}, training=True,
                               noise=noise['noise'],
                               harmonic_noise=noise['harmonic_noise'])
  return audio, {k: out[k] for k in ('f0_hz', 'harm_amp', 'harm_dist',
                                     'noise_magnitudes')}


def inv_harm_mag_grads(torch, model, target, controls, noise):
  """d (the SpectralLoss's mag term on the harmonic level's audio) /
  d (f0_hz, harm_amp, harm_dist), from the given controls on the model's
  device, flattened into one float64 vector each on the host."""
  from ddsp_torch.ops.oscillator import get_harmonic_frequencies
  leaves = {k: controls[k].detach().clone().requires_grad_(True)
            for k in ('f0_hz', 'harm_amp', 'harm_dist')}
  audio = model.processor_group({
      'frequencies': get_harmonic_frequencies(
          leaves['f0_hz'], int(leaves['harm_dist'].shape[-1])),
      'amplitudes': leaves['harm_amp'] * leaves['harm_dist'],
      'noise_magnitudes': controls['noise_magnitudes']}, noise=noise)
  loss = mag_only_losses(torch, model).to(target.device)[0](target, audio)
  grads = torch.autograd.grad(loss, list(leaves.values()))
  return {k: g.double().flatten().cpu() for k, g in zip(leaves, grads)}


def inv_harm_mag_witness(torch, gpu_model, cpu_model, gpu_feats, cpu_feats,
                         gpu_noise, noise):
  """The harmonic level's mag-term gradient with respect to its controls,
  card against the CPU port from the card's controls (held at
  IR_MAG_STEP_RTOL); printed beside it, the CPU port's from its own
  controls and from the card's with its own f0 alone."""
  target_g, controls_g = inv_harm_level(torch, gpu_model, gpu_feats,
                                        gpu_noise)
  target_c, controls_c = inv_harm_level(torch, cpu_model, cpu_feats, noise)
  card_on_cpu = {k: v.cpu() for k, v in controls_g.items()}
  card = inv_harm_mag_grads(torch, gpu_model, target_g, controls_g,
                            gpu_noise['harmonic_noise'])
  same = inv_harm_mag_grads(torch, cpu_model, target_g.cpu(), card_on_cpu,
                            noise['harmonic_noise'])
  own = inv_harm_mag_grads(torch, cpu_model, target_c, controls_c,
                           noise['harmonic_noise'])
  cpu_f0 = inv_harm_mag_grads(
      torch, cpu_model, target_g.cpu(),
      dict(card_on_cpu, f0_hz=controls_c['f0_hz']), noise['harmonic_noise'])
  rels = {name: {k: rel_l2(g[k], same[k]) for k in same}
          for name, g in (('card', card), ('cpu_own_controls', own),
                          ('cpu_f0_only', cpu_f0))}
  f0_rel = rel_l2(controls_g['f0_hz'].cpu(), controls_c['f0_hz'])
  print('  the harmonic level\'s mag-term gradient with respect to its '
        'controls, relative L2 against the CPU port\'s from the card\'s '
        f'controls: the card\'s {rels["card"]}; (printed) the CPU port\'s '
        f'from its own controls {rels["cpu_own_controls"]}, from the card\'s '
        f'with its own f0 (f0_hz {f0_rel:.3e} apart) '
        f'{rels["cpu_f0_only"]}', flush=True)
  check(max(rels['card'].values()) <= IR_MAG_STEP_RTOL,
        'the harmonic level\'s mag-term gradient with respect to f0_hz, '
        f'harm_amp and harm_dist within {IR_MAG_STEP_RTOL} of the CPU '
        'port\'s from the same controls')


def inv_step_against_cpu(torch, dev, cpu_model):
  """A zipped step of INV_STEP_BATCH + INV_STEP_BATCH rows on the card
  against the CPU port, one state dict and noise: every loss term; the
  sinusoidal encoder's gradients with the SpectralLoss's mag term alone,
  the harmonic encoder's with the consistency losses alone, and the
  harmonic level's mag-term gradient with respect to its controls from
  the same controls (the others printed; the comment above
  INV_TWM_FRAMES_ATOL says why)."""
  from ddsp_torch.utils import build_model
  b = INV_STEP_BATCH
  feats = ({'audio': training_batch(b, seed=21)['audio']},
           inv_notes(b, seed=22))
  noise = {'synthetic_noise': inv_noise(torch, b, 90),
           'noise': inv_noise(torch, 2 * b, 91),
           'harmonic_noise': inv_noise(torch, 2 * b, 92)}
  gpu_model = build_model('inverse_synthesis')
  gpu_model.load_state_dict(cpu_model.state_dict())
  gpu_feats, gpu_noise = inv_on(torch, feats, dev), {
      k: v.to(dev) for k, v in noise.items()}
  results = {}
  for terms in ('all', 'mag', 'consistency'):
    t0 = time.time()
    cpu = inv_step(torch, cpu_model, inv_on(torch, feats, 'cpu'), noise,
                   terms)
    cpu_s = time.time() - t0
    results[terms] = (inv_step(torch, gpu_model, gpu_feats, gpu_noise,
                               terms), cpu)
    print(f'  the CPU step ({terms} terms) took {cpu_s:.1f} s')
  (losses_gpu, grads_gpu), (losses_cpu, _) = results['all']
  rels = {k: abs(losses_gpu[k] - v) / abs(v) for k, v in losses_cpu.items()}
  print('  zipped step, B = 2 + 2, each loss term GPU (CPU, relative): ' +
        ', '.join(f'{k} {losses_gpu[k]:.5f} ({v:.5f}, {rels[k]:.2e})'
                  for k, v in losses_cpu.items()))
  check(sorted(losses_gpu) == sorted(losses_cpu) and
        max(rels.values()) <= STEP_LOSS_RTOL,
        f'every loss term of the zipped step within {STEP_LOSS_RTOL} of the '
        'CPU port')
  check(all(torch.isfinite(g).all().item() for g in grads_gpu.values()),
        'every inverse_synthesis gradient finite')
  parts = ('sinusoidal_encoder.', 'harmonic_encoder.')
  grad_rels = {}
  for terms, ((_, g_gpu), (_, g_cpu)) in results.items():
    grad_rels[terms] = {p: rel_l2(flat_grads(torch, g_gpu, p),
                                  flat_grads(torch, g_cpu, p))
                        for p in parts}
    print(f'  {terms} terms, gradients GPU against CPU, relative L2: '
          f'{grad_rels[terms]}')
  check(grad_rels['mag']['sinusoidal_encoder.'] <= IR_MAG_STEP_RTOL,
        f'the zipped step with the mag term only: the sinusoidal encoder\'s '
        f'gradients within {IR_MAG_STEP_RTOL} of the CPU port')
  check(grad_rels['consistency']['harmonic_encoder.'] <= IR_MAG_STEP_RTOL,
        f'the zipped step with the consistency losses only: the harmonic '
        f'encoder\'s gradients within {IR_MAG_STEP_RTOL} of the CPU port')
  inv_harm_mag_witness(torch, gpu_model, cpu_model, gpu_feats,
                       inv_on(torch, feats, 'cpu'), gpu_noise, noise)


def inv_eval(torch, dev, work_dir, save_dir):
  """evaluate_or_sample of the self-supervised checkpoint: one batch of
  EVAL_BATCH synthetic notes at the encoder's frames through the default
  evaluators (BasicEvaluator on harm_audio, TWMEvaluator on the card); the
  TWM f0 of one example on the card against the CPU."""
  from ddsp_torch.data.multi import SyntheticNotesProvider
  from ddsp_torch.eval import evaluate_or_sample
  from ddsp_torch.eval import eval_util
  from ddsp_torch.losses import TWMLoss
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  provider = SyntheticNotesProvider(INV_FRAMES, INV_SINUSOIDS, INV_NOISE,
                                    n_examples=EVAL_BATCH, seed=23,
                                    device='cpu')
  trainer = Trainer(build_model('inverse_synthesis', seed=1))
  chosen = eval_util.default_evaluators(
      trainer.model, provider, dev,
      next(provider.get_batch(EVAL_BATCH, shuffle=False)))
  reset_launches()
  t0 = time.time()
  scalars = evaluate_or_sample(provider, trainer,
                               os.path.join(work_dir, 'inv_eval'),
                               restore_dir=save_dir, evaluators=chosen,
                               batch_size=EVAL_BATCH, num_batches=1,
                               noise=inv_noise(torch, EVAL_BATCH, 93).to(dev))
  torch.cuda.synchronize()
  seconds = time.time() - t0
  launches = {'inv_eval': read_launches()}
  print(f'  eval: {seconds:.2f} s, evaluators '
        f'{[type(e).__name__ for e in chosen]}, launches '
        f'{launches["inv_eval"]}, {scalars}')
  check([type(e).__name__ for e in chosen] == ['BasicEvaluator',
                                               'TWMEvaluator'] and
        launches['inv_eval']['K2f'] == 1 and
        launches['inv_eval']['K2b'] == 0,
        'inverse_synthesis eval: the default evaluators (BasicEvaluator, '
        'TWMEvaluator), one batch through K2f once')
  check('metrics/f0_twm/raw_pitch_accuracy' in scalars and
        all(np.isfinite(v) for v in scalars.values()),
        'inverse_synthesis eval: the losses and the TWM f0 metrics, finite')
  # The TWM f0 of one example's sinusoids on the card against the CPU.
  batch = next(provider.get_batch(1, shuffle=False))
  with torch.no_grad():
    out = trainer.model(inv_on(torch, batch, dev), training=False,
                        noise=inv_noise(torch, 1, 94).to(dev))
  controls = out['sinusoidal']['controls']
  freqs, amps = controls['frequencies'], controls['amplitudes']
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  f0_card = TWMLoss().predict_f0(freqs, freqs, amps)
  end.record()
  torch.cuda.synchronize()
  f0_cpu = TWMLoss().predict_f0(freqs.cpu(), freqs.cpu(), amps.cpu())
  differ = float(np.mean(f0_card != f0_cpu))
  print(f'  TWM f0 of one example ({INV_FRAMES} frames x {INV_SINUSOIDS} '
        f'candidates): {start.elapsed_time(end):.2f} ms on the card; frames '
        f'whose f0 differs from the CPU\'s: {differ:.4f}')
  check(differ <= INV_TWM_FRAMES_ATOL,
        f'the TWM f0 on the card equals the CPU\'s at all but '
        f'{INV_TWM_FRAMES_ATOL} of the frames')
  return launches


def inv_cli(torch, work_dir):
  """ddsp-torch-run --preset inverse_synthesis --data synthetic_notes
  (the notes generated on the card at the encoder's frames): CLI_AE_STEPS
  steps and one eval batch; the serving classes refuse the directory."""
  from ddsp_torch import run
  from ddsp_torch.infer import AutoencoderInference, export_model
  cli_dir = os.path.join(work_dir, 'cli_inv')
  common = ['--save_dir', cli_dir, '--data', 'synthetic_notes',
            '--batch_size', str(BATCH)]
  reset_launches()
  state = run.main(['--mode', 'train', '--preset', 'inverse_synthesis',
                    '--num_steps', str(CLI_AE_STEPS), '--steps_per_summary',
                    '1', '--steps_per_save', str(CLI_AE_STEPS)] + common)
  torch.cuda.synchronize()
  launches = {'cli_inv_train': read_launches()}
  print(f'  CLI inverse_synthesis train: step {state.step}, launches '
        f'{launches["cli_inv_train"]}')
  per_step = {'K1f': 0, 'K1t': 0, 'K1p': 0, 'K2f': 1, 'K2b': 1, 'K2b_w': 1,
              'K3': 0}
  check(state.step == CLI_AE_STEPS and launches['cli_inv_train'] == {
      k: v * CLI_AE_STEPS for k, v in per_step.items()},
        f'the CLI trained inverse_synthesis {CLI_AE_STEPS} steps, each '
        f'{per_step}')
  reset_launches()
  out = run.main(['--mode', 'eval', '--run_once', '--num_eval_batches', '1']
                 + common)
  torch.cuda.synchronize()
  launches['cli_inv_eval'] = read_launches()
  print(f'  CLI inverse_synthesis eval: launches '
        f'{launches["cli_inv_eval"]}, {out}')
  check(launches['cli_inv_eval']['K2f'] == 1 and
        np.isfinite(out['losses/total_loss']) and
        'metrics/f0_twm/raw_pitch_accuracy' in out,
        '--mode eval of inverse_synthesis: one batch through K2f once, a '
        'finite total_loss and the TWM f0 metrics')
  for what, call in (
      ('AutoencoderInference', lambda: AutoencoderInference(cli_dir)),
      ("export_model fmt='params'", lambda: export_model(
          cli_dir, os.path.join(work_dir, 'inv_params'))),
      ("export_model fmt='torch_export'", lambda: export_model(
          cli_dir, os.path.join(work_dir, 'inv_program'),
          fmt='torch_export'))):
    try:
      call()
      refused = ''
    except ValueError as e:
      refused = str(e)
    print(f'  {what}: {refused[:120]}')
    check('encodes audio' in refused and
          'ResnetSinusoidalEncoder' in refused,
          f'{what} refuses the inverse_synthesis directory, naming the '
          'sinusoidal encoder\'s audio input')
  return launches


# Phase 6h: the processors without a TPU kernel, each on the card against
# the port on the CPU, forward and gradient with respect to every float
# input (and ExpDecayReverb's parameters), batch 4 x 4 s.
PROC_BATCH = 4
# Held, relative L2 of the output and of each gradient: float32 FFT
# convolutions (FIRFilter, ExpDecayReverb's 48000-tap IR), interpolation
# weights (ModDelay, the lookup), sums in another order.
PROC_RTOL = 1e-4
# Wavetable and Sinusoidal read a phase summed over 64000 samples and
# rounded to float32, and a random table's slope turns its last bits into
# the output (Wavetable on an H100: 6.9e-3 from the CPU port, and 2.0e-3
# on the card alone for a 1e-7 relative change of its inputs); the
# serving tolerance.
PROC_PHASE_RTOL = E2E_REL_L2
# The gradient with respect to Wavetable's f0 sums the table's slope at a
# running phase over the clip: a 1e-7 relative change of the inputs moves
# it by ~2.5e-2 on the card alone (H100), so it is printed beside that
# response and not held.
PROC_PERTURBATION = 1e-7


def processor_cases(torch):
  """(name, processor factory, inputs [numpy], kwargs of the call,
  tolerance, indices of the inputs whose gradient is printed, not held)."""
  import functools
  from ddsp_torch import proc
  from ddsp_torch.ops import core
  rng = np.random.RandomState(14)

  def x(*shape, scale=1.0, offset=0.0):
    return (offset + scale * rng.randn(*shape)).astype(np.float32)

  b, n, f = PROC_BATCH, N_SAMPLES, N_FRAMES
  audio = training_batch(b, seed=15)['audio']
  f0 = np.abs(x(b, f, 1, scale=30.0, offset=220.0))
  ir_noise = torch.rand((1, REVERB_LENGTH),
                        generator=torch.Generator().manual_seed(16)) * 2 - 1
  return [
      ('TensorToAudio', proc.TensorToAudio, [x(b, n, 1)], {}, PROC_RTOL, ()),
      ('Wavetable (256 entries)', functools.partial(proc.Wavetable,
                                                    n_samples=n),
       [x(b, f, 1), x(b, f, 256), f0], {}, PROC_PHASE_RTOL, (2,)),
      ('Sinusoidal (8 x 16 bins)', functools.partial(
          proc.Sinusoidal, n_samples=n, freq_scale_fn=functools.partial(
              core.frequencies_softmax, depth=16, hz_max=4000.0)),
       [x(b, f, 8), x(b, f, 8 * 16)], {}, PROC_PHASE_RTOL, ()),
      ('ExpDecayReverb (trainable, 48000 taps)', functools.partial(
          proc.ExpDecayReverb, trainable=True, reverb_length=REVERB_LENGTH),
       [audio], {'noise': ir_noise}, PROC_RTOL, ()),
      ('FIRFilter', proc.FIRFilter, [audio, x(b, f, N_NOISE)], {}, PROC_RTOL,
       ()),
      ('ModDelay', proc.ModDelay, [audio, x(b, n, 1), x(b, n, 1)], {},
       PROC_RTOL, ()),
      ('Mix', proc.Mix, [audio, x(b, n), x(b, f, 1)], {}, PROC_RTOL, ()),
  ]


def processor_run(torch, make, inputs, kwargs, d, perturbation=0.0):
  """(output, gradients of the inputs and parameters, seconds) of one
  forward and gradient on device d; the inputs scaled by 1 +
  perturbation * N(0, 1) first, if given."""
  module = make().to(d)
  args = []
  for i, a in enumerate(inputs):
    t = torch.from_numpy(a)
    if perturbation:
      t = t * (1 + perturbation * torch.randn(
          t.shape, generator=torch.Generator().manual_seed(40 + i)))
    args.append(t.to(d).requires_grad_())
  t0 = time.time()
  out = module(*args, **{k: v.to(d) for k, v in kwargs.items()})
  w = torch.randn(out.shape, generator=torch.Generator().manual_seed(17))
  grads = torch.autograd.grad((out * w.to(d)).sum(),
                              args + list(module.parameters()))
  torch.cuda.synchronize()
  return out.detach().cpu(), [g.cpu() for g in grads], time.time() - t0


def phase_processors(torch, dev):
  """[6h] each processor without a kernel: the card against the CPU port;
  launches no kernel."""
  print(f'[6h] the processors without a TPU kernel, batch {PROC_BATCH} x '
        '4 s: the card against the CPU port, forward and gradient',
        flush=True)
  reset_launches()
  for name, make, inputs, kwargs, rtol, unheld in processor_cases(torch):
    out_g, grads_g, s_g = processor_run(torch, make, inputs, kwargs, dev)
    out_c, grads_c, s_c = processor_run(torch, make, inputs, kwargs,
                                        torch.device('cpu'))
    errs = [rel_l2(a, b) for a, b in zip(grads_g, grads_c)]
    print(f'  {name}: output {tuple(out_g.shape)}, relative L2 of the output '
          f'{rel_l2(out_g, out_c):.3e} and of the gradients '
          f'{[f"{e:.3e}" for e in errs]}; forward and gradient {s_g:.3f} s '
          f'on the card, {s_c:.3f} s on the CPU')
    if unheld:
      _, grads_p, _ = processor_run(torch, make, inputs, kwargs, dev,
                                    PROC_PERTURBATION)
      moved = [f'{rel_l2(grads_p[i], grads_g[i]):.3e}' for i in unheld]
      print(f'  {name}: gradients {list(unheld)} not held; on the card '
            f'alone, inputs moved by {PROC_PERTURBATION} (relative), they '
            f'move by {moved}')
    held = [e for i, e in enumerate(errs) if i not in unheld]
    check(all(torch.isfinite(t).all().item() for t in [out_g] + grads_g) and
          max([rel_l2(out_g, out_c)] + held) <= rtol,
          f'{name} on the card within {rtol} of the CPU port, forward and '
          'gradient' + (f' (but input {list(unheld)}\'s)' if unheld else ''))
  torch.cuda.synchronize()
  launches = read_launches()
  check(not any(launches.values()),
        f'the processors launched no kernel ({launches})')


# Phase 6d: evaluate and sample phase 6c's checkpoint, full width: batch 4,
# EVAL_BATCHES batches of 4 s, F0LdEvaluator on CREPE with Viterbi.
EVAL_BATCH = 4
EVAL_BATCHES = 4
# The eval scalars on the card against the same evaluation by the CPU port
# (the same batches and noise). The losses: SpectralLoss of audio that the
# two devices compute 2e-3 apart (relative L2, bf16 GRU routes); its logmag
# term reads near-silent bins at 1/|X| (safe_log clamps only non-positive
# bins; ROADMAP.md section 3), and the synthetic dataset has no noise
# floor, so the loss moves by ~1e-2 relative (8.0e-3 measured on an H100)
# while its mag term, held on the first batch, agrees as a training step's
# loss does (STEP_LOSS_RTOL). The loudness L1 in dB: 20 log10 of amplitudes
# that close, averaged (0.1 dB). Pitch of the generated audio by CREPE with
# Viterbi: an f0 within a cent moves the mean MIDI distance by 0.01;
# RPA/RCA and the outlier ratio count frames and examples, and a frame near
# the 50-cent edge or an example near the 12-MIDI outlier cut may count on
# either side: 2 % of the frames, one example of the 16.
EVAL_LOSS_RTOL = 2e-2
EVAL_MAG_LOSS_RTOL = STEP_LOSS_RTOL
EVAL_LOUDNESS_ATOL_DB = 0.1
EVAL_F0_MIDI_ATOL = 5e-2
EVAL_FRACTION_ATOL = 2e-2
EVAL_OUTLIER_ATOL = 1.0 / (EVAL_BATCH * EVAL_BATCHES)


def eval_tolerance(key, want):
  if key.startswith('losses/'):
    return EVAL_LOSS_RTOL * abs(want)
  if 'loudness' in key:
    return EVAL_LOUDNESS_ATOL_DB
  if 'outlier' in key:
    return EVAL_OUTLIER_ATOL
  if 'accuracy' in key:
    return EVAL_FRACTION_ATOL
  return EVAL_F0_MIDI_ATOL


def timed_calls(torch, module, name, log):
  """Wrap module.name so each call is timed (synchronized) into log."""
  fn = getattr(module, name)

  def timed(*args, **kwargs):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    log.append(time.perf_counter() - t0)
    return out
  setattr(module, name, timed)
  return fn


def phase_eval(torch, dev, work_dir, pattern, train_dir):
  """[6d] evaluate_or_sample of phase 6c's checkpoint: 'eval' on the card
  and on the CPU (the same batches and noise), then 'sample'."""
  from ddsp_torch.data import TFRecordProvider
  from ddsp_torch.eval import evaluate_or_sample
  from ddsp_torch.ops import crepe
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  print(f'[6d] evaluate and sample phase 6c\'s checkpoint: '
        f'{EVAL_BATCHES} batches of {EVAL_BATCH} x 4 s, F0LdEvaluator on '
        'CREPE with Viterbi', flush=True)
  provider = TFRecordProvider(pattern, example_secs=N_SAMPLES / SR)
  noise = torch.rand((EVAL_BATCH, N_SAMPLES),
                     generator=torch.Generator().manual_seed(0)) * 2 - 1
  # The first batch's forward on both devices, its loss whole and its mag
  # term alone.
  first = next(provider.get_batch(EVAL_BATCH, shuffle=False))
  runs = {}
  for name, d in (('cuda', dev), ('cpu', torch.device('cpu'))):
    trainer = Trainer(build_model('solo_instrument', device=d, seed=1),
                      device=d)
    trainer.restore(trainer.init(), train_dir)
    model = trainer.model
    with torch.no_grad():
      outputs, losses = model(trainer.to_device(first), training=False,
                              return_losses=True, noise=noise.to(d))
      model.losses = mag_only_losses(torch, model).to(d)
      _, mag = model(trainer.to_device(first), training=False,
                     return_losses=True, noise=noise.to(d))
    runs[name] = (outputs['audio_synth'].cpu(), losses['total_loss'].item(),
                  mag['total_loss'].item())
  (g_audio, g_loss, g_mag), (c_audio, c_loss, c_mag) = (runs['cuda'],
                                                        runs['cpu'])
  mag_rel = abs(g_mag - c_mag) / abs(c_mag)
  print(f'  first batch: audio relative L2 card against CPU '
        f'{rel_l2(g_audio, c_audio):.3e}; loss card {g_loss:.5f}, CPU '
        f'{c_loss:.5f} ({abs(g_loss - c_loss) / abs(c_loss):.3e} apart); its '
        f'mag term card {g_mag:.5f}, CPU {c_mag:.5f} ({mag_rel:.3e} apart)',
        flush=True)
  check(rel_l2(g_audio, c_audio) <= E2E_REL_L2 and
        mag_rel <= EVAL_MAG_LOSS_RTOL,
        f'the first eval batch\'s audio within {E2E_REL_L2} and its loss\'s '
        f'mag term within {EVAL_MAG_LOSS_RTOL} of the CPU port')
  out = {}
  for name, d in (('cuda', dev), ('cpu', torch.device('cpu'))):
    trainer = Trainer(build_model('solo_instrument', device=d, seed=1),
                      device=d)
    eval_dir = os.path.join(work_dir, f'eval_{name}')
    logs = {'activations': [], 'viterbi': []}
    originals = ()
    if name == 'cuda':
      evaluate_or_sample(provider, trainer, os.path.join(work_dir, 'warm'),
                         restore_dir=train_dir, batch_size=EVAL_BATCH,
                         num_batches=1, noise=noise[:EVAL_BATCH].to(d))
      originals = (
          timed_calls(torch, crepe.PretrainedCrepe, 'activations',
                      logs['activations']),
          timed_calls(torch, crepe, 'crepe_viterbi_centers',
                      logs['viterbi']))
      reset_launches()
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
      scalars = evaluate_or_sample(
          provider, trainer, eval_dir, restore_dir=train_dir,
          batch_size=EVAL_BATCH, num_batches=EVAL_BATCHES,
          noise=noise.to(d))
    finally:
      if originals:
        crepe.PretrainedCrepe.activations = originals[0]
        crepe.crepe_viterbi_centers = originals[1]
    if name == 'cuda':
      torch.cuda.synchronize()
      out['launches'] = read_launches()
    seconds = time.perf_counter() - t0
    out[name] = {'scalars': scalars, 'seconds': seconds, 'logs': logs,
                 'trainer': trainer}
  gpu, cpu = out['cuda'], out['cpu']
  launches = out['launches']
  per_batch = 1e3 * gpu['seconds'] / EVAL_BATCHES
  crepe_s = sum(gpu['logs']['activations'])
  viterbi_s = sum(gpu['logs']['viterbi'])
  print(f'  launches over {EVAL_BATCHES} eval batches: {launches}')
  print(f'  eval on the card: {per_batch:.3f} ms per eval batch (forward, '
        f'losses, metrics); CREPE\'s network {100 * crepe_s / gpu["seconds"]:.1f}'
        f' %, the Viterbi decode {100 * viterbi_s / gpu["seconds"]:.1f} % '
        f'({len(gpu["logs"]["viterbi"])} decodes, '
        f'{1e3 * viterbi_s / max(1, len(gpu["logs"]["viterbi"])):.3f} ms '
        f'each); the CPU port {1e3 * cpu["seconds"] / EVAL_BATCHES:.1f} ms '
        'per batch', flush=True)
  bad = []
  for key in sorted(set(gpu['scalars']) | set(cpu['scalars'])):
    g, c = gpu['scalars'].get(key), cpu['scalars'].get(key)
    tol = eval_tolerance(key, c) if c is not None else 0
    ok = g is not None and c is not None and abs(g - c) <= tol
    print(f'    {key}: card {g}, CPU {c} (tolerance {tol:.3e})')
    if not ok:
      bad.append(key)
  check('metrics/f0_crepe/raw_pitch_accuracy' in gpu['scalars'] and
        all(np.isfinite(v) for v in gpu['scalars'].values()),
        'the eval reports finite scalars, CREPE pitch metrics among them')
  check(not bad, f'the eval scalars on the card match the CPU port\'s '
        f'evaluation of the checkpoint (apart: {bad})')
  check(launches['K1f'] == launches['K2f'] == EVAL_BATCHES and
        all(launches[k] == 0 for k in ('K1t', 'K1p', 'K2b', 'K2b_w', 'K3')),
        'one K1f and one K2f launch per eval batch, no backward kernel')

  sample_dir = os.path.join(work_dir, 'sample')
  reset_launches()
  evaluate_or_sample(provider, gpu['trainer'], sample_dir,
                     restore_dir=train_dir, mode='sample',
                     batch_size=EVAL_BATCH, num_batches=EVAL_BATCHES,
                     noise=noise.to(dev))
  torch.cuda.synchronize()
  sample_launches = read_launches()
  step_dir = os.path.join(sample_dir, 'samples', f'step_{DATA_STEPS}')
  wavs = sorted(n for n in os.listdir(step_dir) if n.endswith('.wav'))
  expected = {f'{i}_{kind}.wav' for i in range(EVAL_BATCH * EVAL_BATCHES)
              for kind in ('original', 'synth')}
  lengths = {len(wav_samples(os.path.join(step_dir, n))) for n in wavs}
  print(f'  sample: {len(wavs)} wavs in {step_dir} ({lengths} samples '
        f'each), launches {sample_launches}')
  check(set(wavs) == expected and lengths == {N_SAMPLES},
        f'sample wrote the {len(expected)} wavs of {N_SAMPLES} samples')
  check(sample_launches['K1f'] == sample_launches['K2f'] == EVAL_BATCHES,
        'sample launches K1f and K2f once per batch')
  return launches


# Phase 6e: prepare records from a 20 s wav on the card. f0 against the
# CPU port's prepare_records of the same file: CREPE's activations within
# CREPE_ACT_ATOL decoded to cents; the Viterbi path may take another state
# where two paths' scores tie within that rounding, which the confident
# frames of a clean glide do not (1 cent); every frame's confidence within
# 1e-4 (CREPE_ACT_ATOL, its max); the loudness within 1e-3 dB (float32
# powers of cuFFT and pocketfft).
PREPARE_SECONDS = 20
PREPARE_F0_CENTS = 1.0
PREPARE_CONFIDENCE_ATOL = CREPE_ACT_ATOL
PREPARE_LOUDNESS_ATOL_DB = 1e-3


def glides_wav(path):
  """PREPARE_SECONDS of harmonic glides (four notes sliding an octave and
  back), 16 kHz, written with write_wav."""
  from ddsp_torch.eval.summaries import write_wav
  t = np.arange(PREPARE_SECONDS * SR) / SR
  note = (t // 5).astype(int)
  base = np.array([110.0, 196.0, 262.0, 147.0])[note]
  f0 = base * 2**(1 - np.abs(((t % 5) / 2.5) - 1.0))
  phase = 2 * np.pi * np.cumsum(f0) / SR
  env = 0.6 * np.minimum(1.0, np.minimum(t % 5, 5 - t % 5) / 0.1)
  audio = env * sum(np.sin(k * phase) / k for k in range(1, 6)) / 2.3
  write_wav(path, audio.astype(np.float32), SR)
  return path


def phase_prepare(torch, dev, work_dir):
  """[6e] prepare_records of a 20 s wav on the card (CREPE with Viterbi,
  loudness) into 2 shards, read back with TFRecordProvider, against the
  CPU port's prepare_records of the same file."""
  from ddsp_torch.data import TFRecordProvider, prepare_records, tfrecord
  print(f'[6e] prepare {PREPARE_SECONDS} s of harmonic glides into '
        'TFRecords (CREPE with Viterbi, loudness)', flush=True)
  wav = glides_wav(os.path.join(work_dir, 'glides', 'glides.wav'))
  written, seconds = {}, {}
  for name, d in (('warm', dev), ('cuda', dev), ('cpu', 'cpu')):
    out_dir = os.path.join(work_dir, f'prepared_{name}')
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    written[name] = prepare_records([wav], os.path.join(out_dir, 'glides'),
                                    num_shards=2, device=d)
    seconds[name] = time.perf_counter() - t0
  print(f'  written {[os.path.basename(p) for p in written["cuda"]]}; '
        f'{PREPARE_SECONDS / seconds["cuda"]:.2f} s of audio prepared per '
        f'second on the card ({seconds["cuda"]:.3f} s; first call '
        f'{seconds["warm"]:.3f} s), {PREPARE_SECONDS / seconds["cpu"]:.2f} '
        'on the CPU port', flush=True)
  provider = TFRecordProvider(os.path.join(work_dir, 'prepared_cuda',
                                           'glides*'), centered=False)
  read = list(provider.get_dataset(shuffle=False))
  examples = {name: [ex for p in written[name]
                     for ex in tfrecord.read_examples(p)]
              for name in ('cuda', 'cpu')}
  n_expected = PREPARE_SECONDS - 4 + 1  # 4 s windows every 1 s
  check(len(written['cuda']) == 2 and len(read) == n_expected ==
        len(examples['cuda']) == len(examples['cpu']),
        f'{n_expected} examples in 2 shards, read back by TFRecordProvider')
  check(all(ex['audio'].shape == (4 * SR,) and ex['f0_hz'].shape == (1000,)
            for ex in read), 'each example 4 s of audio and 1000 frames')
  f0 = {n: np.stack([ex['f0_hz'] for ex in examples[n]]) for n in examples}
  conf = {n: np.stack([ex['f0_confidence'] for ex in examples[n]])
          for n in examples}
  loud = {n: np.stack([ex['loudness_db'] for ex in examples[n]])
          for n in examples}
  confident = conf['cpu'] >= 0.85
  cents = cents_apart(f0['cuda'], f0['cpu'])
  conf_err = np.abs(conf['cuda'] - conf['cpu']).max()
  loud_err = np.abs(loud['cuda'] - loud['cpu']).max()
  # The glides' own f0 at each frame's centre ('same' framing: frame j of
  # the example starting at k s is centred at k + (64 j + 512) / 16000 s).
  t_frames = (np.arange(len(read))[:, None] + (64 * np.arange(1000) + 512)
              / SR)[confident]
  note = np.minimum(t_frames // 5, 3).astype(int)
  truth = np.array([110.0, 196.0, 262.0, 147.0])[note] * 2**(
      1 - np.abs(((t_frames % 5) / 2.5) - 1.0))
  truth_cents = cents_apart(f0['cuda'][confident], truth)
  print(f'  the card\'s f0 on confident frames against the glides\' own: '
        f'median {np.median(truth_cents):.2f} cents, 90th percentile '
        f'{np.percentile(truth_cents, 90):.2f}')
  print(f'  against the CPU port: f0 on the {confident.mean():.3f} '
        f'confident share of frames at most {cents[confident].max():.4f} '
        f'cents apart, on all frames {cents.max():.4f} (within '
        f'{PREPARE_F0_CENTS} cents: {np.mean(cents <= PREPARE_F0_CENTS):.5f}'
        f'); confidence {conf_err:.3e}; loudness {loud_err:.3e} dB')
  check(confident.mean() > 0.5 and
        cents[confident].max() <= PREPARE_F0_CENTS,
        f'f0 of the confident frames within {PREPARE_F0_CENTS} cents of the '
        'CPU port')
  check(conf_err <= PREPARE_CONFIDENCE_ATOL and
        loud_err <= PREPARE_LOUDNESS_ATOL_DB,
        f'confidence within {PREPARE_CONFIDENCE_ATOL} and loudness within '
        f'{PREPARE_LOUDNESS_ATOL_DB} dB of the CPU port')


def wav_samples(path):
  import wave
  with wave.open(path) as w:
    return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def phase_wide_gru_steps(torch, dev):
  """One B = 2 training step of solo_instrument at rnn_channels 384 (the
  bf16 cluster kernels on H zero-padded to 512) and 1024 (the cooperative
  kernels) on the card against the port on the CPU."""
  from ddsp_torch.utils import build_model
  print('[6a] B = 2 training steps of solo_instrument (bf16) at '
        'rnn_channels 384 and 1024', flush=True)
  small = {k: torch.as_tensor(v) for k, v in training_batch(batch=2).items()}
  noise = torch.rand((2, N_SAMPLES),
                     generator=torch.Generator().manual_seed(4)) * 2 - 1
  for channels in (384, 1024):
    route = k2_route_name(torch, channels, torch.bfloat16)
    what = f'rnn_channels={channels}, {route}'
    gpu_model = build_model('solo_instrument', seed=1, rnn_channels=channels)
    cpu_model = build_model('solo_instrument', seed=1, device='cpu',
                            rnn_channels=channels)
    reset_launches()
    loss_gpu, grads_gpu = one_step_gradients(
        torch, gpu_model, {k: v.to(dev) for k, v in small.items()},
        noise.to(dev))
    torch.cuda.synchronize()
    launches = read_launches()
    loss_cpu, grads_cpu = one_step_gradients(torch, cpu_model, small, noise)
    # The decoder's gradient norm, the GRU's included: the reverb IR's
    # gradient of the full loss is conditioned by the logmag term (see
    # IR_NAME), and large enough here to move the global norm by 20 %.
    norm_gpu = global_norm(torch, grads_gpu, 'decoder.')
    norm_cpu = global_norm(torch, grads_cpu, 'decoder.')
    print(f'  {what}: total_loss GPU {loss_gpu:.5f} CPU {loss_cpu:.5f}; '
          f'decoder gradient norm GPU {norm_gpu:.5f} CPU {norm_cpu:.5f} '
          f'(global GPU {global_norm(torch, grads_gpu):.5f} CPU '
          f'{global_norm(torch, grads_cpu):.5f}); launches {launches}',
          flush=True)
    check(all(torch.isfinite(g).all().item() for g in grads_gpu.values()),
          f'{what}: every gradient finite')
    check(abs(loss_gpu - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
          f'{what}: total_loss within {STEP_LOSS_RTOL} of the CPU port')
    check(abs(norm_gpu - norm_cpu) <= STEP_GRAD_NORM_RTOL * norm_cpu,
          f'{what}: decoder gradient norm within {STEP_GRAD_NORM_RTOL} of '
          'the CPU port')
    expected = k2_expected_launches(torch, channels, 2, torch.bfloat16, dev)
    check({k: launches[k] for k in expected} == expected and
          launches['K1f'] == launches['K1t'] == 1,
          f'{what}: K1f, K1t once, K2 {expected}')


# Phase 6l: full-width training steps on the cooperative K2 kernels.
WIDE_STEP_CASES = (('float32', dict(compute_dtype='float32')),
                   ('rnn_channels=1024', dict(rnn_channels=1024)))
WIDE_WARMUP_STEPS, WIDE_TIMED_STEPS = 3, 12


def phase_wide_train_steps(torch, dev, dense_ms, profile):
  """Trainer.train_step of full-width solo_instrument at 16 x 4 s with
  compute_dtype='float32' and with rnn_channels=1024 (bf16): both run K2f
  and K2b on the cooperative kernels once each way per step. Median ms of
  WIDE_TIMED_STEPS steps after WIDE_WARMUP_STEPS, between CUDA events, and
  the launches of one step; beside phase 6's bf16 step."""
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  print(f'[6l] training steps of solo_instrument on the cooperative K2 '
        f'kernels (batch {BATCH} x 4 s)', flush=True)
  batch = training_batch()
  paths = {}
  for label, kwargs in WIDE_STEP_CASES:
    trainer = Trainer(build_model('solo_instrument', seed=0, **kwargs),
                      seed=0)
    state = trainer.init()
    for _ in range(WIDE_WARMUP_STEPS):
      state, losses = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    reset_launches()
    state, losses = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    launches = read_launches()
    hidden = kwargs.get('rnn_channels', HIDDEN)
    bf16 = kwargs.get('compute_dtype', 'bfloat16') == 'bfloat16'
    expected = k2_expected_launches(
        torch, hidden, BATCH, torch.bfloat16 if bf16 else torch.float32, dev)
    check(np.isfinite(losses['total_loss'].item()),
          f'solo_instrument ({label}): the loss is finite')
    check({k: launches[k] for k in expected} == expected and
          launches['K1f'] == launches['K1t'] == 1 and
          kg.fwd_route(torch.bfloat16 if bf16 else torch.float32, N_FRAMES,
                       hidden) == 'cooperative',
          f'solo_instrument ({label}): K1f, K1t once and K2 {expected} a '
          'step, on the cooperative kernels')
    times = []
    for _ in range(WIDE_TIMED_STEPS):
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      state, losses = trainer.train_step(state, batch)
      end.record()
      torch.cuda.synchronize()
      times.append(start.elapsed_time(end))
    median_ms = float(np.median(times))
    print(f'  solo_instrument ({label}) step ms: '
          f'{[round(t, 2) for t in times]}')
    print(f'  median ms per training step ({label}): {median_ms:.3f} '
          f'({median_ms / dense_ms:.2f}x phase 6\'s bf16 step of '
          f'{dense_ms:.3f} ms); audio samples/s trained '
          f'{BATCH * N_SAMPLES / (median_ms / 1e3):.4e}; launches a step '
          f'{launches}', flush=True)
    if profile:
      profile_steps(torch, lambda: trainer.train_step(state, batch), 3,
                    median_ms, f'training step ({label})')
    paths[label] = launches
  return paths


def k3_convolve_launches(t_local, frame, ir_size, delay):
  """K3 launches of one time-sharded fft_convolve's forward, counted from
  the code of parallel/time_shard.py: local_fft_convolve_same shifts its
  tail right ceil(tail / t_local) times and its head left
  ceil(delay / t_local) times. A frame past the shard splits into
  shard-sized sub-frames."""
  frame = min(frame, t_local)
  fft_size = int(2**np.ceil(np.log2(frame + ir_size - 1)))
  tail = (t_local // frame - 1) * frame + fft_size - delay - t_local
  return -(-tail // t_local) + -(-delay // t_local)


def sp_k3_launches(convolutions, fft_sizes, backward=True):
  """K3 launches of one time-sharded forward (and its backward): each
  convolution's (k3_convolve_launches) and, per FFT size, one left shift of
  a right halo for the target and one for the synthesized audio
  (local_stft_mag). In the backward every shift of a tensor that needs a
  gradient runs once more: the convolutions' (the IR, and the reverb's
  audio, need one) and the synthesized audio's halos."""
  conv = sum(k3_convolve_launches(*c) for c in convolutions)
  stft = len(fft_sizes)
  return 2 * conv + 3 * stft if backward else conv + 2 * stft


def solo_instrument_convolutions(t_local):
  """(t_local, frame, ir_size, delay) of solo_instrument's time-sharded
  convolutions: the reverb (one IR frame, no delay) and the filtered noise
  (65 bands: 128-tap IRs of 64-sample frames, delay 62)."""
  noise_ir = 2 * (N_NOISE - 1)
  return [(t_local, N_SAMPLES, REVERB_LENGTH, 0),
          (t_local, N_SAMPLES // N_FRAMES, noise_ir, (noise_ir - 1) // 2 - 1)]


def sp_step_gradients(torch, model, batch, noise, mesh):
  """(total_loss, {name: grad}) of one SP step's forward and backward."""
  from ddsp_torch.parallel import sp_forward_with_losses
  _, losses = sp_forward_with_losses(model, batch, mesh, halo_impl='pallas',
                                     noise=noise)
  names = [k for k, _ in model.named_parameters()]
  grads = torch.autograd.grad(losses['total_loss'],
                              [p for _, p in model.named_parameters()])
  return losses['total_loss'].item(), dict(zip(names, grads))


def phase_sp_train(torch, dev, dense_ms, profile, save_dir):
  """Sequence-parallel training of full-width solo_instrument on a (1 x 4)
  mesh whose shards share the card: the path of K3. The trained state is
  saved to save_dir (phase 6k evaluates it)."""
  from ddsp_torch.losses import SpectralLoss
  from ddsp_torch.parallel import (create_mesh, sp_forward_with_losses,
                                   time_shard)
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  print(f'[6b] SP-train solo_instrument on a {SP_MESH} mesh of one card '
        f"(bf16, batch {BATCH} x 4 s, halo_impl='pallas', {SP_WARMUP} + "
        f'{SP_STEPS} steps)', flush=True)
  mesh = create_mesh(*SP_MESH, devices=[dev] * (SP_MESH[0] * SP_MESH[1]))
  batch = training_batch()
  model = build_model('solo_instrument', seed=0)
  fft_sizes = model.losses[0].fft_sizes
  expected_k3 = sp_k3_launches(
      solo_instrument_convolutions(N_SAMPLES // SP_MESH[1]), fft_sizes)

  # The first step's loss against the dense step: same parameters, noise.
  on_dev = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
  noise = torch.rand((BATCH, N_SAMPLES), device=dev,
                     generator=torch.Generator(dev).manual_seed(31)) * 2 - 1
  with torch.no_grad():
    _, dense = model(on_dev, training=True, return_losses=True, noise=noise)
    outputs, sp = sp_forward_with_losses(model, on_dev, mesh,
                                         halo_impl='pallas', noise=noise)
    a, b = sp['total_loss'].item(), dense['total_loss'].item()
    print(f'  first step: SP total_loss {a:.5f}, dense {b:.5f}')
    check(abs(a - b) <= SP_DENSE_RTOL * abs(b),
          f'the SP loss within {SP_DENSE_RTOL} of the dense loss')
    audio = outputs['audio_synth']
    got = time_shard.time_sharded_spectral_loss(
        mesh, on_dev['audio'], audio, fft_sizes=fft_sizes, mag_weight=1.0,
        halo_impl='pallas').item()
    want = SpectralLoss(fft_sizes=fft_sizes, mag_weight=1.0)(
        on_dev['audio'], audio).item()
    print(f'  mag-only loss on the synthesized batch: sharded {got:.7f}, '
          f'dense float32 SpectralLoss {want:.7f}')
    check(abs(got - want) <= SP_MAG_LOSS_RTOL * abs(want),
          f'the sharded loss within {SP_MAG_LOSS_RTOL} of SpectralLoss')
  del outputs, audio

  trainer = Trainer(model, mesh=mesh, halo_impl='pallas', seed=0)
  state = trainer.init()
  for _ in range(SP_WARMUP):
    state, _ = trainer.train_step(state, batch)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  times, losses = [], []
  for _ in range(SP_STEPS):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, step = trainer.train_step(state, batch)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
    losses.append(step['total_loss'].item())
  launches = read_launches()
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  trainer.save(state, save_dir)
  print(f'  launches over {SP_STEPS} steps: {launches}; K3 counted from the '
        f'code: {expected_k3} per step')
  print(f'  total_loss per step: {[round(l, 3) for l in losses]}')
  check(all(np.isfinite(losses)), 'every SP loss is finite')
  first, last = np.mean(losses[:3]), np.mean(losses[-3:])
  print(f'  mean loss, first three steps {first:.4f}, last three {last:.4f}')
  check(last < first, 'the SP loss falls: last three below the first three')
  check(launches['K3'] == expected_k3 * SP_STEPS > 0,
        f'K3 launched {expected_k3} times per SP step')
  check(launches['K2f'] == launches['K2b'] == launches['K2b_w'] == SP_STEPS,
        'K2f, K2b and its weight-gradient pass each launched once per SP '
        'step')
  check(launches['K1f'] == launches['K1t'] == launches['K1p'] == 0,
        'the SP path launches no K1 (the shards synthesize in plain torch)')
  median_ms = float(np.median(times))
  print(f'  step ms: {[round(t, 2) for t in times]}')
  print(f'  median ms per SP training step: {median_ms:.3f} (dense step, '
        f'phase 6: {dense_ms:.3f}); audio samples/s trained: '
        f'{BATCH * N_SAMPLES / (median_ms / 1e3):.4e}; peak device memory '
        f'{peak_gib:.2f} GiB')
  if profile:
    profile_steps(torch, lambda: trainer.train_step(state, batch), 3,
                  median_ms, 'SP training step')

  # One B = 2 SP step on the card against the same SP step on the CPU
  # (plain K3 and K2), same parameters and noise.
  small = {k: torch.as_tensor(v[:2]) for k, v in batch.items()}
  noise = torch.rand((2, N_SAMPLES),
                     generator=torch.Generator().manual_seed(32)) * 2 - 1
  gpu_model = build_model('solo_instrument', seed=1)
  cpu_model = build_model('solo_instrument', seed=1, device='cpu')
  with torch.no_grad():  # an audible reverb, so its halos carry signal
    cpu_model.processor_group.reverb.ir.copy_(audible_ir(torch))
    gpu_model.processor_group.reverb.ir.copy_(audible_ir(torch))
  cpu_mesh = create_mesh(*SP_MESH, devices=['cpu'] * mesh.size)
  loss_gpu, grads_gpu = sp_step_gradients(
      torch, gpu_model, {k: v.to(dev) for k, v in small.items()},
      noise.to(dev), mesh)
  t0 = time.time()
  loss_cpu, grads_cpu = sp_step_gradients(torch, cpu_model, small, noise,
                                          cpu_mesh)
  print(f'  the CPU SP step took {time.time() - t0:.1f} s')
  for name, g in grads_gpu.items():
    check(torch.isfinite(g).all().item(), f'SP {name}.grad finite')
  # The decoder's gradient norm is held to the CPU's here. The reverb IR's
  # gradient of the full loss is conditioned by the logmag term (see
  # IR_NAME: STFT bins near 1e-6 carry it; the two devices' FFT rounding
  # alone moves it by 2.4e-2 on one dry signal, and a 1e-6 move of the
  # noise moves the card's by 0.3, an H100 measurement), so
  # check_ir_gradient holds it where it is well-conditioned.
  norm_gpu = global_norm(torch, grads_gpu, 'decoder.')
  norm_cpu = global_norm(torch, grads_cpu, 'decoder.')
  print(f'  one SP step, B = 2: total_loss GPU {loss_gpu:.5f} CPU '
        f'{loss_cpu:.5f}; decoder gradient norm GPU {norm_gpu:.5f} CPU '
        f'{norm_cpu:.5f}')
  check(abs(loss_gpu - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
        f'SP total_loss within {STEP_LOSS_RTOL} of the CPU port')
  check(abs(norm_gpu - norm_cpu) <= STEP_GRAD_NORM_RTOL * norm_cpu,
        f'SP decoder gradient norm within {STEP_GRAD_NORM_RTOL} of the CPU '
        'port')
  check_ir_gradient(torch, dev, 'B = 2 SP step', gpu_model, cpu_model,
                    small, noise, grads_gpu, grads_cpu, (mesh, cpu_mesh))
  return launches, expected_k3, mesh


# Phase 6k: long audio on one card. The long-audio example's target
# (examples/train_long_audio.py: a 220 Hz tone with a 5 Hz vibrato under a
# loudness arc, and a noise floor) at 16 kHz and 250 frames/s, B = 2,
# trained by parallel.make_sp_train_step on a (1 x 4) mesh of the card with
# solo_instrument's decoder and torch.optim.Adam(1e-3): 30 s is 480000
# samples and 7500 frames, 120000 samples and 1875 frames a shard.
LONG_LR = 1e-3
LONG_WARMUP, LONG_STEPS = 2, 8
# The same step on the CPU port, at a length the CPU takes in seconds (a
# shard must hold whole 64-sample frames and one 2048-sample STFT frame).
LONG_CPU_SECONDS = 2
# The first step's loss against the dense pipeline on the card
# (harmonic_synthesis + frequency_impulse_response + fft_convolve +
# SpectralLoss on the global tensors): the shards' own phase sums, which
# the logmag term's 1/|X| amplifies on quiet bins; the JAX package holds
# this pair at 2e-2 (tests/test_time_shard.py,
# test_sp_loss_matches_unsharded_pipeline).
LONG_DENSE_RTOL = 2e-2
# The witness of the float32 phase's rounding: the same dense pipeline
# with the harmonic phase kept in float64 through the plain synthesis
# (dense_synth_and_loss's phase64). The dense float32 phase reaches
# 2 pi 220 30 = 4.1e4 rad (half an ulp 2e-3 rad, 0.12 rad at the 60th
# harmonic); a shard's stays under 1.1e4 (4.9e-4 rad, 2.9e-2 at the 60th),
# to which sin(phase * h) adds the rounding of its float32 product (up to
# 6.6e5 rad: half an ulp 3.1e-2 rad). So the first sharded loss lies
# nearer the float64-phase loss than the dense float32 one does. Neither
# is held to it: the rounding's noise under the harmonics fills the quiet
# bins that the logmag term weighs, and moves the loss by 2e-2-4e-2 at
# 30 s (an H100 measurement).
# The decoder's gradient of the mag term alone, sharded against dense,
# relative L2 over all its parameters: the two audios ~1e-3 apart, L1
# signs flipping where two magnitudes meet (IR_MAG_STEP_RTOL's reasons).
LONG_MAG_GRAD_RTOL = IR_MAG_STEP_RTOL
# The card's first loss against the CPU port's at LONG_CPU_SECONDS from the
# same parameters and noise: STEP_LOSS_RTOL's reasons (bf16 GRU streams
# rounded at the same places, the kernels' sums in another order, the
# logmag term).
LONG_CPU_RTOL = STEP_LOSS_RTOL
# FIRFilter on a (1 x 4) mesh against the dense FIRFilter on the card: the
# same 256-point FFTs of the same 64-sample frames, overlap-added per shard
# and then across shards through K3, relative to the largest output: the
# sums' order only.
FIR_SP_RTOL = 1e-5


def long_audio_batch(seconds, batch=LONG_BATCH):
  """examples/train_long_audio.py's batch at `seconds`: 'audio' [B, n],
  'f0_hz', 'ld_scaled', 'f0_scaled' [B, frames, 1] (numpy, seed 0)."""
  hop = SR // 250
  n_frames = int(seconds * 250)
  n_samples = n_frames * hop
  rng = np.random.RandomState(0)
  t = np.arange(n_samples) / SR
  f0 = 220.0 * (1 + 0.005 * np.sin(2 * np.pi * 5 * t))
  phase = 2 * np.pi * np.cumsum(f0) / SR
  env = 0.5 + 0.4 * np.sin(2 * np.pi * t / seconds)
  target = (0.4 * env * np.sin(phase) +
            3e-3 * rng.randn(n_samples)).astype(np.float32)
  fi = np.arange(n_frames) * hop
  frames = lambda x: np.tile(x[fi].astype(np.float32)[None, :, None],
                             (batch, 1, 1))
  return {'audio': np.stack([target] * batch), 'f0_hz': frames(f0),
          'ld_scaled': frames(env),
          'f0_scaled': np.full((batch, n_frames, 1), 0.55, np.float32)}


def dense_synth_and_loss(torch, batch, controls, noise, fft_sizes,
                         logmag_weight=1.0, phase64=False):
  """sp_synth_and_loss's function on the global tensors, without shards.
  With phase64, the harmonic phase is summed and kept in float64 through
  the plain synthesis (K1's plain version), rounded to float32 as audio."""
  from ddsp_torch.kernels import harmonic as kh
  from ddsp_torch.losses import SpectralLoss
  from ddsp_torch.ops import core, fftconv, oscillator
  from ddsp_torch.ops.resample import resample
  n_samples = batch['audio'].shape[1]
  amps = core.exp_sigmoid(controls['amps'])
  harm_dist = core.exp_sigmoid(controls['harmonic_distribution'])
  if phase64:
    f0_env = resample(batch['f0_hz'], n_samples)
    phase0 = torch.cumsum((f0_env * (2 * np.pi) / SR).double(), dim=1)
    harm = kh.harmonic_synthesis_plain(phase0[..., 0], f0_env[..., 0],
                                       amps * harm_dist, SR).float()
  else:
    harm = oscillator.harmonic_synthesis(
        batch['f0_hz'], amps, harmonic_distribution=harm_dist,
        n_samples=n_samples, sample_rate=SR)
  ir = fftconv.frequency_impulse_response(
      core.exp_sigmoid(controls['noise_magnitudes'] - 5.0), window_size=0)
  audio = harm + fftconv.fft_convolve(noise, ir, padding='same')
  return SpectralLoss(fft_sizes=fft_sizes, mag_weight=1.0,
                      logmag_weight=logmag_weight)(batch['audio'], audio)


def long_audio_step(torch, d, seconds, noise):
  """(decoder, train_step, batch, noise, mesh, fft_sizes): make_sp_train_step
  around solo_instrument's decoder (seed 0) on a (1 x 4) mesh of d."""
  from ddsp_torch.parallel import create_mesh, make_sp_train_step
  from ddsp_torch.utils import build_model
  mesh = create_mesh(*SP_MESH, devices=[d] * (SP_MESH[0] * SP_MESH[1]))
  model = build_model('solo_instrument', seed=0, device=d)
  decoder, fft_sizes = model.decoder, tuple(model.losses[0].fft_sizes)
  train_step, shard_batch = make_sp_train_step(
      mesh, decoder, torch.optim.Adam(decoder.parameters(), lr=LONG_LR),
      n_samples=noise.shape[1], sample_rate=SR, fft_sizes=fft_sizes)
  batch, noise = shard_batch(long_audio_batch(seconds), noise)
  return decoder, train_step, batch, noise, mesh, fft_sizes


def phase_long_audio(torch, dev, profile):
  """[6k] long audio: make_sp_train_step at 30 s, B = 2, on a (1 x 4) mesh
  of the card, held against the dense pipeline and the CPU port."""
  from ddsp_torch.parallel import sp_synth_and_loss
  n_samples = LONG_SECONDS * SR
  print(f'[6k] long audio: make_sp_train_step, solo_instrument\'s decoder '
        f'(bf16), {LONG_SECONDS} s x B = {LONG_BATCH} ({n_samples} samples, '
        f'{LONG_SECONDS * 250} frames) on a {SP_MESH} mesh of one card, '
        f'Adam({LONG_LR}), {LONG_WARMUP} + {LONG_STEPS} steps', flush=True)
  noise = torch.rand((LONG_BATCH, n_samples),
                     generator=torch.Generator().manual_seed(41)) * 2 - 1
  decoder, train_step, batch, noise, mesh, fft_sizes = long_audio_step(
      torch, dev, LONG_SECONDS, noise)
  # The noise filter's convolution only: the step has no reverb.
  expected_k3 = sp_k3_launches(
      solo_instrument_convolutions(n_samples // mesh.n_time)[1:], fft_sizes)

  # Before any step: the loss and the mag term's gradient, dense and
  # sharded, from the same parameters and noise.
  params = list(decoder.parameters())
  with torch.no_grad():
    controls = decoder(batch)
    dense = dense_synth_and_loss(torch, batch, controls, noise,
                                 fft_sizes).item()
    phase64 = dense_synth_and_loss(torch, batch, controls, noise, fft_sizes,
                                   phase64=True).item()
  grads, mags = {}, {}
  for kind in ('dense', 'sharded'):
    controls = decoder(batch, training=True)
    if kind == 'dense':
      mag = dense_synth_and_loss(torch, batch, controls, noise, fft_sizes,
                                 logmag_weight=0.0)
    else:
      mag = sp_synth_and_loss(
          mesh, batch['audio'], batch['f0_hz'], controls['amps'],
          controls['harmonic_distribution'], controls['noise_magnitudes'],
          noise, n_samples=n_samples, sample_rate=SR, fft_sizes=fft_sizes,
          logmag_weight=0.0)
    grads[kind] = torch.cat([g.double().flatten() for g in
                             torch.autograd.grad(mag, params)])
    mags[kind] = mag.item()
  grad_rel = rel_l2(grads['sharded'], grads['dense'])
  print(f'  the mag term alone: sharded {mags["sharded"]:.6f}, dense '
        f'{mags["dense"]:.6f} '
        f'({abs(mags["sharded"] - mags["dense"]) / mags["dense"]:.3e} '
        f'apart); its decoder gradient, sharded against dense: relative L2 '
        f'{grad_rel:.3e} (|dense| {grads["dense"].norm():.4e})')
  check(torch.isfinite(grads['sharded']).all().item() and
        grad_rel <= LONG_MAG_GRAD_RTOL,
        f'the sharded mag-term gradient within {LONG_MAG_GRAD_RTOL} of the '
        'dense pipeline\'s')
  del grads

  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  times, losses = [], []
  for _ in range(LONG_WARMUP + LONG_STEPS):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    loss = train_step(batch, noise)
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
    losses.append(loss.item())
  launches = read_launches()
  peak_gib = torch.cuda.max_memory_allocated() / 2**30
  n_steps = LONG_WARMUP + LONG_STEPS
  apart = lambda a, b: abs(a - b) / abs(b)
  print(f'  first step: loss {losses[0]:.5f}, the dense pipeline {dense:.5f} '
        f'({apart(losses[0], dense):.3e} apart), with a float64 phase '
        f'{phase64:.5f} ({apart(losses[0], phase64):.3e} apart; the dense '
        f'float32 phase {apart(dense, phase64):.3e} from it)')
  check(apart(losses[0], dense) <= LONG_DENSE_RTOL,
        f'the first step\'s loss within {LONG_DENSE_RTOL} of the dense '
        'pipeline')
  check(apart(losses[0], phase64) < apart(dense, phase64),
        'the first step\'s loss nearer the float64-phase pipeline than the '
        'dense float32 pipeline is')
  print(f'  loss per step: {[round(l, 4) for l in losses]}')
  check(all(np.isfinite(losses)) and
        np.mean(losses[-3:]) < np.mean(losses[:3]),
        'the long-audio loss is finite and falls: the last three steps '
        'below the first three')
  print(f'  launches over {n_steps} steps: {launches}; K3 counted from the '
        f'code: {expected_k3} per step')
  check(launches['K2f'] == launches['K2b'] == launches['K2b_w'] == n_steps,
        'K2f, K2b and its weight-gradient pass each launched once per '
        'long-audio step')
  check(launches['K3'] == expected_k3 * n_steps > 0,
        f'K3 launched {expected_k3} times per long-audio step')
  check(launches['K1f'] == launches['K1t'] == launches['K1p'] == 0,
        'the long-audio step launches no K1 (the shards synthesize in plain '
        'torch)')
  median_ms = float(np.median(times[LONG_WARMUP:]))
  print(f'  step ms: {[round(t, 2) for t in times]}')
  print(f'  median ms per long-audio step: {median_ms:.3f}; audio samples/s '
        f'trained: {LONG_BATCH * n_samples / (median_ms / 1e3):.4e}; peak '
        f'device memory {peak_gib:.3f} GiB')
  if profile:
    profile_steps(torch, lambda: train_step(batch, noise), 3, median_ms,
                  'long-audio step')
  del batch, noise

  # The first step on the card against the CPU port at LONG_CPU_SECONDS.
  n_short = LONG_CPU_SECONDS * SR
  short_noise = torch.rand((LONG_BATCH, n_short),
                           generator=torch.Generator().manual_seed(42)) * 2 - 1
  first = {}
  for name, d in (('card', dev), ('cpu', torch.device('cpu'))):
    dec, step, b, nz, _, _ = long_audio_step(torch, d, LONG_CPU_SECONDS,
                                             short_noise)
    initial = {k: v.detach().cpu().clone()
               for k, v in dec.state_dict().items()}
    first[name] = (step(b, nz).item(), initial)
  (g_loss, g_state), (c_loss, c_state) = first['card'], first['cpu']
  check(all(torch.equal(g_state[k], v) for k, v in c_state.items()),
        'the card and the CPU port start from the same decoder parameters')
  print(f'  {LONG_CPU_SECONDS} s: first step loss card {g_loss:.5f}, CPU port '
        f'{c_loss:.5f} ({abs(g_loss - c_loss) / abs(c_loss):.3e} apart)')
  check(abs(g_loss - c_loss) <= LONG_CPU_RTOL * abs(c_loss),
        f'the first long-audio loss within {LONG_CPU_RTOL} of the CPU port')
  return launches, losses


def phase_sp_eval(torch, dev, work_dir, ckpt_dir, mesh):
  """[6k] evaluate_or_sample of phase 6b's SP checkpoint on its (1 x 4)
  mesh against the dense eval of the same checkpoint, batches and noise."""
  from ddsp_torch.data import ArrayDataProvider
  from ddsp_torch.eval import BasicEvaluator, evaluate_or_sample
  from ddsp_torch.losses import SpectralLoss
  from ddsp_torch.parallel import sp_model
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  print(f'[6k] SP eval and sample of phase 6b\'s checkpoint on its {SP_MESH} '
        f'mesh: {EVAL_BATCHES} batches of {EVAL_BATCH} x 4 s against the '
        'dense eval', flush=True)

  provider = ArrayDataProvider(training_batch(), sample_rate=SR,
                               frame_rate=250)
  noise = sp_eval_noise(torch, dev)
  runs = {}
  for name, m in (('sp', mesh), ('dense', None)):
    trainer = Trainer(build_model('solo_instrument', seed=1), mesh=m,
                      device=dev, halo_impl='pallas')
    fft_sizes = tuple(trainer.model.losses[0].fft_sizes)
    mag = SpectralLoss(fft_sizes=fft_sizes, mag_weight=1.0)
    kwargs = dict(restore_dir=ckpt_dir, batch_size=EVAL_BATCH, noise=noise)
    evaluate_or_sample(provider, trainer, os.path.join(work_dir, f'w_{name}'),
                       evaluators=[BasicEvaluator(SR, 250)], num_batches=1,
                       **kwargs)
    log, recorder = [], audio_recorder()
    owner, attr = (sp_model, 'sp_forward_with_losses') if m else (
        trainer.model, 'forward')
    original = timed_calls(torch, owner, attr, log)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
      scalars = evaluate_or_sample(
          provider, trainer, os.path.join(work_dir, f'eval_{name}'),
          evaluators=[BasicEvaluator(SR, 250), recorder],
          num_batches=EVAL_BATCHES, **kwargs)
    finally:
      setattr(owner, attr, original)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    with torch.no_grad():
      mags = [mag(torch.as_tensor(t, device=dev),
                  torch.as_tensor(a, device=dev)).item()
              for t, a in recorder.audio]
    runs[name] = {'scalars': scalars, 'launches': launches,
                  'loop_ms': 1e3 * seconds / EVAL_BATCHES,
                  'forward_ms': 1e3 * float(np.median(log)),
                  'mag': float(np.mean(mags)), 'trainer': trainer,
                  'audio': [a for _, a in recorder.audio]}
    print(f'  {name}: ms per eval batch {runs[name]["loop_ms"]:.3f} (the '
          f'loop), {runs[name]["forward_ms"]:.3f} (the forward, median); '
          f'launches {launches}; scalars {scalars}; mean mag term '
          f'{runs[name]["mag"]:.6f}', flush=True)
  sp, dense = runs['sp'], runs['dense']
  expected_k3 = sp_k3_launches(
      solo_instrument_convolutions(N_SAMPLES // mesh.n_time), fft_sizes,
      backward=False)
  check(set(sp['scalars']) == set(dense['scalars']) and all(
      np.isfinite(v) for v in sp['scalars'].values()),
        'the SP eval reports the dense eval\'s scalars, finite')
  a, b = sp['scalars']['losses/total_loss'], dense['scalars'][
      'losses/total_loss']
  check(abs(a - b) <= SP_DENSE_RTOL * abs(b),
        f'SP eval total_loss within {SP_DENSE_RTOL} of the dense eval\'s')
  mag_rel = abs(sp['mag'] - dense['mag']) / abs(dense['mag'])
  print(f'  total_loss SP {a:.5f}, dense {b:.5f} ({abs(a - b) / abs(b):.3e} '
        f'apart); the mag term of the audio the evaluators saw '
        f'{mag_rel:.3e} apart')
  check(mag_rel <= EVAL_MAG_LOSS_RTOL,
        f'SP eval mag term within {EVAL_MAG_LOSS_RTOL} of the dense eval\'s')
  check(sp['launches']['K2f'] == EVAL_BATCHES and
        sp['launches']['K3'] == expected_k3 * EVAL_BATCHES and
        all(sp['launches'][k] == 0
            for k in ('K1f', 'K1t', 'K1p', 'K2b', 'K2b_w')),
        f'SP eval: K2f once and K3 {expected_k3} times per batch (counted '
        'from the code), no K1 and no backward kernel')
  check(dense['launches']['K1f'] == dense['launches']['K2f'] ==
        EVAL_BATCHES and dense['launches']['K3'] == 0,
        'dense eval: K1f and K2f once per batch, no K3')

  names = {}
  for name in ('sp', 'dense'):
    sample_dir = os.path.join(work_dir, f'sample_{name}')
    evaluate_or_sample(provider, runs[name]['trainer'], sample_dir,
                       restore_dir=ckpt_dir, mode='sample',
                       batch_size=EVAL_BATCH, num_batches=EVAL_BATCHES,
                       noise=noise)
    names[name] = sorted(
        os.path.relpath(os.path.join(root, f), sample_dir)
        for root, _, files in os.walk(sample_dir) for f in files
        if not f.startswith('events.'))
  print(f'  sample: {len(names["sp"])} files, SP against dense '
        f'{"the same" if names["sp"] == names["dense"] else "apart"}')
  check(names['sp'] == names['dense'] and any(
      n.endswith('_synth.wav') for n in names['sp']),
        'SP sample writes the files the dense sample writes')
  results = {name: {k: runs[name][k] for k in ('scalars', 'audio', 'loop_ms')}
             for name in runs}
  results['sample_names'] = names['sp']
  return sp['launches'], results


def sp_eval_noise(torch, dev):
  """Phase 6k's eval noise, [EVAL_BATCH, N_SAMPLES], drawn on the CPU."""
  return (torch.rand((EVAL_BATCH, N_SAMPLES),
                     generator=torch.Generator().manual_seed(43)) * 2 -
          1).to(dev)


def audio_recorder():
  """An evaluator that keeps each batch's target and synthesized audio."""
  from ddsp_torch.eval import BaseEvaluator

  class AudioRecorder(BaseEvaluator):

    def __init__(self):
      super().__init__(SR, 250)
      self.audio = []

    def evaluate(self, batch, outputs, losses):
      self.audio.append((batch['audio'], outputs['audio_synth']))

  return AudioRecorder()


def phase_fir_sp(torch, dev):
  """[6k] a ProcessorGroup with FIRFilter on a (1 x 4) mesh of the card
  against the dense group, batch 16 x 4 s."""
  from ddsp_torch import proc
  from ddsp_torch.parallel import create_mesh, sp_model
  print(f'[6k] FIRFilter on a {SP_MESH} mesh of the card, {BATCH} x 4 s, '
        f'{N_NOISE} bands', flush=True)
  mesh = create_mesh(*SP_MESH, devices=[dev] * (SP_MESH[0] * SP_MESH[1]))
  gen = torch.Generator(dev).manual_seed(44)
  inputs = {'audio': 0.3 * torch.randn((BATCH, N_SAMPLES), generator=gen,
                                       device=dev),
            'magnitudes': torch.randn((BATCH, N_FRAMES, N_NOISE),
                                      generator=gen, device=dev)}
  fir = proc.FIRFilter(name='fir')
  pg = proc.ProcessorGroup(dag=[(fir, ['audio', 'magnitudes'])])
  expected_k3 = k3_convolve_launches(
      *solo_instrument_convolutions(N_SAMPLES // mesh.n_time)[1])
  with torch.no_grad():
    dense = pg(inputs, return_outputs_dict=True)['signal']
    reset_launches()
    out = sp_model.sp_run_dag(pg, inputs, mesh, halo_impl='pallas')
    torch.cuda.synchronize()
    launches = read_launches()
  err = ((out['out']['signal'] - dense).abs().max() /
         dense.abs().max()).item()
  print(f'  SP against dense: max |err| / max |dense| {err:.3e}; launches '
        f'{launches}')
  check(err <= FIR_SP_RTOL,
        f'FIRFilter\'s SP branch within {FIR_SP_RTOL} of the dense filter')
  check(launches['K3'] == expected_k3 > 0 and
        sum(launches.values()) == launches['K3'],
        f'FIRFilter\'s SP branch launched K3 {expected_k3} times, nothing '
        'else')
  return launches


# The paths whose launches the kernels line also gives per unit (phase
# 6k): {path: (unit, units in the path's count)}.
# Phase 6m: four ranks of torch.distributed on the one card. NCCL refuses
# two ranks on one card ("Duplicate GPU detected", NCCL 2.28.9 with torch
# 2.11 on the H100 machine), so the ranks name gloo, which stages CUDA
# tensors through the host; K3's remote copy moves its blocks itself.
RANKS = 4
RANKS_BACKEND = 'gloo'
RANKS_DENSE_MESH = (4, 1)
RANKS_STEPS = 3
RANKS_SHIFTS_TIMED = 40
RANKS_TIMEOUT_S = 600
RANKS_BLOCKS = ('noise carry [2, 120000]', 'STFT halo [2, 2047] of [2, 120000]')
# (b) the (4 x 1) step against the one-process step on the same 16 rows,
# parameters and noise: the same per-row work and the same noise (each
# rank draws the global batch's and keeps its rows), but cuBLAS and cuFFT
# pick their kernels by the row count (4 rows a rank against 16), so
# float32 products round differently, bf16 streams round that to 3 digits
# where a value straddles a step, and the sums of the loss and the
# gradient run over ranks in another order. Held at the first step: the
# loss, and the decoder's gradient norm at STEP_GRAD_NORM_RTOL (the logmag
# term's 1/|X| carries such rounding into it through the synthesis; on an
# H100 8.9e-3 apart, the losses 1.2e-7). The reverb IR's gradient, which
# that term conditions most (on one dry signal the two devices' FFT
# rounding alone moves it by 1.6e-2, IR_NAME's note), and with it the
# global norm, are printed only: the same run read the first step's
# global norm 355 on the ranks and 566 in one process. The later steps
# follow Adam updates that are near lr * sign(g) for the IR's tiny
# entries, whose signs that rounding flips: their losses are held looser
# (the same run: 2.6e-3 and 1.6e-2 apart).
RANKS_LOSS_RTOL = 1e-3
RANKS_GRAD_NORM_RTOL = STEP_GRAD_NORM_RTOL
RANKS_LATER_LOSS_RTOL = 5e-2
# (c) the (1 x 4) long-audio step against phase 6k's one-process step: the
# same shards, decoder rows and noise, the same arithmetic; only the sums
# of the loss and of the gradient run over ranks in another order. The
# first loss, and the next two after Adam steps of those gradients (an
# H100: equal, then 1.1e-6 and 1.3e-4 apart).
RANKS_LONG_FIRST_RTOL = 1e-4
RANKS_LONG_RTOL = 1e-3


def ranks_blocks(torch, dev, seed):
  """The long-audio step's K3 blocks on this rank: the noise filter's tail
  carry [2, 120000] and the STFT halo, a [2, 2047] view of a [2, 120000]
  shard (the leaf, the block)."""
  gen = torch.Generator(dev).manual_seed(seed)
  t_local = LONG_FRAMES * (SR // 250) // SP_MESH[1]
  carry = torch.randn((LONG_BATCH, t_local), generator=gen, device=dev)
  audio = torch.randn((LONG_BATCH, t_local), generator=gen, device=dev)
  return list(zip(RANKS_BLOCKS, (carry, audio[:, :2047])))


# (a) also times the remote copy alone. The loopback: one process passes
# its own slot as its neighbour on both sides, so the kernels push, stamp,
# wait and copy out on one context with nothing to wait for: the design's
# own device time against its bound. Loopback times are CUDA events around
# windows of LOOPBACK_SHIFTS back-to-back shifts: as the host issues them
# (a call's time), and 'queued': behind a sleeping kernel of
# QUEUE_SLEEP_CYCLES, so that the window is enqueued whole before the card
# starts it and the events read the card's own time. The four ranks' are
# host clocks around windows of RANKS_SHIFTS_TIMED shifts ending in one
# wait (check), two windows a route in turns with the plain version.
LOOPBACK_WINDOWS = 9
LOOPBACK_SHIFTS = 50
QUEUE_SLEEP_CYCLES = 50_000_000  # ~25 ms at the H100's 1.98 GHz
RANKS_ROUNDS = 2


def windows_ms(routes, windows, shifts, begin, end):
  """{route: [ms per shift of each window]}: `windows` windows of `shifts`
  calls of each route, the order reversed every other window; begin()
  starts a window and end(start) returns its ms."""
  out = {route: [] for route in routes}
  order = list(routes)
  for w in range(windows):
    for route in (order if w % 2 == 0 else order[::-1]):
      fn = routes[route]
      start = begin()
      for _ in range(shifts):
        fn()
      out[route].append(end(start) / shifts)
  return out


def spread(values):
  """(median, lowest, highest) of a route's windows."""
  ordered = sorted(values)
  return (float(np.median(ordered)), ordered[0], ordered[-1])


def loopback_blocks(torch, dev):
  """The (a) blocks with zeros and negative zeros among their values."""
  out = []
  for name, block in ranks_blocks(torch, dev, 29):
    block[:, ::7] = 0.0
    block[:, 3::7] = -0.0
    out.append((name, block))
  return out


def ranks_loopback(torch, dev):
  """(a), in one process before the ranks spawn: each route's loopback at
  the carry and the halo, bit for bit against the block, then ms per
  shift by windows between CUDA events."""
  from ddsp_torch.kernels import halo as kk
  out = {'equal': {}, 'ms': {}}

  def begin():
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event

  def begin_queued():
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)  # pylint: disable=protected-access
    return begin()

  def end(start):
    stop = torch.cuda.Event(enable_timing=True)
    stop.record()
    kk.check()
    stop.synchronize()
    return start.elapsed_time(stop)

  for name, block in loopback_blocks(torch, dev):
    routes = {'new': lambda b=block: kk.loopback_shift(b)}
    want = block.contiguous().view(torch.int32)
    for route, fn in routes.items():
      got = fn()
      kk.check()
      torch.cuda.synchronize()
      out['equal'][(name, route)] = torch.equal(got.view(torch.int32), want)
    out['ms'][name] = windows_ms(routes, LOOPBACK_WINDOWS, LOOPBACK_SHIFTS,
                                 begin, end)
    queued = windows_ms({'new': routes['new']}, LOOPBACK_WINDOWS,
                        LOOPBACK_SHIFTS, begin_queued, end)
    out['ms'][name]['new queued'] = queued['new']
  kk.release_remote_slots()
  return out


def ranks_shifts(torch, dev, rank):
  """(a) K3's remote copy against its plain version on a (1 x 4) mesh of
  the ranks: values and adjoints bit for bit, both directions, launches;
  then ms per shift of the kernels and the plain version by windows, host
  clock (a window's shifts are enqueued without waiting and end in one
  wait)."""
  from ddsp_torch.kernels import halo as kk
  from ddsp_torch.parallel import create_mesh, distributed, halo
  mesh = create_mesh(*SP_MESH, devices=[dev])
  out = {'cases': [], 'ms': {}, 'bytes': {}}

  def begin():
    kk.check()
    torch.cuda.synchronize()
    distributed.barrier()
    return time.perf_counter()

  def end(start):
    kk.check()
    torch.cuda.synchronize()
    return (time.perf_counter() - start) * 1e3

  for name, block in ranks_blocks(torch, dev, 30 + rank):
    leaf = block.clone().requires_grad_()
    for direction in (+1, -1):
      kk.reset_launches()
      (got,) = halo.neighbor_shift([leaf], mesh, direction, impl='pallas')
      edge = kk._edge(mesh, direction)  # pylint: disable=protected-access
      want = kk.remote_shift_plain(block, edge.to, edge.frm)
      cot = torch.randn(got.shape, device=dev)
      (adj,) = torch.autograd.grad(got, leaf, cot)
      back = kk._edge(mesh, -direction)  # pylint: disable=protected-access
      want_adj = kk.remote_shift_plain(cot, back.to, back.frm)
      kk.check()
      torch.cuda.synchronize()
      out['cases'].append(dict(
          name=f'{name} {direction:+d}',
          err=max((got - want).abs().max().item(),
                  (adj - want_adj).abs().max().item()),
          equal=torch.equal(got, want) and torch.equal(adj, want_adj),
          launches=dict(kk.launches)))
    edge = kk._edge(mesh, +1)  # pylint: disable=protected-access
    routes = {'new': lambda b=block: halo.neighbor_shift([b], mesh, +1)}
    routes['plain'] = lambda b=block: kk.remote_shift_plain(b, edge.to,
                                                            edge.frm)
    for fn in routes.values():
      for _ in range(3):
        fn()
    out['ms'][name] = windows_ms(routes, RANKS_ROUNDS, RANKS_SHIFTS_TIMED,
                                 begin, end)
    out['bytes'][name] = block.numel() * block.element_size()
  return out


# The fault drill, last in phase 6m: four ranks of their own a case, with
# REMOTE_TIMEOUT_S cut to DRILL_TIMEOUT_S. Every rank makes one shift (the
# slot is made), then in 'extra_call' rank 1 makes one shift the others do
# not, and in 'never_sends' rank DRILL_MUTE's slot is given its own address
# for its neighbours' (its blocks and its notices of consumption never
# leave it); then every rank makes the DRILL_TAIL shifts and waits in
# check. Each rank must raise naming a call within DRILL_TIMEOUT_S +
# DRILL_SLACK_S of the start, and every process must end by itself.
DRILL_CASES = ('extra_call', 'never_sends')
DRILL_TIMEOUT_S = 5.0
DRILL_SLACK_S = 5.0
DRILL_JOIN_S = 180
DRILL_MUTE = RANKS - 1
DRILL_TAIL = (+1, -1) * 4


def drill_worker(rank, work_dir, case):
  """One rank of a fault drill; its outcome to work_dir, then the process
  ends at once (its stream may wait for ever; no collective teardown)."""
  import traceback  # pylint: disable=g-import-not-at-top
  import torch  # pylint: disable=g-import-not-at-top
  from ddsp_torch.kernels import halo as kk
  from ddsp_torch.parallel import create_mesh, distributed, halo
  result = {'rank': rank, 'error': None, 'raised': None}
  try:
    dev = distributed.init(
        device=torch.device('cuda', 0), backend=RANKS_BACKEND,
        init_method='file://' + os.path.join(work_dir, f'init_{case}'),
        rank=rank, world_size=RANKS)
    kk.REMOTE_TIMEOUT_S = DRILL_TIMEOUT_S
    mesh = create_mesh(*SP_MESH, devices=[dev])
    block = torch.randn((LONG_BATCH, 2047), device=dev)
    halo.neighbor_shift([block], mesh, +1)
    kk.check()
    distributed.barrier()
    t0 = time.monotonic()
    try:
      if case == 'extra_call' and rank == 1:
        halo.neighbor_shift([block], mesh, +1)
      if case == 'never_sends' and rank == DRILL_MUTE:
        (slot,) = kk._SLOTS.values()  # pylint: disable=protected-access
        slot.peers = {peer: slot.own for peer in slot.peers}
      for direction in DRILL_TAIL:
        halo.neighbor_shift([block], mesh, direction)
      kk.check()
    except RuntimeError as e:
      result['raised'] = str(e)
    result['seconds'] = time.monotonic() - t0
  except BaseException:  # pylint: disable=broad-except
    result['error'] = traceback.format_exc()
  with open(os.path.join(work_dir, f'{case}{rank}.json'), 'w') as f:
    json.dump(result, f)
  sys.stdout.flush()
  sys.stderr.flush()
  os._exit(0)  # pylint: disable=protected-access


def ranks_drill(torch):
  """The fault drill's cases, each in RANKS processes of its own: every
  rank raises within its bound naming a call, and every process ends."""
  import torch.multiprocessing as mp  # pylint: disable=g-import-not-at-top
  del torch
  out = {}
  for case in DRILL_CASES:
    with tempfile.TemporaryDirectory() as work_dir:
      t0 = time.time()
      ctx = mp.start_processes(drill_worker, args=(work_dir, case),
                               nprocs=RANKS, join=False, start_method='spawn')
      ended = False
      while time.time() - t0 < DRILL_JOIN_S:
        if all(not p.is_alive() for p in ctx.processes):
          ended = True
          break
        time.sleep(0.5)
      for p in ctx.processes:
        if p.is_alive():
          p.kill()
      check(ended, f'drill {case!r}: every rank\'s process ended by itself '
            f'within {DRILL_JOIN_S} s')
      results = []
      for r in range(RANKS):
        path = os.path.join(work_dir, f'{case}{r}.json')
        check(os.path.exists(path), f'drill {case!r}: rank {r} reported')
        with open(path) as f:
          results.append(json.load(f))
    for result in results:
      r = result['rank']
      check(result['error'] is None,
            f'drill {case!r}: rank {r} ran without another error'
            + (f' ({result["error"]})' if result['error'] else ''))
      print(f'  drill {case!r} rank {r}: raised after '
            f'{result["seconds"]:.2f} s: {result["raised"]}', flush=True)
      check(result['raised'] is not None and
            f' of the ({SP_MESH[0]} x {SP_MESH[1]}) mesh' in result['raised']
            and 'call ' in result['raised'],
            f'drill {case!r}: rank {r} raised, naming the call')
      check(result['seconds'] <= DRILL_TIMEOUT_S + DRILL_SLACK_S,
            f'drill {case!r}: rank {r} raised within '
            f'{DRILL_TIMEOUT_S + DRILL_SLACK_S} s')
    out[case] = results
  return out


def recording_gradients(torch, trainer, norms):
  """trainer.apply_gradients, appending each step's reduced (unclipped)
  gradient norms to `norms`: (the decoder's, the reverb IR's, the global
  one)."""
  apply = trainer.apply_gradients

  def recording(state, names, params, grads):
    by_name = dict(zip(names, grads))
    decoder = global_norm(torch, by_name, 'decoder.')
    ir = (by_name[IR_NAME].double().norm().item() if IR_NAME in by_name
          else float('nan'))  # the vst preset's reverb has no 'ir
    norm = apply(state, names, params, grads)
    norms.append((decoder, ir, norm.item()))
    return norm

  trainer.apply_gradients = recording


def ranks_dense(torch, dev, work_dir, rank):
  """(b) the dense Trainer step on the (4 x 1) mesh of the ranks, each on
  its 4 rows of phase 6's 16: losses, gradient norms, launches, ms per
  step; the parameters go to work_dir."""
  from ddsp_torch.parallel import create_mesh, distributed
  from ddsp_torch.parallel import mesh as mesh_lib
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  mesh = create_mesh(*RANKS_DENSE_MESH, devices=[dev])
  trainer = Trainer(build_model('solo_instrument', seed=0, device=dev),
                    mesh=mesh, seed=0)
  norms, losses, times = [], [], []
  recording_gradients(torch, trainer, norms)
  batch = trainer.to_device(mesh_lib.shard_batch(mesh, training_batch()))
  state = trainer.init()
  distributed.barrier()
  reset_launches()
  for _ in range(RANKS_STEPS):
    t0 = time.perf_counter()
    state, step_losses = trainer.train_step(state, batch)
    losses.append(step_losses['total_loss'].item())
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
  launches = read_launches()
  torch.save({k: p.detach().cpu() for k, p in state.params.items()},
             os.path.join(work_dir, f'params{rank}.pt'))
  return dict(losses=losses, norms=norms, ms=times, launches=launches,
              rows=batch['audio'].shape[0])


def ranks_long(torch, dev):
  """(c) make_sp_train_step at 30 s x B = 2 on a (1 x 4) mesh of the
  ranks: losses, launches, ms per step."""
  from ddsp_torch.parallel import create_mesh, distributed, make_sp_train_step
  from ddsp_torch.utils import build_model
  n_samples = LONG_SECONDS * SR
  noise = torch.rand((LONG_BATCH, n_samples),
                     generator=torch.Generator().manual_seed(41)) * 2 - 1
  mesh = create_mesh(*SP_MESH, devices=[dev])
  model = build_model('solo_instrument', seed=0, device=dev)
  decoder, fft_sizes = model.decoder, tuple(model.losses[0].fft_sizes)
  train_step, shard_batch = make_sp_train_step(
      mesh, decoder, torch.optim.Adam(decoder.parameters(), lr=LONG_LR),
      n_samples=n_samples, sample_rate=SR, fft_sizes=fft_sizes)
  batch, noise = shard_batch(long_audio_batch(LONG_SECONDS), noise)
  distributed.barrier()
  reset_launches()
  losses, times = [], []
  for _ in range(RANKS_STEPS):
    t0 = time.perf_counter()
    losses.append(train_step(batch, noise).item())
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
  launches = read_rank_launches()
  return dict(losses=losses, ms=times, launches=launches,
              samples=batch['audio'].shape[1], fft_sizes=fft_sizes)


# (d)-(h): evaluation and sampling across ranks, and the sharded forward's
# nodes and losses that gather across ranks. (d) evaluates phase 6b's
# checkpoint on a (1 x 4) mesh of the ranks and (e) on a (4 x 1) one, both
# against phase 6k's one-process evals of it (the same batches, noise and
# evaluator); 'sample' on one batch.
RANKS_EVAL_MESHES = {'sp': SP_MESH, 'dense': RANKS_DENSE_MESH,
                     'straddle': STRADDLE_MESH}
RANKS_SAMPLE_BATCHES = 1
# (d) against phase 6k's one-process SP eval: the same shards, decoder rows
# and noise, the same arithmetic; only the loss's sums run over ranks in
# another order, and the gathered audio is the shards' own.
RANKS_SP_EVAL_RTOL = 1e-4
RANKS_SP_EVAL_AUDIO_ATOL = 1e-5
# (e) against phase 6k's one-process dense eval: each rank runs the network
# on one row, not four, so cuBLAS may pick other kernels and a bf16 stream
# value may round to the next step (2^-8 of itself) where the float32 sum
# straddles one; (b)'s losses read 1.2e-7 apart under the same rule. The
# audio: a harmonic amplitude moved by 2^-8 moves a sample of a signal
# whose peak is about 1 by 4e-3 at most.
RANKS_DENSE_EVAL_RTOL = RANKS_LOSS_RTOL
RANKS_DENSE_EVAL_AUDIO_ATOL = 1e-2
# (f) the vst preset at full width on a (1 x 4) mesh of the ranks. At the
# preset's own 4 s its clip is 64320 samples (201 hops of 320, one of them
# for centered framing), which no mesh with 2 or 4 time shards takes:
# 16080 samples a shard is not a whole number of the FilteredNoise's
# 320-sample frames, and the one-process sharded forward refuses it as
# well (parallel/time_shard.py local_fft_convolve_same, as the JAX
# package's does). 3.9 s gives 196 hops, 49 a shard, and the Crop's 62400
# samples split into 15600 a shard. (f), (g): every rank runs the network
# on the whole batch, as one process does, so the forward is the same
# arithmetic: the first loss at RANKS_LONG_FIRST_RTOL, and the Crop's
# output, a gather and a slice of the same signals, at
# RANKS_SP_EVAL_AUDIO_ATOL. The backward is not: each rank runs the
# decoder's backward (K2b with bf16 streams) on its own shard's cotangent
# and the ranks' parameter gradients are summed, where one process runs it
# once on the shards' summed cotangent; the logmag term's 1/|X| on quiet
# bins makes the shards' terms cancel, so the rounding shows in the sum
# (a float32 rehearsal of (g) on the CPU at 16384 samples: 7.4e-4 apart).
# The decoder's gradient norm is held at (b)'s RANKS_GRAD_NORM_RTOL. (h):
# each rank runs the network on two rows, not four: (b)'s tolerances.
RANKS_VST_SECONDS = 3.9
RANKS_VST_BATCH = 4
RANKS_VST_STEPS = 3
RANKS_STEP_BATCH = 4
RANKS_ROWS_MESH = (4, 2)
RANKS_ROWS = 2
# (i), (j): STRADDLE_MESH over the four ranks. (i) make_sp_train_step at 30
# s on STRADDLE_BATCH rows (the example's tone, each row scaled by its
# STRADDLE_ROW_SCALES, so that a row put in another's place shows), 3
# steps, against one process's STRADDLE_MESH on the card; (j) phase 6b's
# checkpoint evaluated on it against one process's eval on that mesh. Each
# rank runs the network on the rows its run touches (one or two), not
# three, so cuBLAS may pick other kernels by the row count: (b)'s
# tolerances for the first loss and the decoder's gradient norm, and (e)'s
# for the eval (the same reasons).
STRADDLE_ROW_SCALES = (1.0, 0.8, 0.6)
STRADDLE_EVAL_BATCHES = 2
RANKS_EVAL_BATCH = {'sp': EVAL_BATCH, 'dense': EVAL_BATCH,
                    'straddle': STRADDLE_BATCH}


def files_under(root):
  """The files under root, relative to it, without TensorBoard's."""
  return sorted(os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if not f.startswith('events.'))


def first_examples(names, n):
  """The names of sample files of examples 0 .. n - 1, and the others that
  are not per example."""
  keep = []
  for name in names:
    head = os.path.basename(name).split('_')[0]
    if not head.isdigit() or int(head) < n:
      keep.append(name)
  return keep


def ranks_eval(torch, dev, rank, work_dir, ckpt_dir, kind, mode, batches):
  """(d), (e), (j): evaluate_or_sample of phase 6b's checkpoint on a mesh
  of the ranks (RANKS_EVAL_MESHES[kind]), phase 6k's batches, noise and
  evaluator, after one untimed batch in 'eval'; each rank writes into its
  own directory. The scalars, the audio rank 0's evaluators saw, the
  launches, ms per batch (the loop; the forward's and the outputs'
  gather's medians) and the files written."""
  from ddsp_torch.data import ArrayDataProvider
  from ddsp_torch.eval import BasicEvaluator, eval_util, evaluate_or_sample
  from ddsp_torch.parallel import create_mesh, distributed, sp_model
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  n_data, n_time = RANKS_EVAL_MESHES[kind]
  mesh = create_mesh(n_data, n_time, devices=[dev] * (n_data * n_time //
                                                       RANKS))
  trainer = Trainer(build_model('solo_instrument', seed=1), mesh=mesh,
                    device=dev, halo_impl='pallas')
  recorder = audio_recorder()
  save_dir = os.path.join(work_dir, f'{kind}_{mode}', f'rank{rank}')
  provider = ArrayDataProvider(training_batch(), sample_rate=SR,
                               frame_rate=250)
  batch = RANKS_EVAL_BATCH[kind]
  kwargs = dict(restore_dir=ckpt_dir, batch_size=batch,
                noise=sp_eval_noise(torch, dev)[:batch])
  if mode == 'eval':  # first calls (imports, FFT plans) out of the timing
    evaluate_or_sample(provider, trainer, save_dir + '_warm',
                       evaluators=[BasicEvaluator(SR, 250)], num_batches=1,
                       **kwargs)
  forward, gather = [], []
  timed = [(sp_model, 'sp_forward_with_losses', forward) if n_time > 1
           else (trainer.model, 'forward', forward),
           (eval_util, 'gather_outputs', gather)]
  originals = [(owner, attr, timed_calls(torch, owner, attr, log))
               for owner, attr, log in timed]
  distributed.barrier()
  reset_launches()
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  try:
    scalars = evaluate_or_sample(
        provider, trainer, save_dir, mode=mode,
        evaluators=[BasicEvaluator(SR, 250), recorder], num_batches=batches,
        **kwargs)
  finally:
    for owner, attr, fn in originals:
      setattr(owner, attr, fn)
  torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  return dict(scalars=scalars, audio=[a for _, a in recorder.audio],
              launches=read_rank_launches(), ms=1e3 * seconds / batches,
              forward_ms=1e3 * float(np.median(forward)),
              gather_ms=1e3 * float(np.median(gather)),
              files=files_under(save_dir) if os.path.isdir(save_dir) else [])


def vst_batch(batch=RANKS_VST_BATCH, seed=3):
  """Harmonic tones with a vibrato plus noise at RANKS_VST_SECONDS for the
  vst preset, made with numpy from a seed: 'audio' [B, n], and 'f0_hz' and
  'f0_confidence' at its 50 centered frames a second."""
  n = int(RANKS_VST_SECONDS * SR)
  frames = n // VST_HOP + 1
  rng = np.random.RandomState(seed)
  t = np.arange(frames) * VST_HOP / SR
  f0 = 110.0 * 2.0**(2.0 * rng.rand(batch, 1) + 0.1 * np.sin(
      2 * np.pi * (0.5 + rng.rand(batch, 1)) * t[None]))
  phase = 2 * np.pi * np.cumsum(np.repeat(f0, VST_HOP, axis=1)[:, :n],
                                axis=1) / SR
  audio = sum(0.25 / h * np.sin(h * phase) for h in range(1, 9))
  audio = audio + 0.01 * rng.randn(batch, n)
  return {'audio': audio.astype(np.float32), 'f0_hz': f0.astype(np.float32),
          'f0_confidence': np.ones_like(f0, np.float32)}


def step_noise(torch, dev, rows, n_samples, seed):
  """The noise processors' draw for a step, made on the CPU."""
  return (torch.rand((rows, n_samples),
                     generator=torch.Generator().manual_seed(seed)) * 2 -
          1).to(dev)


def vst_convolutions(t_local, n_samples):
  """(t_local, frame, ir_size, delay) of the vst preset's time-sharded
  convolutions: the FilteredNoiseReverb (one IR frame of 24000 taps, no
  delay) and the filtered noise (65 bands: 128-tap IRs of 320-sample
  frames, delay 62)."""
  noise_ir = 2 * (N_NOISE - 1)
  return [(t_local, n_samples, 24000, 0),
          (t_local, VST_HOP, noise_ir, (noise_ir - 1) // 2 - 1)]


def ranks_case_model(torch, dev, case):
  """The model of (f), (g) or (h), from its seed: the vst preset at full
  width and RANKS_VST_SECONDS, solo_instrument with an L2 SpectralLoss of
  the same sizes and weights, or solo_instrument."""
  from ddsp_torch.losses import SpectralLoss
  from ddsp_torch.utils import build_model
  if case == 'vst':
    return build_model('vst', seed=0, device=dev, seconds=RANKS_VST_SECONDS,
                       **VST_KWARGS)
  model = build_model('solo_instrument', seed=0, device=dev)
  if case == 'l2':
    loss = model.losses[0]
    model.losses[0] = SpectralLoss(
        fft_sizes=tuple(loss.fft_sizes), loss_type='L2',
        mag_weight=loss.mag_weight, logmag_weight=loss.logmag_weight)
  return model


RANKS_CASES = {  # case: (mesh, global batch, batch maker, steps on ranks)
    'vst': (SP_MESH, RANKS_VST_BATCH, vst_batch, RANKS_VST_STEPS),
    'l2': (SP_MESH, RANKS_STEP_BATCH, training_batch, 1),
    'rows': (RANKS_ROWS_MESH, RANKS_STEP_BATCH, training_batch, 1)}


def ranks_case(torch, dev, case, mesh, steps):
  """(f), (g), (h) on `mesh` (of the ranks, or all its shards in this
  process): for the vst preset first one forward without gradients (the
  Crop's signal, this process's samples), then Trainer steps with one noise
  draw: losses, reduced gradient norms, launches (K3r the remote copy) and
  ms per step."""
  from ddsp_torch.parallel import distributed, sp_forward_with_losses
  from ddsp_torch.parallel import mesh as mesh_lib
  from ddsp_torch.train import Trainer
  _, batch_size, make_batch, _ = RANKS_CASES[case]
  model = ranks_case_model(torch, dev, case)
  n_samples = model.processor_group.harmonic.n_samples
  trainer = Trainer(model, mesh=mesh, halo_impl='pallas', seed=0)
  rows = mesh_lib.local_rows(mesh, batch_size)
  batch = trainer.to_device(mesh_lib.shard_batch(mesh, make_batch(
      batch_size)))
  noise = step_noise(torch, dev, batch_size, n_samples, 47)[rows]
  out = {}
  if case == 'vst':
    with torch.no_grad():
      outputs, _ = sp_forward_with_losses(model, batch, mesh,
                                          halo_impl='pallas', training=False,
                                          noise=noise)
    out['crop'] = outputs['crop']['signal'].cpu()
    del outputs
  norms, losses, times = [], [], []
  recording_gradients(torch, trainer, norms)
  state = trainer.init()
  if mesh.ranks:
    distributed.barrier()
  reset_launches()
  for _ in range(steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, step_losses = trainer.train_step(state, batch, noise=noise)
    losses.append(step_losses['total_loss'].item())
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
  out.update(losses=losses, norms=norms, ms=times,
             launches=read_rank_launches(),
             rows=int(batch['audio'].shape[0]),
             samples=int(batch['audio'].shape[1]), n_samples=n_samples,
             fft_sizes=tuple(model.losses[0].fft_sizes))
  return out


def straddle_long_batch():
  """(i)'s batch: the example's 30 s tone on STRADDLE_BATCH rows, each
  row's audio and loudness scaled by its STRADDLE_ROW_SCALES."""
  batch = long_audio_batch(LONG_SECONDS, STRADDLE_BATCH)
  scales = np.asarray(STRADDLE_ROW_SCALES, np.float32)
  batch['audio'] = batch['audio'] * scales[:, None]
  batch['ld_scaled'] = batch['ld_scaled'] * scales[:, None, None]
  return batch


def straddle_long(torch, dev, mesh, steps):
  """(i) make_sp_train_step around solo_instrument's decoder (seed 0) on
  straddle_long_batch() on `mesh` (of the ranks, or all its shards in this
  process): losses, the decoder's reduced gradient norm at the first step,
  ms per step, launches, peak memory and the decoder's parameters after."""
  from ddsp_torch.parallel import distributed, make_sp_train_step
  from ddsp_torch.utils import build_model
  n_samples = LONG_SECONDS * SR
  noise = torch.rand((STRADDLE_BATCH, n_samples),
                     generator=torch.Generator().manual_seed(53)) * 2 - 1
  model = build_model('solo_instrument', seed=0, device=dev)
  decoder, fft_sizes = model.decoder, tuple(model.losses[0].fft_sizes)
  train_step, shard_batch = make_sp_train_step(
      mesh, decoder, torch.optim.Adam(decoder.parameters(), lr=LONG_LR),
      n_samples=n_samples, sample_rate=SR, fft_sizes=fft_sizes)
  batch, noise = shard_batch(straddle_long_batch(), noise)
  if mesh.ranks:
    distributed.barrier()
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  reset_launches()
  losses, times, norm = [], [], None
  for _ in range(steps):
    t0 = time.perf_counter()
    losses.append(train_step(batch, noise).item())
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
    if norm is None:
      norm = global_norm(torch, {k: p.grad for k, p in
                                 decoder.named_parameters()})
  return dict(losses=losses, norm=norm, ms=times,
              launches=read_rank_launches(),
              peak_gib=torch.cuda.max_memory_allocated() / 2**30,
              rows=int(batch['audio'].shape[0]),
              samples=int(batch['audio'].shape[1]), fft_sizes=fft_sizes,
              params={k: p.detach().cpu()
                      for k, p in decoder.named_parameters()})


def straddle_references(torch, dev, ckpt_dir):
  """(i), (j) in this process: two steps of (i) (the first held, the
  second timed warm) and the eval of (j) on STRADDLE_MESH with all its
  shards on the card."""
  from ddsp_torch.data import ArrayDataProvider
  from ddsp_torch.eval import BasicEvaluator, evaluate_or_sample
  from ddsp_torch.parallel import create_mesh
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  n_data, n_time = STRADDLE_MESH
  mesh = lambda: create_mesh(n_data, n_time, devices=[dev] * (n_data *
                                                              n_time))
  out = {'long': straddle_long(torch, dev, mesh(), 2)}
  trainer = Trainer(build_model('solo_instrument', seed=1), mesh=mesh(),
                    device=dev, halo_impl='pallas')
  recorder = audio_recorder()
  with tempfile.TemporaryDirectory() as save_dir:
    scalars = evaluate_or_sample(
        ArrayDataProvider(training_batch(), sample_rate=SR, frame_rate=250),
        trainer, save_dir, restore_dir=ckpt_dir, batch_size=STRADDLE_BATCH,
        noise=sp_eval_noise(torch, dev)[:STRADDLE_BATCH],
        evaluators=[BasicEvaluator(SR, 250), recorder],
        num_batches=STRADDLE_EVAL_BATCHES)
  out['eval'] = {'scalars': scalars,
                 'audio': [a for _, a in recorder.audio]}
  return out


def ranks_worker(rank, work_dir, ckpt_dir):
  """One rank of phase 6m on cuda:0, its results to work_dir: (a)-(g) on
  the four ranks, (i) and (j) on them, then (h) on the first RANKS_ROWS in
  a group of their own.
  A failure prints its traceback and ends the process at once (no
  collective teardown for the others to wait on)."""
  import traceback  # pylint: disable=g-import-not-at-top
  import torch  # pylint: disable=g-import-not-at-top
  from ddsp_torch.parallel import create_mesh, distributed
  try:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = distributed.init(
        device=torch.device('cuda', 0), backend=RANKS_BACKEND,
        init_method='file://' + os.path.join(work_dir, 'init'), rank=rank,
        world_size=RANKS)
    result = {'shifts': ranks_shifts(torch, dev, rank),
              'dense': ranks_dense(torch, dev, work_dir, rank),
              'long': ranks_long(torch, dev),
              'sp_eval': ranks_eval(torch, dev, rank, work_dir, ckpt_dir,
                                    'sp', 'eval', EVAL_BATCHES),
              'sp_sample': ranks_eval(torch, dev, rank, work_dir, ckpt_dir,
                                      'sp', 'sample', RANKS_SAMPLE_BATCHES),
              'dense_eval': ranks_eval(torch, dev, rank, work_dir, ckpt_dir,
                                       'dense', 'eval', EVAL_BATCHES)}
    for case in ('vst', 'l2'):
      result[case] = ranks_case(torch, dev, case, create_mesh(
          *RANKS_CASES[case][0], devices=[dev]), RANKS_CASES[case][3])
    per_rank = STRADDLE_MESH[0] * STRADDLE_MESH[1] // RANKS
    result['straddle_long'] = straddle_long(
        torch, dev, create_mesh(*STRADDLE_MESH, devices=[dev] * per_rank),
        RANKS_STEPS)
    result['straddle_eval'] = ranks_eval(
        torch, dev, rank, work_dir, ckpt_dir, 'straddle', 'eval',
        STRADDLE_EVAL_BATCHES)
    torch.save(result, os.path.join(work_dir, f'rank{rank}.pt'))
    distributed.shutdown()
    if rank < RANKS_ROWS:
      distributed.init(
          device=dev, backend=RANKS_BACKEND,
          init_method='file://' + os.path.join(work_dir, 'init_rows'),
          rank=rank, world_size=RANKS_ROWS)
      shape = RANKS_CASES['rows'][0]
      per_rank = shape[0] * shape[1] // RANKS_ROWS
      rows = ranks_case(torch, dev, 'rows',
                        create_mesh(*shape, devices=[dev] * per_rank), 1)
      torch.save(rows, os.path.join(work_dir, f'rows{rank}.pt'))
      distributed.shutdown()
  except BaseException:  # pylint: disable=broad-except
    traceback.print_exc()
    sys.stderr.flush()
    os._exit(1)  # pylint: disable=protected-access


def cases_reference(torch, dev):
  """(f), (g), (h)'s one-process runs: each case's mesh with every shard
  in this process on the card."""
  from ddsp_torch.parallel import create_mesh
  out = {}
  for case, (shape, _, _, _) in RANKS_CASES.items():
    mesh = create_mesh(*shape, devices=[dev] * (shape[0] * shape[1]))
    out[case] = ranks_case(torch, dev, case, mesh, 1)  # the first step's held
  return out


def dense_reference(torch):
  """Phase 6m (b)'s one-process step: Trainer on phase 6's 16 rows, the
  same seeds; losses and reduced gradient norms of RANKS_STEPS steps."""
  from ddsp_torch.train import Trainer
  from ddsp_torch.utils import build_model
  trainer = Trainer(build_model('solo_instrument', seed=0), seed=0)
  norms, losses = [], []
  recording_gradients(torch, trainer, norms)
  batch = trainer.to_device(training_batch())
  state = trainer.init()
  for _ in range(RANKS_STEPS):
    state, step_losses = trainer.train_step(state, batch)
    losses.append(step_losses['total_loss'].item())
  return losses, norms


def phase_ranks(torch, dev, long_losses, ckpt_dir, sp_evals):
  """[6m] four torch.distributed ranks on the one card: K3's remote copy,
  the (4 x 1) dense step, the (1 x 4) long-audio step, phase 6b's
  checkpoint evaluated and sampled on (1 x 4) and (4 x 1) meshes of the
  ranks, the vst preset's and an L2 loss's steps on a (1 x 4) one, and a
  (4 x 2) SP step over two ranks of two whole rows each, each against its
  one-process counterpart (phase 6k's evals: sp_evals), and (i), (j) on a
  mesh whose runs straddle data rows; before the ranks the remote copy's
  loopback in this process, after them its fault drill.
  Returns (rank 0's launches by path, the remote copy's kernel entry)."""
  import torch.multiprocessing as mp  # pylint: disable=g-import-not-at-top
  print(f'[6m] {RANKS} ranks on one card ({RANKS_BACKEND}: NCCL refuses two '
        f'ranks on one card): (a) K3\'s remote copy (its loopback in one '
        f'process first, its fault drill last), (b) a {RANKS_DENSE_MESH} '
        f'solo_instrument step at {BATCH} x 4 s, (c) the long-audio step on '
        f'a {SP_MESH} mesh of ranks, (d) SP eval and sample on a {SP_MESH} '
        f'mesh of ranks, (e) dense eval on a {RANKS_DENSE_MESH} one, (f) the '
        f'vst preset ({RANKS_VST_SECONDS} s, B = {RANKS_VST_BATCH}) and (g) '
        f'an L2 SpectralLoss step on a {SP_MESH} one, (h) a '
        f'{RANKS_ROWS_MESH} SP step over {RANKS_ROWS} ranks, (i) the '
        f'long-audio step at B = {STRADDLE_BATCH} and (j) SP eval on a '
        f'{STRADDLE_MESH} mesh of ranks whose runs straddle data rows; times '
        'are of ranks time-sliced on one card', flush=True)
  loopback = ranks_loopback(torch, dev)
  for (name, route), equal in loopback['equal'].items():
    check(equal, f'(a) the loopback ({route}) of the {name} bit for bit '
          'equal to the block')
  want_losses, want_norms = dense_reference(torch)
  references = cases_reference(torch, dev)
  straddled = straddle_references(torch, dev, ckpt_dir)
  torch.cuda.synchronize()
  with tempfile.TemporaryDirectory() as work_dir:
    t0 = time.time()
    ctx = mp.start_processes(ranks_worker, args=(work_dir, ckpt_dir),
                             nprocs=RANKS, join=False, start_method='spawn')
    try:
      while not ctx.join(timeout=10):
        check(time.time() - t0 < RANKS_TIMEOUT_S,
              f'the ranks finished within {RANKS_TIMEOUT_S} s')
    except CheckFailed:
      for p in ctx.processes:
        p.kill()
      raise
    except Exception as e:  # pylint: disable=broad-except
      for p in ctx.processes:
        p.kill()
      raise CheckFailed(f'a rank failed: {e}') from e
    print(f'  the ranks ran in {time.time() - t0:.1f} s (process start and '
          'imports included)')
    ranks = [torch.load(os.path.join(work_dir, f'rank{r}.pt'),
                        weights_only=False) for r in range(RANKS)]
    params = [torch.load(os.path.join(work_dir, f'params{r}.pt'))
              for r in range(RANKS)]
    for r in range(RANKS_ROWS):
      ranks[r]['rows'] = torch.load(os.path.join(work_dir, f'rows{r}.pt'),
                                    weights_only=False)

  # (a) the remote copy.
  for r, result in enumerate(ranks):
    for case in result['shifts']['cases']:
      check(case['equal'] and case['launches']['remote_shift'] == 2 and
            case['launches']['shift'] == 0,
            f'(a) rank {r}, {case["name"]}: the remote copy and its adjoint '
            'bit for bit equal to the torch.distributed plain version, one '
            'remote launch each way')
  shifts = ranks[0]['shifts']
  for name in RANKS_BLOCKS:
    for route, ms in loopback['ms'][name].items():
      print(f'  (a) {name}, loopback, {route}: median '
            f'{spread(ms)[0]:.5f} ms per shift (windows '
            f'{[round(t, 5) for t in ms]})')
    for route, ms in shifts['ms'][name].items():
      print(f'  (a) {name}, four ranks, {route}: '
            f'{float(np.mean(ms)):.4f} ms per shift (windows '
            f'{[round(t, 4) for t in ms]}; rank 0, four ranks time-sliced '
            'on one card)')

  # (b) the dense step.
  for r, result in enumerate(ranks):
    dense = result['dense']
    print(f'  (b) rank {r}: {dense["rows"]} rows; losses '
          f'{[round(l, 5) for l in dense["losses"]]}, gradient norms '
          f'{[tuple(round(n, 5) for n in s) for s in dense["norms"]]}, ms per '
          f'step '
          f'{[round(t, 1) for t in dense["ms"]]}; launches {dense["launches"]}')
    check(all(dense['launches'][k] == RANKS_STEPS
              for k in ('K1f', 'K1t', 'K2f', 'K2b')),
          f'(b) rank {r}: K1f, K1t, K2f and K2b launched once a step')
    check(dense['losses'] == ranks[0]['dense']['losses'],
          f'(b) rank {r}: the reduced losses equal rank 0\'s')
  got = ranks[0]['dense']
  print(f'  (b) one process on {BATCH} rows: losses '
        f'{[round(l, 5) for l in want_losses]}, gradient norms (decoder, '
        f'reverb IR, global) {[tuple(round(n, 5) for n in s) for s in want_norms]}')
  for step in range(RANKS_STEPS):
    loss_apart = abs(got['losses'][step] - want_losses[step]) / abs(
        want_losses[step])
    norms_apart = [abs(a - b) / b
                   for a, b in zip(got['norms'][step], want_norms[step])]
    print(f'  (b) step {step}: loss {loss_apart:.3e} apart; gradient norms '
          f'apart: decoder {norms_apart[0]:.3e}, reverb IR '
          f'{norms_apart[1]:.3e}, global {norms_apart[2]:.3e}')
    if step == 0:
      check(loss_apart <= RANKS_LOSS_RTOL and
            norms_apart[0] <= RANKS_GRAD_NORM_RTOL,
            f'(b) the first step: the loss within {RANKS_LOSS_RTOL} and the '
            f'decoder\'s gradient norm within {RANKS_GRAD_NORM_RTOL} of the '
            'one-process step')
    else:
      check(loss_apart <= RANKS_LATER_LOSS_RTOL,
            f'(b) step {step}: the loss within {RANKS_LATER_LOSS_RTOL} of '
            'the one-process step')
  check(all(torch.equal(p[k], params[0][k]) for p in params[1:]
            for k in p), '(b) the parameters bit for bit equal across ranks')

  # (c) the long-audio step.
  t_local = LONG_SECONDS * SR // SP_MESH[1]
  expected = sp_k3_launches(solo_instrument_convolutions(t_local)[1:],
                            ranks[0]['long']['fft_sizes'])
  for r, result in enumerate(ranks):
    long = result['long']
    print(f'  (c) rank {r}: {long["samples"]} samples a rank; losses '
          f'{[round(l, 5) for l in long["losses"]]}, ms per step '
          f'{[round(t, 1) for t in long["ms"]]}; launches {long["launches"]}')
    check(long['launches']['K3r'] == expected * RANKS_STEPS and
          long['launches']['K3'] == 0,
          f'(c) rank {r}: the remote copy launched {expected} times a step, '
          'the local shift no time')
    check(long['launches']['K2f'] == long['launches']['K2b'] == RANKS_STEPS,
          f'(c) rank {r}: K2f and K2b launched once a step')
  got = ranks[0]['long']['losses']
  print(f'  (c) phase 6k in one process: losses '
        f'{[round(l, 5) for l in long_losses[:RANKS_STEPS]]}')
  for step in range(RANKS_STEPS):
    rtol = RANKS_LONG_FIRST_RTOL if step == 0 else RANKS_LONG_RTOL
    apart = abs(got[step] - long_losses[step]) / abs(long_losses[step])
    print(f'  (c) step {step}: loss {apart:.3e} apart')
    check(apart <= rtol, f'(c) step {step}: the loss within {rtol} of phase '
          '6k\'s one-process step')
  paths = {'ranks': dict(ranks[0]['long']['launches'])}
  paths.update(ranks_evals_checked(ranks, sp_evals))
  paths.update(ranks_cases_checked(torch, ranks, references))
  paths.update(ranks_straddle_checked(torch, ranks, straddled))
  err = max(case['err'] for result in ranks
            for case in result['shifts']['cases'])
  ranks_drill(torch)
  entry = remote_copy_entry(loopback, shifts, paths['ranks']['K3r'], err)
  entry['launches_by_path'] = {path: run['K3r'] for path, run in
                               paths.items()}
  entry['launches_per'] = {unit: paths[path]['K3r'] / n for path, (unit, n)
                           in PER_UNIT.items() if path in paths}
  print(f"  {entry['name']}: launches on rank 0 by path "
        f"{entry['launches_by_path']}, per unit {entry['launches_per']}",
        flush=True)
  return paths, entry


def ranks_evals_checked(ranks, sp_evals):
  """(d), (e): the evals across ranks against phase 6k's; rank 0's
  launches by path."""
  t_local = N_SAMPLES // SP_MESH[1]
  k3 = {'sp': sp_k3_launches(solo_instrument_convolutions(t_local),
                             ranks[0]['long']['fft_sizes'], backward=False),
        'dense': 0}
  rtol = {'sp': RANKS_SP_EVAL_RTOL, 'dense': RANKS_DENSE_EVAL_RTOL}
  atol = {'sp': RANKS_SP_EVAL_AUDIO_ATOL,
          'dense': RANKS_DENSE_EVAL_AUDIO_ATOL}
  for kind, label in (('sp', '(d)'), ('dense', '(e)')):
    want = sp_evals[kind]
    mesh = RANKS_EVAL_MESHES[kind]
    for r, result in enumerate(ranks):
      got = result[f'{kind}_eval']
      print(f'  {label} rank {r}: scalars {got["scalars"]}, ms per eval '
            f'batch {got["ms"]:.3f}; launches {got["launches"]}')
      check(set(got['scalars']) == set(want['scalars']) and all(
          abs(v - want['scalars'][k]) <= rtol[kind] * abs(want['scalars'][k])
          for k, v in got['scalars'].items()),
            f'{label} rank {r}: the scalars of the eval on a {mesh} mesh of '
            f'ranks within {rtol[kind]} of phase 6k\'s one-process '
            f'{kind} eval')
      launches = got['launches']
      if kind == 'sp':
        check(launches['K2f'] == EVAL_BATCHES and
              launches['K3r'] == k3['sp'] * EVAL_BATCHES and
              launches['K3'] == 0 and all(
                  launches[k] == 0 for k in ('K1f', 'K1t', 'K1p', 'K2b')),
              f'{label} rank {r}: K2f once and the remote copy {k3["sp"]} '
              'times a batch (counted from the code), no local K3, no K1 '
              'and no backward kernel')
      else:
        check(launches['K1f'] == launches['K2f'] == EVAL_BATCHES and
              launches['K3'] == launches['K3r'] == 0,
              f'{label} rank {r}: K1f and K2f once a batch, no K3')
      check(r == 0 or (not got['audio'] and not got['files']),
            f'{label} rank {r}: only rank 0 evaluates and writes')
    got = ranks[0][f'{kind}_eval']
    apart = max(float(np.abs(a - b).max())
                for a, b in zip(got['audio'], want['audio']))
    print(f'  {label} the audio gathered on rank 0 against one process: max '
          f'|err| {apart:.3e}; ms per eval batch across ranks '
          f'{got["ms"]:.3f} (rank 0, the loop; of it the forward '
          f'{got["forward_ms"]:.3f} and the outputs\' gather '
          f'{got["gather_ms"]:.3f}, medians), one process '
          f'{want["loop_ms"]:.3f}')
    check(len(got['audio']) == EVAL_BATCHES and
          got['audio'][0].shape == (EVAL_BATCH, N_SAMPLES) and
          apart <= atol[kind],
          f'{label} the gathered audio_synth within {atol[kind]} of the '
          'one-process eval\'s')
    check(got['files'] == ['eval/metrics.jsonl'],
          f'{label} rank 0 wrote the eval\'s metrics')
  files = [result['sp_sample']['files'] for result in ranks]
  want = first_examples(sp_evals['sample_names'],
                        EVAL_BATCH * RANKS_SAMPLE_BATCHES)
  print(f'  (d) sample: rank 0 wrote {len(files[0])} files, one process '
        f'{len(want)} for its first {RANKS_SAMPLE_BATCHES} batch')
  check(files[0] == want and not any(files[1:]) and
        ranks[0]['sp_sample']['scalars'] == {},
        '(d) \'sample\' across ranks: rank 0 wrote the files one process '
        'writes, the others none')
  return {'ranks_sp_eval': ranks[0]['sp_eval']['launches'],
          'ranks_dense_eval': ranks[0]['dense_eval']['launches']}


def ranks_cases_checked(torch, ranks, references):
  """(f), (g), (h): the steps across ranks against the one-process steps;
  rank 0's launches by path."""
  labels = {'vst': '(f)', 'l2': '(g)', 'rows': '(h)'}
  loss_rtol = {'vst': RANKS_LONG_FIRST_RTOL, 'l2': RANKS_LONG_FIRST_RTOL,
               'rows': RANKS_LOSS_RTOL}
  norm_rtol = RANKS_GRAD_NORM_RTOL
  for case, label in labels.items():
    want = references[case]
    holders = ranks[:RANKS_ROWS] if case == 'rows' else ranks
    steps = RANKS_CASES[case][3]
    t_local = want['n_samples'] // RANKS_CASES[case][0][1]
    convolutions = (vst_convolutions(t_local, want['n_samples'])
                    if case == 'vst' else
                    solo_instrument_convolutions(t_local))
    k3 = sp_k3_launches(convolutions,
                        want['fft_sizes'] if case != 'l2' else ())
    for r, result in enumerate(holders):
      got = result[case]
      launches = got['launches']
      print(f'  {label} rank {r}: {got["rows"]} rows x {got["samples"]} '
            f'samples; losses {[round(l, 5) for l in got["losses"]]}, '
            'gradient norms (decoder, reverb IR, global) '
            f'{[tuple(round(n, 5) for n in s) for s in got["norms"]]}, ms per '
            f'step {[round(t, 1) for t in got["ms"]]}; launches {launches}')
      remote, local = (0, k3) if case == 'rows' else (k3, 0)
      check(launches['K2f'] == launches['K2b'] == steps and
            launches['K3r'] == remote * steps and
            launches['K3'] == local * steps,
            f'{label} rank {r}: K2f and K2b once a step, the remote copy '
            f'{remote} and the local shift {local} times a step (counted '
            'from the code)')
      check(all(np.isfinite(got['losses'])) and
            got['losses'] == holders[0][case]['losses'],
            f'{label} rank {r}: finite losses, equal to rank 0\'s')
    got = holders[0][case]
    loss_apart = abs(got['losses'][0] - want['losses'][0]) / abs(
        want['losses'][0])
    norm_apart = abs(got['norms'][0][0] - want['norms'][0][0]) / (
        want['norms'][0][0])
    print(f'  {label} one process: loss {want["losses"][0]:.5f}, decoder '
          f'gradient norm {want["norms"][0][0]:.5f}, ms per step '
          f'{want["ms"][0]:.1f}; across ranks {loss_apart:.3e} and '
          f'{norm_apart:.3e} apart')
    check(loss_apart <= loss_rtol[case] and norm_apart <= norm_rtol,
          f'{label} the first loss within {loss_rtol[case]} and the '
          f'decoder\'s gradient norm within {norm_rtol} of the one-process '
          'step')
  crop = torch.cat([result['vst']['crop'] for result in ranks], dim=1)
  apart = (crop - references['vst']['crop']).abs().max().item()
  print(f'  (f) the Crop\'s signal, gathered and sliced on each rank, '
        f'against one process: {tuple(crop.shape)}, max |err| {apart:.3e}; '
        f'ms per vst step a rank {[round(t, 1) for t in ranks[0]["vst"]["ms"]]}')
  check(crop.shape == references['vst']['crop'].shape and
        apart <= RANKS_SP_EVAL_AUDIO_ATOL,
        f'(f) the Crop across ranks within {RANKS_SP_EVAL_AUDIO_ATOL} of the '
        'one-process signal')
  return {f'ranks_{case}': ranks[0][case]['launches'] for case in labels}


def ranks_straddle_checked(torch, ranks, refs):
  """(i), (j): the straddled mesh's steps and eval across ranks against one
  process's on that mesh; rank 0's launches by path."""
  t_local = LONG_SECONDS * SR // STRADDLE_MESH[1]
  per_rank = STRADDLE_MESH[0] * STRADDLE_MESH[1] // RANKS
  per_step = sp_k3_launches(solo_instrument_convolutions(t_local)[1:],
                            ranks[0]['straddle_long']['fft_sizes'])
  for r, result in enumerate(ranks):
    got = result['straddle_long']
    launches = got['launches']
    shards = [divmod(r * per_rank + j, STRADDLE_MESH[1])
              for j in range(per_rank)]
    print(f'  (i) rank {r}: {got["rows"]} rows x {got["samples"]} samples '
          f'(shards {shards}); losses {[round(l, 5) for l in got["losses"]]}, decoder '
          f'gradient norm {got["norm"]:.5f}, ms per step '
          f'{[round(t, 1) for t in got["ms"]]}, peak '
          f'{got["peak_gib"]:.3f} GiB; launches {launches}')
    check(launches['K2f'] == launches['K2b'] == RANKS_STEPS and
          launches['K3'] == launches['K3r'] == per_step * RANKS_STEPS,
          f'(i) rank {r}: K2f and K2b once a step, the local shift and the '
          f'remote copy each {per_step} times a step (counted from the code)')
    check(all(np.isfinite(got['losses'])) and
          got['losses'] == ranks[0]['straddle_long']['losses'],
          f'(i) rank {r}: finite losses, equal to rank 0\'s')
    check(all(torch.equal(p, ranks[0]['straddle_long']['params'][k])
              for k, p in got['params'].items()),
          f'(i) rank {r}: the decoder\'s parameters after {RANKS_STEPS} '
          'steps bit for bit equal to rank 0\'s')
  got, want = ranks[0]['straddle_long'], refs['long']
  loss_apart = abs(got['losses'][0] - want['losses'][0]) / abs(
      want['losses'][0])
  norm_apart = abs(got['norm'] - want['norm']) / want['norm']
  print(f'  (i) one process on {STRADDLE_MESH}: loss {want["losses"][0]:.5f}'
        f', decoder gradient norm {want["norm"]:.5f}, ms per step '
        f'{[round(t, 1) for t in want["ms"]]}, peak {want["peak_gib"]:.3f} '
        'GiB; across ranks '
        f'{loss_apart:.3e} and {norm_apart:.3e} apart')
  check(loss_apart <= RANKS_LOSS_RTOL and norm_apart <= RANKS_GRAD_NORM_RTOL,
        f'(i) the first loss within {RANKS_LOSS_RTOL} and the decoder\'s '
        f'gradient norm within {RANKS_GRAD_NORM_RTOL} of the one-process '
        'step')

  k3 = sp_k3_launches(solo_instrument_convolutions(N_SAMPLES //
                                                   STRADDLE_MESH[1]),
                      ranks[0]['straddle_long']['fft_sizes'], backward=False)
  want = refs['eval']
  for r, result in enumerate(ranks):
    got = result['straddle_eval']
    launches = got['launches']
    print(f'  (j) rank {r}: scalars {got["scalars"]}, ms per eval batch '
          f'{got["ms"]:.3f}; launches {launches}')
    check(set(got['scalars']) == set(want['scalars']) and all(
        abs(v - want['scalars'][k]) <= RANKS_DENSE_EVAL_RTOL *
        abs(want['scalars'][k]) for k, v in got['scalars'].items()),
          f'(j) rank {r}: the scalars of the eval on a {STRADDLE_MESH} mesh '
          f'of ranks within {RANKS_DENSE_EVAL_RTOL} of the one-process eval '
          'on that mesh')
    check(launches['K2f'] == STRADDLE_EVAL_BATCHES and
          launches['K3'] == launches['K3r'] == k3 * STRADDLE_EVAL_BATCHES
          and all(launches[k] == 0 for k in ('K1f', 'K1t', 'K1p', 'K2b')),
          f'(j) rank {r}: K2f once, the local shift and the remote copy each '
          f'{k3} times a batch (counted from the code), no K1 and no '
          'backward kernel')
    check(r == 0 or (not got['audio'] and not got['files']),
          f'(j) rank {r}: only rank 0 evaluates and writes')
  got = ranks[0]['straddle_eval']
  apart = max(float(np.abs(a - b).max())
              for a, b in zip(got['audio'], want['audio']))
  print(f'  (j) the audio gathered on rank 0 against one process: max |err| '
        f'{apart:.3e}; ms per eval batch {got["ms"]:.3f} (the forward '
        f'{got["forward_ms"]:.3f}, the outputs\' gather '
        f'{got["gather_ms"]:.3f}, medians)')
  check(len(got['audio']) == STRADDLE_EVAL_BATCHES and
        got['audio'][0].shape == (STRADDLE_BATCH, N_SAMPLES) and
        apart <= RANKS_DENSE_EVAL_AUDIO_ATOL and
        got['files'] == ['eval/metrics.jsonl'],
        f'(j) the gathered audio_synth within {RANKS_DENSE_EVAL_AUDIO_ATOL} '
        'of the one-process eval\'s, rank 0 wrote the metrics')
  return {'ranks_straddle_long': ranks[0]['straddle_long']['launches'],
          'ranks_straddle_eval': got['launches']}


def remote_copy_entry(loopback, shifts, launches, err):
  """The kernels line's entry of K3's remote copy at the noise carry
  [2, 120000] float32, the STFT halo beside it. `ms` is the loopback's
  median queued (the card's own time a shift), `ms_call` as the host
  issues it; `ms_ranks` rank 0's time per shift with four ranks
  time-sliced on one card.
  Bound: the sender's block read once and the receiver's output written
  once, at HBM's rate on one card (the slot between them is the design's,
  not the function's: its 4 x bytes are `floor_ms`); across cards the
  block crosses NVLink once, at 450 GB/s each way. The plain version, and
  the library call, is the torch.distributed route, timed on the four
  ranks."""
  def median(ms, route):
    return spread(ms[route])[0] if route in ms else None

  def mean(ms, route):
    return float(np.mean(ms[route])) if route in ms else None

  entry = {'name': 'halo_remote_copy (K3 between ranks)', 'route': 'cuda',
           'source': 'ddsp_torch/csrc/halo.cu',
           'replaces': 'ddsp_tpu/parallel/pallas_halo.py:88',
           'launches': launches, 'max_abs_err': err}
  for name, prefix in zip(RANKS_BLOCKS, ('', 'halo_')):
    block = shifts['bytes'][name]
    lb, rk = loopback['ms'][name], shifts['ms'][name]
    entry.update({
        f'{prefix}ms': median(lb, 'new queued'),
        f'{prefix}ms_spread': spread(lb['new queued'])[1:],
        f'{prefix}ms_call': median(lb, 'new'),
        f'{prefix}ms_ranks': mean(rk, 'new'),
        f'{prefix}plain_ms': mean(rk, 'plain'),
        f'{prefix}bound_ms': 2 * block / PEAK_BYTES_PER_S * 1e3,
        f'{prefix}bound_nvlink_ms': block / NVLINK_BYTES_PER_S * 1e3,
        f'{prefix}floor_ms': 4 * block / PEAK_BYTES_PER_S * 1e3})
  entry.update({'bound_by': 'bytes', 'library_ms': entry['plain_ms'],
                'card': card_line(),
                'timing': ('ms: loopback, CUDA events over windows of '
                           f'{LOOPBACK_SHIFTS} shifts enqueued behind a '
                           'sleeping kernel, median of '
                           f'{LOOPBACK_WINDOWS}; ms_call: the same, as '
                           'the host issues it; ms_ranks and '
                           'plain_ms: '
                           'host clock over windows of '
                           f'{RANKS_SHIFTS_TIMED} shifts, four ranks '
                           'time-sliced on one card')})

  def fmt(v, digits=5):
    return 'not measured' if v is None else f'{v:.{digits}f}'

  print(f"  {entry['name']} ({entry['card']}): the [2, 120000] carry "
        f"loopback {fmt(entry['ms'])} ms (windows {fmt(entry['ms_spread'][0])}"
        f"-{fmt(entry['ms_spread'][1])}); a call {fmt(entry['ms_call'])}; "
        f"four ranks {fmt(entry['ms_ranks'], 4)} ms per shift, plain "
        f"(torch.distributed) {fmt(entry['plain_ms'], 4)}; bound "
        f"{entry['bound_ms']:.6f} ms on one card "
        f"({entry['bound_nvlink_ms']:.5f} over NVLink), the design's 4 x "
        f"bytes {entry['floor_ms']:.5f}; the [2, 2047] halo loopback "
        f"{fmt(entry['halo_ms'])}, four ranks "
        f"{fmt(entry['halo_ms_ranks'], 4)} (plain "
        f"{fmt(entry['halo_plain_ms'], 4)}); launches {launches} on rank 0 "
        f"in (c)", flush=True)
  return entry


PER_UNIT = {'long_audio': ('long_audio_step', LONG_WARMUP + LONG_STEPS),
            'sp_eval': ('sp_eval_batch', EVAL_BATCHES),
            'ranks_sp_eval': ('ranks_sp_eval_batch', EVAL_BATCHES),
            'ranks_dense_eval': ('ranks_dense_eval_batch', EVAL_BATCHES),
            'ranks_vst': ('ranks_vst_step', RANKS_VST_STEPS),
            'ranks_l2': ('ranks_l2_step', 1),
            'ranks_rows': ('ranks_rows_step', 1),
            'ranks_straddle_long': ('ranks_straddle_long_step', RANKS_STEPS),
            'ranks_straddle_eval': ('ranks_straddle_eval_batch',
                                    STRADDLE_EVAL_BATCHES)}


def add_launches(entry, launches, key):
  """entry's launches of the kernel counted under key, by path, and per
  unit of PER_UNIT's paths."""
  entry['launches_by_path'] = {path: run[key]
                               for path, run in launches.items()}
  entry['launches_per'] = {unit: launches[path][key] / n
                           for path, (unit, n) in PER_UNIT.items()}


def profile_steps(torch, fn, n, median_ms, what):
  """Device time by kernel over n calls of fn (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
  rows = device_rows(p)
  busy_ms = sum(r[0] for r in rows) / n
  print(f'  profile: device busy {busy_ms:.3f} ms per {what}, '
        f'{100 * busy_ms / median_ms:.1f}% of its median time; '
        f'{sum(r[1] for r in rows) // n} device activities')
  for ms, count, key in rows[:18]:
    print(f'    {ms / n:8.4f} ms/{what}  x{count // n:<4d} {key[:80]}')
  for ms, count, key in rows[18:]:
    if 'halo_shift' in key:  # K3's launches are short; show them anyway
      print(f'    {ms / n:8.4f} ms/{what}  x{count // n:<4d} {key[:80]}')


def kernel_entry(torch, name, source_line, replaces, launches, err, fn,
                 plain_fn, bound_ms, bound_by, library_ms, iters,
                 plain_iters):
  return {
      'name': name, 'route': 'cuda', 'source': source_line,
      'replaces': replaces, 'launches': launches, 'max_abs_err': err,
      'ms': device_ms(torch, fn, iters),
      'plain_ms': device_ms(torch, plain_fn, plain_iters, warmup=1),
      'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': library_ms,
      'call_ms': cuda_ms(torch, fn, iters),
      'plain_call_ms': cuda_ms(torch, plain_fn, plain_iters, warmup=1)}


def phase_report(torch, port, reqs, launches, dev, profile):
  """launches: {'serve': {...}, 'chain': {...}, 'train': {...}}."""
  print('[7] report', flush=True)
  times = []
  for _ in range(2):
    port.get_audio(reqs[1])
  for i in range(12):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    port.get_audio(reqs[i % len(reqs)])
    end.record()
    torch.cuda.synchronize()
    times.append(start.elapsed_time(end))
  median_ms = float(np.median(times))
  print(f'  request ms: {[round(t, 3) for t in times]}')
  print(f'  median ms per 4 s request: {median_ms:.3f}; audio samples/s: '
        f'{N_SAMPLES / (median_ms / 1e3):.4e}')
  if profile:
    profile_steps(torch, lambda: port.get_audio(reqs[1]), 3, median_ms,
                  'request')
  return k1_entries(torch, launches, dev) + k2_entries(torch, launches, dev)


def k1_entries(torch, launches, dev):
  """The kernels line's K1 entries at the training shape (16 x 64000
  samples, 1000 frames, 60 harmonics, 'window') on the training step's own
  phases (cumsum), with the times on serving's phases (angular cumsum) and
  at B = 1 (one request) beside them."""
  from ddsp_torch.kernels import harmonic as kh
  shape = (N_FRAMES, N_HARMONICS, SR, 'window')
  runs = {}
  for kind in ('cumsum', 'angular'):
    inputs, g, errs = k1_case(torch, dev, 'window', N_FRAMES, BATCH,
                              N_HARMONICS, kind, seed=5)
    runs[kind] = (inputs, g, errs)
  (phase0, f0_env, ham), g, errs = runs['cumsum']
  out = torch.empty_like(phase0)
  dham = torch.empty_like(ham)
  src = 'ddsp_torch/csrc/harmonic.cu'
  ref_src = 'ddsp_tpu/ops/pallas_kernels/harmonic.py'
  fns = {
      'K1f': (lambda p, f, a, g: kh._launch('fwd', (p, f, a), out, *shape),
              lambda p, f, a, g: kh.harmonic_synthesis_plain(p, f, a, SR)),
      'K1t': (lambda p, f, a, g: kh._launch('bwd_taps', (p, f, g), dham,
                                            *shape),
              lambda p, f, a, g: kh.fold_taps(kh.harmonic_bwd_taps_plain(
                  p, f, g, N_FRAMES, N_HARMONICS, SR))),
      'K1p': (lambda p, f, a, g: kh._launch('bwd_phase', (p, f, a, g), out,
                                            *shape),
              lambda p, f, a, g: kh.harmonic_bwd_phase_plain(p, f, a, g, SR)),
  }
  names = {'K1f': ('fused_harmonic_synthesis forward (K1f)', 191, 'fwd',
                   'train'),
           'K1t': ('fused_harmonic_synthesis backward, taps (K1t)', 235,
                   'bwd_taps', 'train'),
           'K1p': ('fused_harmonic_synthesis backward, phase (K1p)', 272,
                   'bwd_phase', 'chain')}
  kernels = []
  for key, (fn, plain) in fns.items():
    name, line, kernel, path = names[key]
    args = (phase0, f0_env, ham, g)
    entry = kernel_entry(
        torch, name, src, f'{ref_src}:{line}', launches[path][key],
        errs[key if key == 'K1f' else key + ' abs'], lambda: fn(*args),
        lambda: plain(*args), *k1_bound(torch, kernel, f0_env, ham), None,
        50, 5)
    if key != 'K1f':  # held to a relative tolerance: sums over a hop or H
      entry['max_rel_err'] = errs[key]
    entry['phases'] = 'cumsum (the training step)'
    (pa, fa, aa), ga, errs_a = runs['angular']
    entry['angular_ms'] = device_ms(torch, lambda: fn(pa, fa, aa, ga), 50)
    entry['angular_err'] = errs_a[key]
    entry['angular_bound_ms'] = k1_bound(torch, kernel, fa, aa)[0]
    if key == 'K1p':  # one chain fma and two tap fmas per sample-harmonic
      entry['issue_floor_ms'] = k1_issue_floor_ms(torch, f0_env, ham, 3)
    kernels.append(entry)

  # One request (B = 1) on serving's phases.
  p1, f1, a1 = k1_inputs(torch, 1, N_FRAMES, 5, dev)
  g1 = g[:1].contiguous()
  o1, d1 = torch.empty_like(p1), torch.empty_like(a1)
  b1 = {'K1f': lambda: kh._launch('fwd', (p1, f1, a1), o1, *shape),
        'K1t': lambda: kh._launch('bwd_taps', (p1, f1, g1), d1, *shape),
        'K1p': lambda: kh._launch('bwd_phase', (p1, f1, a1, g1), o1, *shape)}
  for entry, key in zip(kernels, ('K1f', 'K1t', 'K1p')):
    entry['serving_ms'] = device_ms(torch, b1[key], 100)

  # The ae preset's 100 harmonics (phase 6g) on the plain cumsum phases it
  # runs on: a training step's B = 16 and a request's B = 1.
  shape_ae = (N_FRAMES, AE_HARMONICS, SR, 'window')
  for batch, label in ((BATCH, 'step'), (1, 'request')):
    (pa, fa, aa), ga, errs_a = k1_case(torch, dev, 'window', N_FRAMES, batch,
                                       AE_HARMONICS, 'cumsum', seed=9)
    oa, da = torch.empty_like(pa), torch.empty_like(aa)
    for entry, key, kernel, fn in (
        (kernels[0], 'K1f', 'fwd',
         lambda: kh._launch('fwd', (pa, fa, aa), oa, *shape_ae)),
        (kernels[1], 'K1t', 'bwd_taps',
         lambda: kh._launch('bwd_taps', (pa, fa, ga), da, *shape_ae))):
      entry.setdefault('ae', {})[label] = {
          'H': AE_HARMONICS, 'B': batch, 'ms': device_ms(torch, fn, 50),
          'bound_ms': k1_bound(torch, kernel, fa, aa)[0],
          'max_abs_err': errs_a[key if key == 'K1f' else key + ' abs'],
          'max_rel_err': errs_a[key if key != 'K1f' else 'K1f rel']}
  for entry, key in zip(kernels, ('K1f', 'K1t', 'K1p')):
    add_launches(entry, launches, key)
    print_entry(entry)
  return kernels


def k2_entries(torch, launches, dev):
  """The kernels line's K2 entries at the training shape (B = 16,
  T = 1000, H = 512, bf16 streams): K2f, K2b's serial pass and its
  weight-gradient pass, with B = 1 times, times per serial step and the
  cuDNN yardsticks."""
  from ddsp_torch.kernels import gru as kg
  kernels = []
  # K2 at the training shape: B = 16, T = 1000, H = 512, bf16 streams.
  xp, wh, bn, h0 = k2_inputs(torch, BATCH, torch.bfloat16, 6, dev)
  ys = kg.gru_sequence(xp, wh, bn, h0)
  err = (ys - kg.gru_sequence_plain(xp, wh, bn, h0)).abs().max().item()
  check(err <= K2_ATOL['bfloat16'],
        f"K2f at the training shape within {K2_ATOL['bfloat16']}")
  g2 = torch.randn(ys.shape, device=dev,
                   generator=torch.Generator(dev).manual_seed(10)) / 30.0
  got, want = k2_backward(torch, xp, wh, bn, h0, g2)
  errs = [rel_err(a, b) for a, b in zip(got, want)]
  check(max(errs) <= K2_BWD_RTOL['bfloat16'],
        f"K2b at the training shape within {K2_BWD_RTOL['bfloat16']}")
  h_prev = kg.h_prev_stream(h0, ys, torch.bfloat16)
  bn32, h032 = bn.float().contiguous(), h0.float().contiguous()
  dxp, dhn, dbn_tiles, _ = kg._launch_bwd_serial(g2, xp, h_prev, wh, bn32)
  serial_want = kg.gru_bwd_serial_plain(g2, xp, h_prev, wh, bn)
  serial_err = max((a.float() - b.float()).abs().max().item()
                   for a, b in zip((dxp, dhn, dbn_tiles), serial_want))
  serial_rel = max(rel_err(a, b)
                   for a, b in zip((dxp, dhn, dbn_tiles), serial_want))
  wgrad = kg._launch_wgrad(h_prev, dxp, dhn, dbn_tiles)
  wgrad_want = kg.gru_wgrad_plain(h_prev, dxp, dhn, dbn_tiles)
  wgrad_errs = [rel_err(a, b) for a, b in zip(wgrad, wgrad_want)]
  check(max(wgrad_errs) <= K2_WGRAD_RTOL,
        f'the weight-gradient pass at the training shape within '
        f'{K2_WGRAD_RTOL}')
  hp2d = h_prev.reshape(-1, HIDDEN)
  dhp2d = torch.cat([dxp[..., :2 * HIDDEN], dhn], dim=-1).reshape(
      -1, 3 * HIDDEN)
  lib = library_gru_ms(torch, dev)
  yard = lib['bfloat16'] if 'rec_fwd_ms' in lib['bfloat16'] else lib[
      'float32']
  src = 'ddsp_torch/csrc/gru.cu'
  ref_src = 'ddsp_tpu/ops/pallas_kernels/gru.py'
  kernels.append(kernel_entry(
      torch, 'gru_sequence forward (K2f)', src, f'{ref_src}:124',
      launches['train']['K2f'], err,
      lambda: kg._launch_fwd(xp, wh, bn32, h032),
      lambda: kg.gru_sequence_plain(xp, wh, bn, h0),
      *k2_bound(xp, wh, 'bfloat16'), yard['rec_fwd_ms'], 10, 2))
  kernels.append(kernel_entry(
      torch, 'gru_sequence backward, serial pass (K2b)', src,
      f'{ref_src}:152', launches['train']['K2b'], serial_err,
      lambda: kg._launch_bwd_serial(g2, xp, h_prev, wh, bn32),
      lambda: kg.gru_bwd_serial_plain(g2, xp, h_prev, wh, bn),
      *k2_bound(xp, wh, 'bfloat16', 'serial'), yard['rec_bwd_ms'], 10, 2))
  kernels.append(kernel_entry(
      torch, 'gru_sequence backward, weight gradient (K2b)', src,
      f'{ref_src}:152', launches['train']['K2b_w'],
      max((a - b).abs().max().item() for a, b in zip(wgrad, wgrad_want)),
      lambda: kg._launch_wgrad(h_prev, dxp, dhn, dbn_tiles),
      lambda: kg.gru_wgrad_plain(h_prev, dxp, dhn, dbn_tiles),
      *k2_bound(xp, wh, 'bfloat16', 'wgrad'),
      device_ms(torch, lambda: torch.matmul(hp2d.t(), dhp2d), 50), 50, 5))
  kernels[2]['library'] = 'torch.matmul(h_prev^T, dhp), the same streams'
  kernels[2]['library_call_ms'] = cuda_ms(
      torch, lambda: torch.matmul(hp2d.t(), dhp2d), 50)
  kernels[2]['plan'] = kg.pick_wgrad(dev, HIDDEN, N_FRAMES * BATCH)
  again = kg._launch_wgrad(h_prev, dxp, dhn, dbn_tiles)
  kernels[2]['bit_equal_repeat'] = all(
      torch.equal(a, b) for a, b in zip(wgrad, again))
  check(kernels[2]['bit_equal_repeat'],
        'the weight-gradient pass repeats bit for bit at the training shape')
  # The serving shape (one request: B = 1) beside the training shape.
  xp1, wh1, bn1, h01 = k2_inputs(torch, 1, torch.bfloat16, 6, dev)
  kernels[0]['serving_ms'] = device_ms(
      torch, lambda: kg._launch_fwd(xp1, wh1, bn1, h01), 20)
  ys1 = kg._launch_fwd(xp1, wh1, bn1, h01)
  h_prev1 = kg.h_prev_stream(h01, ys1, torch.bfloat16)
  g1 = g2[:, :1].contiguous()
  kernels[1]['b1_ms'] = device_ms(
      torch, lambda: kg._launch_bwd_serial(g1, xp1, h_prev1, wh1, bn1), 10)
  # Per serial step, and K2b whole (both passes) beside cuDNN's backward.
  kernels[0]['us_per_step'] = {
      'B=16': 1e3 * kernels[0]['ms'] / N_FRAMES,
      'B=1': 1e3 * kernels[0]['serving_ms'] / N_FRAMES}
  kernels[1]['us_per_step'] = {
      'B=16': 1e3 * kernels[1]['ms'] / N_FRAMES,
      'B=1': 1e3 * kernels[1]['b1_ms'] / N_FRAMES}
  kernels[1]['with_wgrad_ms'] = kernels[1]['ms'] + kernels[2]['ms']
  for k in kernels[:2]:
    k['library'] = lib
  # The backward kernels are held to a relative tolerance (sums over T).
  kernels[1]['max_rel_err'] = serial_rel
  kernels[1]['k2b_max_rel_err'] = max(errs)  # both passes vs gru_bwd_plain
  kernels[2]['max_rel_err'] = max(wgrad_errs)
  # Another width, bf16, B = 16, T = 1000 (held in phase 3): H = 384 on the
  # cluster kernels zero-padded to 512; K2b whole (both passes), and
  # cuDNN's bf16 recurrence at the same H beside them.
  xph, whh, bnh, h0h = k2_inputs(torch, BATCH, torch.bfloat16, 6, dev, 384)
  bnh, h0h = bnh.float().contiguous(), h0h.float().contiguous()
  ysh = kg._launch_fwd(xph, whh, bnh, h0h)
  gh = torch.randn(ysh.shape, device=dev,
                   generator=torch.Generator(dev).manual_seed(10)) / 30.0
  hph = kg.h_prev_stream(h0h, ysh, torch.bfloat16)
  libh = library_gru_ms(torch, dev, 384)
  yardh = libh['bfloat16'] if 'rec_fwd_ms' in libh['bfloat16'] else libh[
      'float32']
  for k, fn, bound_ms, lib_ms in (
      (kernels[0], lambda: kg._launch_fwd(xph, whh, bnh, h0h),
       k2_bound(xph, whh, 'bfloat16')[0], yardh['rec_fwd_ms']),
      (kernels[1], lambda: kg._launch_bwd(gh, xph, hph, whh, bnh),
       k2_bound(xph, whh, 'bfloat16', 'serial')[0] +
       k2_bound(xph, whh, 'bfloat16', 'wgrad')[0], yardh['rec_bwd_ms'])):
    k['by_hidden'] = {'384': {
        'route': k2_route_name(torch, 384, torch.bfloat16),
        'ms': device_ms(torch, fn, 5), 'call_ms': cuda_ms(torch, fn, 5),
        'bound_ms': bound_ms, 'library_ms': lib_ms}}
  # The cooperative kernels at B = 16, T = 1000: (a) bf16 H = 1024, (b)
  # bf16 H = 768, (c) float32 H = 512 (solo_instrument(compute_dtype=
  # 'float32')'s decoder GRU), with cuDNN's recurrence at the same shape.
  for key, name, hidden in COOP_SHAPES:
    coop = k2_cooperative_shape(torch, dev, name, hidden)
    kernels[0].setdefault('cooperative', {})[key] = coop['fwd']
    kernels[1].setdefault('cooperative', {})[key] = coop['bwd']
  # The ae encoder's GRU (phase 6g): bf16 streams, H = 512, T = 125 (its
  # MFCC frames), at a step's B = 16 and a request's B = 1; cuDNN's
  # recurrence and torch.matmul of the weight gradient at the same shape
  # (input width 30, the MFCCs) beside it.
  k2_other_shape(torch, dev, kernels, 'ae_encoder', AE_Z_STEPS, 30,
                 (BATCH, 1), 7)
  # The inverse_synthesis RnnSandwich's GRU (phase 6j): bf16 streams,
  # H = 512, T = 250 (the encoder's log-mel frames), at a request's B = 1,
  # a plain or self-supervised step's 16 and a zipped step's 32; the
  # yardsticks at each (input width 256, the first FcStack's).
  k2_other_shape(torch, dev, kernels, 'inv', INV_FRAMES, 256,
                 (1, BATCH, 2 * BATCH), 8)
  # The long-audio step's decoder GRU (phase 6k): bf16 streams, H = 512,
  # T = 7500 (30 s), B = 2 (input width 1024, the decoder's).
  k2_other_shape(torch, dev, kernels, 'long_audio', LONG_FRAMES, 2 * HIDDEN,
                 (LONG_BATCH,), 9)
  for k, key in zip(kernels, ('K2f', 'K2b', 'K2b_w')):
    add_launches(k, launches, key)
    print_entry(k)
  return kernels


def k2_other_shape(torch, dev, kernels, key, seq_len, in_dim, batches,
                   seed):
  """K2f, K2b's serial pass and its weight-gradient pass (kernels[0:3]) at
  H = 512, bf16 streams, T = seq_len and each batch: device ms and bound
  under kernels[i][key]['B=<b>'], with cuDNN's recurrence
  (library_gru_ms, input width in_dim) and torch.matmul of the weight
  gradient at the same batch."""
  from ddsp_torch.kernels import gru as kg
  for batch in batches:
    lib = library_gru_ms(torch, dev, HIDDEN, seq_len=seq_len, in_dim=in_dim,
                         batch=batch)
    yard = lib['bfloat16'] if 'rec_fwd_ms' in lib['bfloat16'] else (
        lib['float32'])
    xa, wa, ba, h0a = k2_inputs(torch, batch, torch.bfloat16, seed, dev,
                                HIDDEN, seq_len)
    ba, h0a = ba.float().contiguous(), h0a.float().contiguous()
    ysa = kg._launch_fwd(xa, wa, ba, h0a)
    ga = torch.randn(ysa.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(seed + 4)
                     ) / 30.0
    hpa = kg.h_prev_stream(h0a, ysa, torch.bfloat16)
    dxa, dhna, dbta, _ = kg._launch_bwd_serial(ga, xa, hpa, wa, ba)
    hpa2d = hpa.reshape(-1, HIDDEN)
    dhpa2d = torch.cat([dxa[..., :2 * HIDDEN], dhna], dim=-1).reshape(
        -1, 3 * HIDDEN)
    matmul = lambda: torch.matmul(hpa2d.t(), dhpa2d)
    parts = (
        (kernels[0], 'fwd', lambda: kg._launch_fwd(xa, wa, ba, h0a),
         yard['rec_fwd_ms']),
        (kernels[1], 'serial',
         lambda: kg._launch_bwd_serial(ga, xa, hpa, wa, ba),
         yard['rec_bwd_ms']),
        (kernels[2], 'wgrad',
         lambda: kg._launch_wgrad(hpa, dxa, dhna, dbta),
         device_ms(torch, matmul, 20)))
    for k, part, fn, lib_ms in parts:
      k.setdefault(key, {})[f'B={batch}'] = {
          'T': seq_len, 'ms': device_ms(torch, fn, 10),
          'bound_ms': k2_bound(xa, wa, 'bfloat16', part)[0],
          'library_ms': lib_ms}
    # The profiler's sum can miss part of cuBLAS's work (a time below the
    # bound); the call's time between CUDA events stands beside it.
    kernels[2][key][f'B={batch}']['library_call_ms'] = cuda_ms(torch, matmul,
                                                               20)


# The kernels line's cooperative shapes: (key, stream dtype, H), B = 16,
# T = 1000.
COOP_SHAPES = (('a', 'bfloat16', 1024), ('b', 'bfloat16', 768),
               ('c', 'float32', HIDDEN))


def k2_cooperative_shape(torch, dev, name, hidden):
  """K2f and K2b whole (the serial pass and, with bf16 streams, the
  weight-gradient pass) on the cooperative kernels at B = 16, T = 1000:
  device and call ms, us per step, bound (float32 at the CUDA cores' peak,
  not TF32's), the launches of one call each, the plan, and cuDNN's
  recurrence at the same shape (full float32, and TF32, for float32
  streams)."""
  from ddsp_torch.kernels import gru as kg
  dtype = getattr(torch, name)
  xp, wh, bn, h0 = k2_inputs(torch, BATCH, dtype, 6, dev, hidden)
  bn, h0 = bn.float().contiguous(), h0.float().contiguous()
  ys = kg._launch_fwd(xp, wh, bn, h0)
  err = (ys - kg.gru_sequence_plain(xp, wh, bn, h0)).abs().max().item()
  g = torch.randn(ys.shape, device=dev,
                  generator=torch.Generator(dev).manual_seed(10)) / 30.0
  h_prev = kg.h_prev_stream(h0, ys, dtype)
  got = kg._launch_bwd(g, xp, h_prev, wh, bn)
  want = kg.gru_bwd_plain(g, xp, h_prev, wh, bn)
  bwd_err = max(rel_err(a, b) for a, b in zip(got, want))
  what = f'K2 {name} H={hidden} B={BATCH} T={N_FRAMES} (cooperative)'
  check(err <= K2_ATOL[name] and bwd_err <= K2_BWD_RTOL[name],
        f'{what}: K2f within {K2_ATOL[name]}, K2b within '
        f'{K2_BWD_RTOL[name]} relative')
  lib = library_gru_ms(torch, dev, hidden, tf32=name == 'float32')
  yard = lib[name]
  fwd = lambda: kg._launch_fwd(xp, wh, bn, h0)
  bwd = lambda: kg._launch_bwd(g, xp, h_prev, wh, bn)
  bounds = {'fwd': k2_bound(xp, wh, name),
            'bwd': (k2_bound(xp, wh, name, 'serial')[0] +
                    k2_bound(xp, wh, name, 'wgrad')[0],
                    k2_bound(xp, wh, name, 'serial')[1])}
  out = {}
  for part, fn, err_part in (('fwd', fwd, err), ('bwd', bwd, bwd_err)):
    reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = {k: v for k, v in read_launches().items() if k.startswith('K2')}
    ms, call_ms = device_ms(torch, fn, 5), cuda_ms(torch, fn, 5)
    for _ in range(2):
      # A profiler session now and then loses a cooperative launch (seen:
      # 0.0317 ms of device time against 5.3 ms between CUDA events): the
      # device time of one launch cannot be below half its call's.
      if ms >= 0.5 * call_ms:
        break
      print(f'  note: device {ms:.4f} ms against {call_ms:.4f} ms per call; '
            'repeating the profile', flush=True)
      ms = device_ms(torch, fn, 5)
    if ms < 0.5 * call_ms:
      print('  note: timing with CUDA events', flush=True)
      ms = call_ms
    out[part] = {
        'ms': ms, 'call_ms': call_ms,
        'us_per_step': 1e3 * ms / N_FRAMES, 'bound_ms': bounds[part][0],
        'bound_by': bounds[part][1],
        'peak': f"{PEAK_FLOPS[name] / 1e12:g} TFLOP/s ({name}"
                + (', CUDA cores' if name == 'float32' else ', tensor cores')
                + ')',
        'launches': counts, 'max_err': err_part,
        'plan': kg.pick_cooperative(dev, hidden, BATCH, part == 'bwd',
                                    name == 'bfloat16'),
        'library_ms': yard[f'rec_{part}_ms']}
    if name == 'float32':
      out[part]['library_tf32_ms'] = lib['float32_tf32'][f'rec_{part}_ms']
  print(f"  {what}: K2f {out['fwd']['ms']:.4f} ms device "
        f"({out['fwd']['us_per_step']:.3f} us a step) against cuDNN "
        f"{out['fwd']['library_ms']:.4f}; K2b {out['bwd']['ms']:.4f} "
        f"({out['bwd']['us_per_step']:.3f} us a step) against "
        f"{out['bwd']['library_ms']:.4f}", flush=True)
  return out


def print_entry(k):
  print(f"  {k['name']}: device {k['ms']:.4f} ms (per call with host "
        f"{k['call_ms']:.4f}), plain {k['plain_ms']:.4f} ms (per call "
        f"{k['plain_call_ms']:.4f}), bound {k['bound_ms']:.5f} ms "
        f"({k['bound_by']}), library {k['library_ms']}, launches "
        f"{k['launches']} {k['launches_by_path']}, max |err| "
        f"{k['max_abs_err']:.3e}"
        + (f" (relative {k['max_rel_err']:.3e})"
           if 'max_rel_err' in k else '')
        + (f", serving shape {k['serving_ms']:.4f} ms"
           if 'serving_ms' in k else '')
        + (f", on angular-cumsum phases {k['angular_ms']:.4f} ms (bound "
           f"{k['angular_bound_ms']:.5f}, err {k['angular_err']:.3e})"
           if 'angular_ms' in k else '')
        + (f", B = 1 {k['b1_ms']:.4f} ms" if 'b1_ms' in k else '')
        + (f", us per step {k['us_per_step']}" if 'us_per_step' in k else '')
        + (f", with the weight-gradient pass {k['with_wgrad_ms']:.4f} ms"
           if 'with_wgrad_ms' in k else '')
        + (f", L2 flushed {k['cold_ms']} ms" if 'cold_ms' in k else '')
        + (f", issue floor {k['issue_floor_ms']:.5f} ms"
           if 'issue_floor_ms' in k else '')
        + (f", other H (B = 16, T = 1000, bf16; with K2b both passes) "
           f"{k['by_hidden']}" if 'by_hidden' in k else '')
        + (f", cooperative kernels (B = 16, T = 1000; (a) bf16 H = 1024, "
           f"(b) bf16 H = 768, (c) float32 H = 512; K2b whole) "
           f"{k['cooperative']}" if 'cooperative' in k else '')
        + (f", plan {k['plan']}" if 'plan' in k else '')
        + (f", ae {k['ae']}" if 'ae' in k else '')
        + (f", ae encoder {k['ae_encoder']}" if 'ae_encoder' in k else '')
        + (f", inverse_synthesis {k['inv']}" if 'inv' in k else '')
        + (f", long audio {k['long_audio']}" if 'long_audio' in k else ''),
        flush=True)


def k3_entry(torch, launches, k3_per_step, mesh, dev):
  """K3 at the reverb carry of the SP path: [16, 64000] float32 per shard
  on the (1 x 4) mesh. Bound: the blocks that have a destination are read
  once (n_time - 1 of each row's n_time) and every block is written once;
  no arithmetic. No single PyTorch call shifts a list of tensors with zero
  fill, so there is no library time."""
  from ddsp_torch.kernels import halo as kk
  gen = torch.Generator(dev).manual_seed(19)
  shards = [torch.randn((BATCH, N_SAMPLES), generator=gen, device=dev)
            for _ in range(mesh.size)]
  out = kk._launch(shards, mesh.run, +1)
  want = kk.halo_shift_plain(shards, mesh.run, +1)
  err = max((o - w).abs().max().item() for o, w in zip(out, want))
  check(err == 0.0, 'K3 at the reverb-carry shape equals its plain version')
  block = shards[0].numel() * shards[0].element_size()
  n_read = mesh.n_data * (mesh.n_time - 1)
  entry = kernel_entry(
      torch, 'halo_shift (K3)', 'ddsp_torch/csrc/halo.cu',
      'ddsp_tpu/parallel/pallas_halo.py:88', launches['sp_train']['K3'], err,
      lambda: kk._launch(shards, mesh.run, +1),
      lambda: kk.halo_shift_plain(shards, mesh.run, +1),
      *bound((n_read + mesh.size) * block, 0, 'float32'), None, 200, 50)
  entry['launches_per_sp_step'] = k3_per_step
  # Repeated launches find the shards in the 50 MB L2; with L2 flushed
  # before each launch (a 256 MiB fill, not counted) K3 reads HBM.
  flush = torch.empty(2**26, dtype=torch.int32, device=dev)
  entry['cold_ms'] = kernel_ms(torch, lambda: kk._launch(shards, mesh.run,
                                                        +1),
                               50, 'halo_shift', before=flush.zero_)
  add_launches(entry, launches, 'K3')
  print_entry(entry)
  return entry


def library_gru_ms(torch, dev, hidden=HIDDEN, seq_len=N_FRAMES,
                   in_dim=2 * HIDDEN, batch=BATCH, tf32=False):
  """Yardsticks for K2 from torch.nn.GRU (cuDNN) on a GRU at B, T and H
  (by default the decoder's: B = 16, T = 1000, input width 2 * 512, as
  solo_instrument's); timed here and used nowhere in the port.

  cuDNN's GRU includes the input projection x @ W_ih^T + b_ih, and its
  backward, which the port hoists out of K2 into one GEMM. So the same
  projection is timed alone at the same shapes (F.linear), and the
  recurrence is the GRU minus the projection ('rec_fwd_ms', 'rec_bwd_ms'),
  beside the raw times. float32 in full float32 (ops.core.full_float32;
  checked against the port's float32 FastGRU first), with tf32 also
  'float32_tf32' (cuDNN and the projection allowed TF32), and bfloat16
  where cuDNN takes it ('refused' where not);
  'kernels' names the top device kernels of one bf16 GRU forward, to show
  which implementation ran. Backward = forward-and-backward minus
  forward, x needing a gradient in both.
  """
  import contextlib
  from torch.nn import functional as F
  from ddsp_torch.nn.layers import FastGRU
  from ddsp_torch.ops.core import full_float32

  @contextlib.contextmanager
  def allow_tf32():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
      yield
    finally:
      cudnn.allow_tf32, matmul.allow_tf32 = saved

  port_gru = FastGRU(in_dim, hidden, compute_dtype='float32').to(dev)
  with torch.no_grad():
    port_gru.bi.normal_(0, 0.1)
    port_gru.bn.normal_(0, 0.1)
  gru = torch.nn.GRU(in_dim, hidden, batch_first=True).to(dev)
  with torch.no_grad():
    gru.weight_ih_l0.copy_(port_gru.wi.t())
    gru.weight_hh_l0.copy_(port_gru.wh.t())
    gru.bias_ih_l0.copy_(port_gru.bi)
    gru.bias_hh_l0.zero_()
    gru.bias_hh_l0[2 * hidden:].copy_(port_gru.bn)
    x = torch.randn((batch, seq_len, in_dim), device=dev)
    err = (gru(x)[0] - port_gru(x)).abs().max().item()
  print(f'  torch.nn.GRU vs port FastGRU (float32, H={hidden}): max |err| '
        f'{err:.3e}')
  check(err <= K2_ATOL['float32'],
        'torch.nn.GRU yardstick computes the same GRU')
  # One profiled call past the decoder's T: the profiler's own cost grows
  # with cuDNN's launches, a few per step.
  iters = 3 if seq_len <= N_FRAMES else 1
  out = {}
  runs = [('float32', torch.float32, full_float32)]
  if tf32:
    runs.append(('float32_tf32', torch.float32, allow_tf32))
  runs.append(('bfloat16', torch.bfloat16, full_float32))
  for name, dtype, precision in runs:
    with precision():
      library_gru_run(torch, gru, x, dtype, name, batch, seq_len, hidden,
                      iters, out)
  return out


def library_gru_run(torch, gru, x, dtype, name, batch, seq_len, hidden,
                    iters, out):
  """One dtype's timings of library_gru_ms into out[name]."""
  from torch.nn import functional as F
  gru = gru.to(dtype)
  xx = x.to(dtype).requires_grad_()
  gy = torch.randn((batch, seq_len, hidden), device=x.device).to(dtype)
  gp = torch.randn((batch, seq_len, 3 * hidden), device=x.device).to(dtype)
  w, b = gru.weight_ih_l0, gru.bias_ih_l0

  def gru_fwd():
    with torch.no_grad():
      gru(xx)

  def gru_fwd_bwd():
    gru.zero_grad(set_to_none=True)
    xx.grad = None
    gru(xx)[0].backward(gy)

  def proj_fwd():
    with torch.no_grad():
      F.linear(xx, w, b)

  def proj_fwd_bwd():
    gru.zero_grad(set_to_none=True)
    xx.grad = None
    F.linear(xx, w, b).backward(gp)

  try:
    gru_fwd()
  except RuntimeError as e:
    out[name] = {'refused': str(e).splitlines()[0][:200]}
    print(f'  torch.nn.GRU {name}: refused ({out[name]["refused"]})')
    return
  fwd = device_ms(torch, gru_fwd, iters)
  both = device_ms(torch, gru_fwd_bwd, iters)
  p_fwd = device_ms(torch, proj_fwd, 20)
  p_both = device_ms(torch, proj_fwd_bwd, 20)
  out[name] = {'gru_fwd_ms': fwd, 'gru_bwd_ms': both - fwd,
               'proj_fwd_ms': p_fwd, 'proj_bwd_ms': p_both - p_fwd,
               'rec_fwd_ms': fwd - p_fwd,
               'rec_bwd_ms': (both - fwd) - (p_both - p_fwd)}
  if dtype == torch.bfloat16:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
      gru_fwd()
      torch.cuda.synchronize()
    out[name]['kernels'] = [r[2][:60] for r in device_rows(prof)[:3]]
  print(f'  torch.nn.GRU {name} H={hidden} T={seq_len} B={batch}: '
        + ', '.join(
      f'{k} {v:.4f}' if isinstance(v, float) else f'{k} {v}'
      for k, v in out[name].items()), flush=True)


def card_line():
  """The card's name and power limit, as nvidia-smi gives them."""
  return subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                         '--format=csv,noheader'], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()[0]


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--profile', action='store_true',
                      help='also print per-kernel device time over 3 requests, '
                      '20 VST hops and 3 training steps (and 3 midiae '
                      'requests of each kind and steps, 3 inverse_synthesis '
                      'requests and steps of each feed)')
  parser.add_argument('--prefetch-pairs', type=int, default=0, metavar='N',
                      help='only time train() from the records with prefetch '
                      '0 against 2 in N pairs (phase 6c\'s timing), then '
                      'exit; no kernel check and no result line')
  args = parser.parse_args(argv)
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this script runs on a GPU.',
          file=sys.stderr)
    return 1
  repo = os.path.dirname(os.path.abspath(__file__))
  if not os.path.isdir(os.path.join(repo, 'ddsp_torch')):
    print('chip_smoke: run from a checkout of the repository (no '
          'ddsp_torch/ beside this script).', file=sys.stderr)
    return 1
  sys.path.insert(0, repo)
  # Full float32 where float32 is asked for (cuDNN would default to TF32).
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda')
  launches = {}
  if args.prefetch_pairs:
    try:
      phase_build()
      with tempfile.TemporaryDirectory() as work_dir:
        phase_prefetch_pairs(torch, work_dir, args.prefetch_pairs)
    except CheckFailed as e:
      print(f'chip_smoke: check failed: {e}', file=sys.stderr)
      return 1
    print(card_line())
    return 0
  try:
    phase_build()
    phase_k1(torch, dev)
    phase_k3(torch, dev)
    phase_k2(torch, dev)
    phase_gradients_reach_parameters(torch, dev)
    phase_k2_hopper(torch, dev)
    launches['surface'] = phase_surface(torch, dev)
    with tempfile.TemporaryDirectory() as work_dir:
      write_export(torch, work_dir)
      port, reqs, launches['serve'] = phase_serve(torch, work_dir)
      launches['program'] = phase_program(torch, dev, work_dir, port, reqs)
      launches['vst'], vst_entry = phase_vst(
          torch, dev, os.path.join(work_dir, 'vst'), args.profile)
      phase_crepe_precision(torch, dev)
      launches['vst_f0'] = phase_vst_f0(torch, dev,
                                        os.path.join(work_dir, 'vst'))
      launches['vst_program'] = phase_vst_programs(
          torch, dev, os.path.join(work_dir, 'vst'))
      for path in ('vst_f0', 'vst_program'):
        vst_entry['launches_by_path'][path] = launches[path]['K2f']
      launches['chain'], _ = phase_chain(torch, dev)
      launches['train'], dense_ms = phase_train(torch, dev, work_dir,
                                                args.profile)
      launches['data_train'], launches['data_serve'] = phase_data_train(
          torch, dev, work_dir)
      launches['eval'] = phase_eval(
          torch, dev, work_dir, os.path.join(work_dir, 'dataset',
                                             'train.tfrecord*'),
          os.path.join(work_dir, 'data_train'))
      cli = phase_cli(torch, dev, work_dir,
                      os.path.join(work_dir, 'dataset', 'train.tfrecord*'))
      for mode, counts in cli.items():
        launches[f'cli_{mode}'] = counts
      launches.update(phase_ae(
          torch, dev, work_dir,
          os.path.join(work_dir, 'dataset', 'train.tfrecord*')))
      launches.update(phase_midiae(
          torch, dev, work_dir,
          os.path.join(work_dir, 'dataset', 'train.tfrecord*'), dense_ms,
          args.profile))
      launches.update(phase_inverse_synthesis(torch, dev, work_dir,
                                              dense_ms, args.profile))
      phase_processors(torch, dev)
      phase_prepare(torch, dev, work_dir)
    phase_wide_gru_steps(torch, dev)
    wide = phase_wide_train_steps(torch, dev, dense_ms, args.profile)
    launches['train_float32'] = wide['float32']
    launches['train_rnn1024'] = wide['rnn_channels=1024']
    with tempfile.TemporaryDirectory() as sp_dir:
      launches['sp_train'], k3_per_step, sp_mesh = phase_sp_train(
          torch, dev, dense_ms, args.profile, os.path.join(sp_dir, 'train'))
      launches['long_audio'], long_losses = phase_long_audio(
          torch, dev, args.profile)
      launches['sp_eval'], sp_evals = phase_sp_eval(
          torch, dev, sp_dir, os.path.join(sp_dir, 'train'), sp_mesh)
      launches['fir_sp'] = phase_fir_sp(torch, dev)
      ranks_paths, remote_entry = phase_ranks(
          torch, dev, long_losses, os.path.join(sp_dir, 'train'), sp_evals)
      launches.update(ranks_paths)
    kernels = phase_report(torch, port, reqs, launches, dev, args.profile)
    kernels.append(k3_entry(torch, launches, k3_per_step, sp_mesh, dev))
    kernels.append(vst_entry)
    kernels.append(remote_entry)
  except CheckFailed as e:
    print(f'chip_smoke: check failed: {e}', file=sys.stderr)
    return 1
  print(json.dumps({'kernels': kernels}))
  print(card_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
