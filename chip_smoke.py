#!/usr/bin/env python3
"""Drive the ddsp_torch port on one NVIDIA GPU: build, check, serve, train,
report.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py            # what the acceptance check runs
    python3 chip_smoke.py --profile  # also print per-kernel breakdowns

Phases (any failed check exits non-zero before the result lines):
  1. build the kernels of ddsp_torch/csrc with nvcc (all sources at once);
  2. K1: the fused harmonic synth (K1f) and its backward kernels (K1t
     amplitude taps, K1p phase) against their plain PyTorch versions, both
     methods, hops 32, 64, 100, 128, 320 and 1280, B in {1, 2, 4}, H in
     {13, 60, 160, 256}, on wrapped (angular cumsum) and unwrapped
     (cumsum) phases; K1t's dham bit-equal across two launches, written
     without fold_taps or a [B, F, 2, H] tensor;
  2c. K3: the halo shift against its plain version, bit for bit, on (1, 4),
     (2, 4) and (1, 8) meshes of one card, both directions, values and
     gradients, at the main path's three blocks; the (2 data x 2 time)
     row rule through the time-sharded fft_convolve;
  3. K2: the fused GRU sequence (K2f) and its backward (K2b) against their
     plain PyTorch versions, both dtypes, at H = 512, T = 1000 and B in
     {1, 4, 16, 40, 128} (a ragged tile, and past the old kernels' batch
     limit) and at H = 64, T = 24; bf16 at H = 96 and 384 (the cluster
     kernels, zero-padded to 128 and 512) and 1024 (the cooperative
     kernels), B in {1, 16, 40}, and float32 at H = 1024, B = 16; the
     launches of each route; with bf16 streams K2b's two passes, the
     serial reverse-time kernel and the weight-gradient kernel, each against
     its own plain version; the clusters chosen; gradients through FastGRU
     and harmonic_synthesis on the card against the port on the CPU;
  3c. K2b's weight-gradient kernel (TMA + wgmma, split K over a cluster per
     output tile) against its plain version at H = 512, T = 1000, B in
     {1, 16, 40, 128}, at H = 64 and through the padded H = 96 and 384,
     with its plan and bit-equal repeats; K2f's step kernel (float32,
     T = 1, no grid barrier) against its plain version at B in {1, 4, 40}
     and H in {64, 512, 1024} with a non-zero h0;
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
  5. the synthesis chain (Harmonic + FilteredNoise + Add + Reverb, batch 16,
     4 s) forward and gradient with respect to every control, f0 included:
     the path of K1p;
  6. train full-width solo_instrument (bf16, loudness from the audio) on a
     synthetic batch of 16 x 4 s through Trainer and train(); check the
     losses, the gradients, the kernels' launch counts, a step against the
     port on the CPU (the reverb IR's gradient too: check_ir_gradient), and
     a checkpoint round trip;
  6a. one B = 2 training step at rnn_channels 384 and 1024 against the port
     on the CPU, with the launches of each GRU route;
  6b. train the same model sequence-parallel: Trainer on a (1 data x 4 time)
     mesh whose shards share the card, halo_impl='pallas'; check the losses,
     the kernels' launches per step (K3 as counted from the code, K1 none),
     the first step against the dense step, the sharded loss against the
     dense SpectralLoss, and a step against the same SP step on the CPU
     (the reverb IR's gradient too, and against the dense step);
  7. report per-request and per-step times, the kernels line and the device
     line.

Exits 1 without a CUDA device or outside a checkout of the repository.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
PEAK_BYTES_PER_S = 3.35e12
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
  """The main path's three K3 blocks per shard, as (name, leaves, shards,
  embed): the reverb's tail carry [16, 64000]; the STFT halo, a strided
  [16, 2047] view of a [16, 16000] shard; the delta-time boundary frame, slot
  31 of [16, 32, 1025] magnitudes. embed(adj) puts a block's cotangent where
  its leaf holds the block."""
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
  halo_cols = (slice(None), slice(0, 2047))
  slot = (slice(None), slice(31, 32))
  return [('reverb carry', carry, carry, lambda adj: adj),
          ('STFT halo view', audio, [a[halo_cols] for a in audio],
           zeros_but(audio[0], halo_cols)),
          ('boundary frame', mags, [m[slot] for m in mags],
           zeros_but(mags[0], slot))]


def phase_k3(torch, dev):
  """K3 against its plain version on meshes of one card: the results and
  the gradients (the adjoint shift) must be equal bit for bit, a copy has
  no rounding; the boundary shards get zeros. Then the data-row rule
  through the whole time-sharded fft_convolve on a (2 x 2) mesh."""
  from ddsp_torch.kernels import halo as kk
  from ddsp_torch.ops.fftconv import fft_convolve
  from ddsp_torch.parallel import create_mesh, halo, time_shard
  print('[2c] K3 halo shift vs plain: meshes (1, 4), (2, 4), (1, 8), both '
        'directions, values and gradients', flush=True)
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
        want = kk.halo_shift_plain([x.detach() for x in shards], mesh,
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
        adj = kk.halo_shift_plain(cot, mesh, -direction)
        torch.cuda.synchronize()
        check(kk.launches['shift'] == 2 and all(
            torch.equal(g, embed(a)) for g, a in zip(grads, adj)),
              f'{what}: the gradient is the plain adjoint, bit for bit')

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
  inputs: {name: relative max err}. The serial pass takes the plain
  forward's h_prev stream; the weight-gradient pass takes the serial
  kernel's outputs."""
  from ddsp_torch.kernels import gru as kg
  bn32, h032 = bn.float().contiguous(), h0.float().contiguous()
  ys = kg.gru_sequence_plain(xp, wh, bn, h0)
  h_prev = kg.h_prev_stream(h032, ys, torch.bfloat16)
  got = kg._launch_bwd_serial(g, xp, h_prev, wh, bn32)
  want = kg.gru_bwd_serial_plain(g, xp, h_prev, wh, bn)
  errs = {f'serial {k}': rel_err(a, b) for k, a, b in
          zip(('dxp', 'dhn', 'dbn tiles', 'dh0'), got, want)}
  dwh, dbn = kg._launch_wgrad(h_prev, *got[:3])
  want_w = kg.gru_wgrad_plain(h_prev, *got[:3])
  errs.update({f'wgrad {k}': rel_err(a, b) for k, a, b in
               zip(('dwh', 'dbn'), (dwh, dbn), want_w)})
  return errs


def k2_expected_launches(torch, hidden, batch, dtype, dev):
  """{'K2f', 'K2b', 'K2b_w'}: the launches one forward and backward of K2
  make on this route (the cluster route: one each, both passes of K2b;
  the cooperative route: one K2f and one K2b per row group, no
  weight-gradient pass)."""
  from ddsp_torch.kernels import gru as kg
  if dtype == torch.bfloat16 and kg.bf16_route(hidden)[0] == 'cluster':
    return {'K2f': 1, 'K2b': 1, 'K2b_w': 1}
  groups = {}
  for backward in (False, True):
    _, rows = kg.pick_cooperative(dev, hidden, batch, backward,
                                  dtype == torch.bfloat16)
    groups[backward] = -(-batch // rows)
  return {'K2f': groups[False], 'K2b': groups[True], 'K2b_w': 0}


def k2_route_name(torch, hidden, dtype):
  from ddsp_torch.kernels import gru as kg
  if dtype == torch.bfloat16:
    route, h_pad = kg.bf16_route(hidden)
    return f'{route} (H padded to {h_pad})' if h_pad != hidden else route
  return 'cooperative'


# K2 cases of phase 3: (H, T, batches, dtypes). H = 512 and 64 are the
# cluster kernels' own sizes; 96 and 384 run on them zero-padded (to 128
# and 512); 1024 is past any cluster and takes the cooperative kernels, in
# bf16 and in float32.
K2_CASES = (
    (HIDDEN, N_FRAMES, (1, 4, 16, 40, 128), ('float32', 'bfloat16')),
    (64, 24, (1, 4, 16, 40, 128), ('float32', 'bfloat16')),
    (96, N_FRAMES, (1, 16), ('bfloat16',)),
    (96, 24, (40,), ('bfloat16',)),
    (384, N_FRAMES, (1, 16), ('bfloat16',)),
    (384, 24, (40,), ('bfloat16',)),
    (1024, N_FRAMES, (1, 16), ('bfloat16',)),
    (1024, 24, (40,), ('bfloat16',)),
    (1024, N_FRAMES, (16,), ('float32',)),
)


def phase_k2(torch, dev):
  from ddsp_torch.kernels import gru as kg
  print('[3] K2 fused GRU vs plain: forward and backward, both dtypes, '
        'H in {64, 96, 384, 512, 1024}, B in {1, 4, 16, 40, 128}',
        flush=True)
  for hidden in (HIDDEN, 64):
    for backward in (False, True):
      c = kg.pick_cluster(dev, hidden, backward)
      print(f"  bf16 {'K2b serial' if backward else 'K2f'} H={hidden}: "
            f"cluster of {c['cluster']} CTAs x u = {c['units']} units, "
            f"{c['smem_bytes']} B shared memory per CTA, at most "
            f"{c['max_active_clusters']} clusters resident", flush=True)
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
        if dtype == torch.bfloat16 and hidden in kg.CLUSTER_HIDDEN:
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
  earlier design, the cooperative kernel with its grid barrier (still the
  float32 route from T = 2), is timed on the same operands."""
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
        f"{entry['library_call_ms']:.4f} ms; the earlier design (the "
        f"cooperative kernel) {entry['cooperative_ms']:.4f} ms device, "
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
  import itertools
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


def sp_k3_launches_per_step(t_local, noise_ir_size, fft_sizes):
  """K3 launches in one SP training step of solo_instrument, counted from
  the code of parallel/time_shard.py.

  local_fft_convolve_same shifts its tail right ceil(tail / t_local) times
  and its head left ceil(delay / t_local) times; every one of those carries
  a gradient back (the IR, and the reverb's audio, need one), so each runs
  again in the backward. local_stft_mag shifts one right halo left per FFT
  size and signal; only the synthesized audio's needs a gradient.
  """
  def fft_convolve(frame, ir_size, delay):
    fft_size = int(2**np.ceil(np.log2(frame + ir_size - 1)))
    tail = (t_local // frame - 1) * frame + fft_size - delay - t_local
    return -(-tail // t_local) + -(-delay // t_local)
  reverb = fft_convolve(t_local, REVERB_LENGTH, 0)  # sub-frame = shard
  noise = fft_convolve(N_SAMPLES // N_FRAMES, noise_ir_size,
                       (noise_ir_size - 1) // 2 - 1)
  return 2 * (reverb + noise) + 3 * len(fft_sizes)


def sp_step_gradients(torch, model, batch, noise, mesh):
  """(total_loss, {name: grad}) of one SP step's forward and backward."""
  from ddsp_torch.parallel import sp_forward_with_losses
  _, losses = sp_forward_with_losses(model, batch, mesh, halo_impl='pallas',
                                     noise=noise)
  names = [k for k, _ in model.named_parameters()]
  grads = torch.autograd.grad(losses['total_loss'],
                              [p for _, p in model.named_parameters()])
  return losses['total_loss'].item(), dict(zip(names, grads))


def phase_sp_train(torch, dev, dense_ms, profile):
  """Sequence-parallel training of full-width solo_instrument on a (1 x 4)
  mesh whose shards share the card: the path of K3."""
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
  noise_ir = 2 * (N_NOISE - 1)
  expected_k3 = sp_k3_launches_per_step(N_SAMPLES // SP_MESH[1], noise_ir,
                                        fft_sizes)

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
    entry['launches_by_path'] = {path: run[key]
                                 for path, run in launches.items()}
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
  # Other widths, bf16, B = 16, T = 1000 (held in phase 3): H = 384 on the
  # cluster kernels zero-padded to 512, 1024 on the cooperative kernels;
  # K2b whole (both passes where the route has two), and cuDNN's bf16
  # recurrence at the same H beside them.
  for hidden in (384, 1024):
    xph, whh, bnh, h0h = k2_inputs(torch, BATCH, torch.bfloat16, 6, dev,
                                   hidden)
    bnh, h0h = bnh.float().contiguous(), h0h.float().contiguous()
    ysh = kg._launch_fwd(xph, whh, bnh, h0h)
    gh = torch.randn(ysh.shape, device=dev,
                     generator=torch.Generator(dev).manual_seed(10)) / 30.0
    hph = kg.h_prev_stream(h0h, ysh, torch.bfloat16)
    libh = library_gru_ms(torch, dev, hidden)
    yardh = libh['bfloat16'] if 'rec_fwd_ms' in libh['bfloat16'] else libh[
        'float32']
    route = k2_route_name(torch, hidden, torch.bfloat16)
    fwd = lambda: kg._launch_fwd(xph, whh, bnh, h0h)
    bwd = lambda: kg._launch_bwd(gh, xph, hph, whh, bnh)
    serial = k2_bound(xph, whh, 'bfloat16', 'serial')[0]
    for k, fn, bound_ms, lib_ms in (
        (kernels[0], fwd, k2_bound(xph, whh, 'bfloat16')[0],
         yardh['rec_fwd_ms']),
        (kernels[1], bwd, serial + k2_bound(xph, whh, 'bfloat16', 'wgrad')[0],
         yardh['rec_bwd_ms'])):
      k.setdefault('by_hidden', {})[str(hidden)] = {
          'route': route, 'ms': device_ms(torch, fn, 5),
          'call_ms': cuda_ms(torch, fn, 5), 'bound_ms': bound_ms,
          'library_ms': lib_ms}
  for k, key in zip(kernels, ('K2f', 'K2b', 'K2b_w')):
    k['launches_by_path'] = {path: run[key] for path, run in launches.items()}
    print_entry(k)
  return kernels


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
        + (f", plan {k['plan']}" if 'plan' in k else ''),
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
  out = kk._launch(shards, mesh, +1)
  want = kk.halo_shift_plain(shards, mesh, +1)
  err = max((o - w).abs().max().item() for o, w in zip(out, want))
  check(err == 0.0, 'K3 at the reverb-carry shape equals its plain version')
  block = shards[0].numel() * shards[0].element_size()
  n_read = mesh.n_data * (mesh.n_time - 1)
  entry = kernel_entry(
      torch, 'halo_shift (K3)', 'ddsp_torch/csrc/halo.cu',
      'ddsp_tpu/parallel/pallas_halo.py:88', launches['sp_train']['K3'], err,
      lambda: kk._launch(shards, mesh, +1),
      lambda: kk.halo_shift_plain(shards, mesh, +1),
      *bound((n_read + mesh.size) * block, 0, 'float32'), None, 200, 50)
  entry['launches_per_sp_step'] = k3_per_step
  # Repeated launches find the shards in the 50 MB L2; with L2 flushed
  # before each launch (a 256 MiB fill, not counted) K3 reads HBM.
  flush = torch.empty(2**26, dtype=torch.int32, device=dev)
  entry['cold_ms'] = kernel_ms(torch, lambda: kk._launch(shards, mesh, +1),
                               50, 'halo_shift', before=flush.zero_)
  entry['launches_by_path'] = {path: run['K3']
                               for path, run in launches.items()}
  print_entry(entry)
  return entry


def library_gru_ms(torch, dev, hidden=HIDDEN):
  """Yardsticks for K2 from torch.nn.GRU (cuDNN) on the decoder's GRU at
  B = 16, T = 1000 and H (input width 2 * 512, as solo_instrument's); timed
  here and used nowhere in the port.

  cuDNN's GRU includes the input projection x @ W_ih^T + b_ih, and its
  backward, which the port hoists out of K2 into one GEMM. So the same
  projection is timed alone at the same shapes (F.linear), and the
  recurrence is the GRU minus the projection ('rec_fwd_ms', 'rec_bwd_ms'),
  beside the raw times. float32 (checked against the port's float32
  FastGRU first) and bfloat16 where cuDNN takes it ('refused' where not);
  'kernels' names the top device kernels of one bf16 GRU forward, to show
  which implementation ran. Backward = forward-and-backward minus
  forward, x needing a gradient in both.
  """
  from torch.nn import functional as F
  from ddsp_torch.nn.layers import FastGRU
  in_dim = 2 * HIDDEN
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
    x = torch.randn((BATCH, N_FRAMES, in_dim), device=dev)
    err = (gru(x)[0] - port_gru(x)).abs().max().item()
  print(f'  torch.nn.GRU vs port FastGRU (float32, H={hidden}): max |err| '
        f'{err:.3e}')
  check(err <= K2_ATOL['float32'],
        'torch.nn.GRU yardstick computes the same GRU')
  out = {}
  for name, dtype in (('float32', torch.float32),
                      ('bfloat16', torch.bfloat16)):
    gru = gru.to(dtype)
    xx = x.to(dtype).requires_grad_()
    gy = torch.randn((BATCH, N_FRAMES, hidden), device=dev).to(dtype)
    gp = torch.randn((BATCH, N_FRAMES, 3 * hidden), device=dev).to(dtype)
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
      continue
    fwd = device_ms(torch, gru_fwd, 3)
    both = device_ms(torch, gru_fwd_bwd, 3)
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
    print(f'  torch.nn.GRU {name} H={hidden}: ' + ', '.join(
        f'{k} {v:.4f}' if isinstance(v, float) else f'{k} {v}'
        for k, v in out[name].items()), flush=True)
  return out


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--profile', action='store_true',
                      help='also print per-kernel device time over 3 requests, '
                      '20 VST hops and 3 training steps')
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
  try:
    phase_build()
    phase_k1(torch, dev)
    phase_k3(torch, dev)
    phase_k2(torch, dev)
    phase_gradients_reach_parameters(torch, dev)
    phase_k2_hopper(torch, dev)
    with tempfile.TemporaryDirectory() as work_dir:
      write_export(torch, work_dir)
      port, reqs, launches['serve'] = phase_serve(torch, work_dir)
      launches['vst'], vst_entry = phase_vst(
          torch, dev, os.path.join(work_dir, 'vst'), args.profile)
      launches['chain'], _ = phase_chain(torch, dev)
      launches['train'], dense_ms = phase_train(torch, dev, work_dir,
                                                args.profile)
    phase_wide_gru_steps(torch, dev)
    launches['sp_train'], k3_per_step, sp_mesh = phase_sp_train(
        torch, dev, dense_ms, args.profile)
    kernels = phase_report(torch, port, reqs, launches, dev, args.profile)
    kernels.append(k3_entry(torch, launches, k3_per_step, sp_mesh, dev))
    kernels.append(vst_entry)
  except CheckFailed as e:
    print(f'chip_smoke: check failed: {e}', file=sys.stderr)
    return 1
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0]
  print(json.dumps({'kernels': kernels}))
  print(smi)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
