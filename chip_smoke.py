#!/usr/bin/env python3
"""Drive the ddsp_torch port on one NVIDIA GPU: build, check, serve, train,
report.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py            # what the acceptance check runs
    python3 chip_smoke.py --profile  # also print per-kernel breakdowns

Phases (any failed check exits non-zero before the result lines):
  1. build the kernels of ddsp_torch/csrc with nvcc (all sources at once);
  2. K1: the fused harmonic synth (K1f) and its backward kernels (K1t
     amplitude taps, K1p phase) against their plain PyTorch versions;
  3. K2: the fused GRU sequence (K2f) and its backward (K2b) against their
     plain PyTorch versions; gradients through FastGRU and
     harmonic_synthesis on the card against the port on the CPU;
  4. serve 4 requests of 4 s through the full-width solo_instrument
     autoencoder (AutoencoderInference on a params-format export), check the
     audio, and check that K1f and K2f carried the path;
  5. the synthesis chain (Harmonic + FilteredNoise + Add + Reverb, batch 16,
     4 s) forward and gradient with respect to every control, f0 included:
     the path of K1p;
  6. train full-width solo_instrument (bf16, loudness from the audio) on a
     synthetic batch of 16 x 4 s through Trainer and train(); check the
     losses, the gradients, the kernels' launch counts, a step against the
     port on the CPU, and a checkpoint round trip;
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
# K2f: float32 differs by summation order only; bf16 rounds h and wh.
K2_ATOL = {'float32': 1e-4, 'bfloat16': 5e-2}
# K2b, relative to the largest element of each plain result: float32 is
# summation order over 1000 steps; in bf16 dxp and dhp are rounded to bf16
# (3 significant digits) where the two versions' float32 values differ in
# the last bits.
K2_BWD_RTOL = {'float32': 1e-4, 'bfloat16': 2e-2}
E2E_REL_L2 = 5e-2
# One training step on the card against the port on the CPU (plain
# versions), B = 2: bf16 activations round at the same places, the kernels
# sum in another order, and the logmag term amplifies both.
STEP_LOSS_RTOL = 5e-3
STEP_GRAD_NORM_RTOL = 5e-2


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


def k1_inputs(torch, batch, n_frames, seed, dev):
  """phase0, f0_env [B, N] and ham [B, F, H] as the synth's factored path
  builds them; f0 spans 80-1600 Hz so the Nyquist mask cuts harmonics."""
  from ddsp_torch.ops.oscillator import angular_cumsum
  from ddsp_torch.ops.resample import resample
  g = torch.Generator(dev).manual_seed(seed)
  f0 = 80.0 * 20.0**torch.rand((batch, n_frames, 1), generator=g, device=dev)
  ham = (torch.rand((batch, n_frames, 1), generator=g, device=dev) *
         torch.rand((batch, n_frames, N_HARMONICS), generator=g, device=dev))
  f0_env = resample(f0, N_SAMPLES)
  phase0 = angular_cumsum(f0_env * 2 * np.pi / SR)
  return phase0[..., 0].contiguous(), f0_env[..., 0].contiguous(), ham


def bound(n_bytes, ops, dtype_name):
  """(least ms, 'bytes' or 'operations') for work of n_bytes moved once and
  ops operations at the card's peak rate for dtype_name."""
  t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype_name]
  return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def k1_bound(torch, kernel, f0_env, ham):
  """Least time for a K1 kernel's work on these inputs.

  Bytes: the [B, N] float32 streams it reads and writes (fwd: phase, f0 in,
  audio out; taps: phase, f0, g in; phase: phase, f0, g in, dphase out) plus
  the frame array it reads (fwd, phase) or the per-hop partials it writes
  (taps). Operations per sample per harmonic below Nyquist (the kernels
  stop at the first muted harmonic, so count this data's share): recurrence
  2, mask 1, two taps' FMAs 4 (fwd and taps: 6, counting the mask and one
  FMA as one each with the recurrence's two), plus the multiply by h for
  the phase kernel (8).
  """
  n = f0_env.numel()
  batch, n_frames, n_harmonics = ham.shape
  streams = {'fwd': 3, 'bwd_taps': 3, 'bwd_phase': 4}[kernel]
  frames = 2 * ham.numel() if kernel == 'bwd_taps' else ham.numel()
  n_bytes = 4 * (streams * n + frames)
  hmax = (SR / 2.0) / torch.clamp(f0_env, min=1e-20)
  active = torch.clamp(torch.ceil(hmax) - 1, 0, n_harmonics).sum().item()
  ops = (8.0 if kernel == 'bwd_phase' else 6.0) * active
  return bound(n_bytes, ops, 'float32')


def k2_inputs(torch, batch, dtype, seed, dev):
  g = torch.Generator(dev).manual_seed(seed)
  xp = 0.5 * torch.randn((N_FRAMES, batch, 3 * HIDDEN), generator=g,
                         device=dev)
  wh = torch.randn((HIDDEN, 3 * HIDDEN), generator=g, device=dev) / np.sqrt(
      HIDDEN)
  bn = 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
  h0 = 0.1 * torch.randn((batch, HIDDEN), generator=g, device=dev)
  return xp.to(dtype), wh.to(dtype), bn, h0


def k2_bound(xp, wh, dtype_name, backward=False):
  """Least time for K2's work: bytes vs operations at the peak rate of the
  operands' type.

  Forward: xp, wh, bn, h0 in, ys out; one recurrent product and ~12 gate
  operations per unit per step. Backward: g, xp, h_prev, wh, bn in, dxp,
  dwh, dbn, dh0 out; three products per step (the recomputed h @ wh,
  dhp @ wh^T and h^T dhp) and ~30 gate operations per unit.
  """
  seq_len, batch, three_h = xp.shape
  hidden = three_h // 3
  item = xp.element_size()
  weights = wh.numel() * wh.element_size()
  small = 4 * (hidden + batch * hidden)
  if backward:
    n_bytes = (seq_len * batch * (4 * hidden + 2 * three_h * item +
                                  hidden * item) + weights + 4 * wh.numel() +
               2 * small)
    ops = seq_len * batch * (3 * 2.0 * hidden * three_h + 30.0 * hidden)
  else:
    n_bytes = (xp.numel() * item + weights + small +
               4 * seq_len * batch * hidden)
    ops = seq_len * batch * (2.0 * hidden * three_h + 12.0 * hidden)
  return bound(n_bytes, ops, dtype_name)


def phase_build():
  from ddsp_torch.kernels import _build
  print('[1] build', flush=True)
  t0 = time.time()
  built = _build.build(['harmonic', 'gru'])
  seconds = time.time() - t0
  for name, (path, log) in built.items():
    print(f'  {name}: {path}')
    for line in log.splitlines():
      if 'registers' in line or 'spill' in line or 'smem' in line:
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


def phase_k1(torch, dev):
  from ddsp_torch.kernels import harmonic as kh
  print('[2] K1 fused harmonic synth vs plain: forward, taps and phase '
        'backward', flush=True)
  # Hop 64 is the serving and training shape; 320 the VST hop; 32 and 128
  # bracket them.
  for method, n_frames in (('window', N_FRAMES), ('linear', N_SAMPLES // 320),
                           ('window', N_SAMPLES // 32),
                           ('linear', N_SAMPLES // 128)):
    hop = N_SAMPLES // n_frames
    phase0, f0_env, ham = k1_inputs(torch, 4, n_frames, 1, dev)
    out = kh.fused_harmonic_synthesis(phase0, f0_env, ham, SR, method)
    ref = kh.harmonic_synthesis_plain(phase0, f0_env, ham, SR, method)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    print(f'  K1f {method} hop {hop}: max |err| {err:.3e} (atol {K1_ATOL})')
    check(torch.isfinite(out).all().item() and err <= K1_ATOL,
          f'K1f {method} hop {hop} within {K1_ATOL}')
    g = torch.randn(phase0.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(7))
    dham, dphase, ref_dham, ref_dphase = k1_backward(torch, phase0, f0_env,
                                                     ham, g, method)
    torch.cuda.synchronize()
    for name, got, want in (('K1t dham', dham, ref_dham),
                            ('K1p dphase', dphase, ref_dphase)):
      err = rel_err(got, want)
      print(f'  {name} {method} hop {hop}: relative max err {err:.3e} '
            f'(rtol {K1_BWD_RTOL})')
      check(torch.isfinite(got).all().item() and err <= K1_BWD_RTOL,
            f'{name} {method} hop {hop} within {K1_BWD_RTOL}')


def k2_backward(torch, xp, wh, bn, h0, g):
  """(dxp, dwh, dbn, dh0) from K2b and from its plain version."""
  from ddsp_torch.kernels import gru as kg
  leaves = [t.detach().requires_grad_() for t in (xp, wh.float(), bn, h0)]
  ys = kg.gru_sequence(*leaves)
  got = torch.autograd.grad(ys, leaves, g)
  h_prev = kg.h_prev_stream(h0, ys.detach(), kg.stream_dtype(xp.dtype))
  return got, kg.gru_bwd_plain(g, xp, h_prev, wh, bn)


def phase_k2(torch, dev):
  from ddsp_torch.kernels import gru as kg
  print('[3] K2 fused GRU vs plain: forward and backward', flush=True)
  for name, dtype in (('float32', torch.float32),
                      ('bfloat16', torch.bfloat16)):
    xp, wh, bn, h0 = k2_inputs(torch, 4, dtype, 2, dev)
    ys = kg.gru_sequence(xp, wh, bn, h0)
    ref = kg.gru_sequence_plain(xp, wh, bn, h0)
    torch.cuda.synchronize()
    err = (ys - ref).abs().max().item()
    print(f'  K2f {name}: max |err| {err:.3e} (atol {K2_ATOL[name]})')
    check(torch.isfinite(ys).all().item() and err <= K2_ATOL[name],
          f'K2f {name} within {K2_ATOL[name]}')
    g = torch.randn(ys.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(8)) / 30.0
    got, want = k2_backward(torch, xp, wh, bn, h0, g)
    torch.cuda.synchronize()
    check(got[0].dtype == xp.dtype and all(
        t.dtype == torch.float32 for t in got[1:]),
          f'K2b {name}: dxp at the stream dtype, dwh/dbn/dh0 float32')
    for what, a, b in zip(('dxp', 'dwh', 'dbn', 'dh0'), got, want):
      err = rel_err(a, b)
      print(f'  K2b {name} {what}: relative max err {err:.3e} '
            f'(rtol {K2_BWD_RTOL[name]})')
      check(torch.isfinite(a).all().item() and err <= K2_BWD_RTOL[name],
            f'K2b {name} {what} within {K2_BWD_RTOL[name]}')


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
  from ddsp_torch.kernels import harmonic as kh
  kh.reset_launches()
  kg.reset_launches()


def read_launches():
  """{'K1f': n, 'K1t': n, 'K1p': n, 'K2f': n, 'K2b': n} since the reset."""
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import harmonic as kh
  return {'K1f': kh.launches['fwd'], 'K1t': kh.launches['bwd_taps'],
          'K1p': kh.launches['bwd_phase'], 'K2f': kg.launches['fwd'],
          'K2b': kg.launches['bwd']}


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
  check(launches['K1t'] == launches['K1p'] == launches['K2b'] == 0,
        'serving launches no backward kernel')

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
  check(all(launches[k] == TRAIN_STEPS for k in ('K1f', 'K1t', 'K2f', 'K2b')),
        'K1f, K1t, K2f, K2b each launched once per training step')
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
    ir = 0.02 * torch.randn(REVERB_LENGTH,
                            generator=torch.Generator().manual_seed(6))
    ir *= torch.exp(-torch.arange(REVERB_LENGTH) / 8000.0)
    cpu_model.processor_group.reverb.ir.copy_(ir)
    gpu_model.processor_group.reverb.ir.copy_(ir)
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
  norm = lambda grads: float(torch.sqrt(sum(
      g.double().pow(2).sum() for g in grads.values())))
  norm_gpu, norm_cpu = norm(grads_gpu), norm(grads_cpu)
  print(f'  one step, B = 2: total_loss GPU {loss_gpu:.5f} CPU {loss_cpu:.5f}; '
        f'global gradient norm GPU {norm_gpu:.5f} CPU {norm_cpu:.5f}')
  check(abs(loss_gpu - loss_cpu) <= STEP_LOSS_RTOL * abs(loss_cpu),
        f'total_loss within {STEP_LOSS_RTOL} of the CPU port')
  check(abs(norm_gpu - norm_cpu) <= STEP_GRAD_NORM_RTOL * norm_cpu,
        f'global gradient norm within {STEP_GRAD_NORM_RTOL} of the CPU port')

  # Step time: whole steps between CUDA events, host included.
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
  return launches


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
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import harmonic as kh
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

  kernels = []
  # K1 at the training shape: 16 x 64000 samples, 1000 frames, 'window'.
  phase0, f0_env, ham = k1_inputs(torch, BATCH, N_FRAMES, 5, dev)
  g = torch.randn(phase0.shape, device=dev,
                  generator=torch.Generator(dev).manual_seed(9))
  ref = kh.harmonic_synthesis_plain(phase0, f0_env, ham, SR)
  err = (kh.fused_harmonic_synthesis(phase0, f0_env, ham, SR) -
         ref).abs().max().item()
  check(err <= K1_ATOL, f'K1f at the training shape within {K1_ATOL}')
  dham, dphase, ref_dham, ref_dphase = k1_backward(torch, phase0, f0_env,
                                                   ham, g, 'window')
  check(rel_err(dham, ref_dham) <= K1_BWD_RTOL and
        rel_err(dphase, ref_dphase) <= K1_BWD_RTOL,
        f'K1t and K1p at the training shape within {K1_BWD_RTOL}')
  dtaps = torch.empty((BATCH, N_FRAMES, 2, N_HARMONICS), device=dev)
  out = torch.empty_like(phase0)
  shape = (N_FRAMES, N_HARMONICS, SR, 'window')
  src = 'ddsp_torch/csrc/harmonic.cu'
  ref_src = 'ddsp_tpu/ops/pallas_kernels/harmonic.py'
  kernels.append(kernel_entry(
      torch, 'fused_harmonic_synthesis forward (K1f)', src, f'{ref_src}:191',
      launches['train']['K1f'], err,
      lambda: kh._launch('fwd', (phase0, f0_env, ham), out, *shape),
      lambda: kh.harmonic_synthesis_plain(phase0, f0_env, ham, SR),
      *k1_bound(torch, 'fwd', f0_env, ham), None, 50, 5))
  kernels.append(kernel_entry(
      torch, 'fused_harmonic_synthesis backward, taps (K1t)', src,
      f'{ref_src}:235', launches['train']['K1t'],
      (dham - ref_dham).abs().max().item(),
      lambda: kh._launch('bwd_taps', (phase0, f0_env, g), dtaps, *shape),
      lambda: kh.harmonic_bwd_taps_plain(phase0, f0_env, g, N_FRAMES,
                                         N_HARMONICS, SR),
      *k1_bound(torch, 'bwd_taps', f0_env, ham), None, 50, 5))
  kernels.append(kernel_entry(
      torch, 'fused_harmonic_synthesis backward, phase (K1p)', src,
      f'{ref_src}:272', launches['chain']['K1p'],
      (dphase - ref_dphase).abs().max().item(),
      lambda: kh._launch('bwd_phase', (phase0, f0_env, ham, g), out, *shape),
      lambda: kh.harmonic_bwd_phase_plain(phase0, f0_env, ham, g, SR),
      *k1_bound(torch, 'bwd_phase', f0_env, ham), None, 50, 5))

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
  lib_fwd, lib_bwd = library_gru_ms(torch, dev)
  src = 'ddsp_torch/csrc/gru.cu'
  ref_src = 'ddsp_tpu/ops/pallas_kernels/gru.py'
  kernels.append(kernel_entry(
      torch, 'gru_sequence forward (K2f)', src, f'{ref_src}:124',
      launches['train']['K2f'], err,
      lambda: kg._launch_fwd(xp, wh, bn32, h032),
      lambda: kg.gru_sequence_plain(xp, wh, bn, h0),
      *k2_bound(xp, wh, 'bfloat16'), lib_fwd, 10, 2))
  kernels.append(kernel_entry(
      torch, 'gru_sequence backward (K2b)', src, f'{ref_src}:152',
      launches['train']['K2b'],
      max((a.float() - b.float()).abs().max().item()
          for a, b in zip(got, want)),
      lambda: kg._launch_bwd(g2, xp, h_prev, wh, bn32),
      lambda: kg.gru_bwd_plain(g2, xp, h_prev, wh, bn),
      *k2_bound(xp, wh, 'bfloat16', backward=True), lib_bwd, 10, 2))
  # The serving shape (one request: B = 1) beside the training shape.
  p1, f1, a1 = k1_inputs(torch, 1, N_FRAMES, 5, dev)
  o1 = torch.empty_like(p1)
  kernels[0]['serving_ms'] = device_ms(
      torch, lambda: kh._launch('fwd', (p1, f1, a1), o1, *shape), 100)
  xp1, wh1, bn1, h01 = k2_inputs(torch, 1, torch.bfloat16, 6, dev)
  kernels[3]['serving_ms'] = device_ms(
      torch, lambda: kg._launch_fwd(xp1, wh1, bn1, h01), 20)
  # The backward kernels are held to a relative tolerance (their results
  # are sums whose scale grows with the hop, the harmonic number and T).
  kernels[1]['max_rel_err'] = rel_err(dham, ref_dham)
  kernels[2]['max_rel_err'] = rel_err(dphase, ref_dphase)
  kernels[4]['max_rel_err'] = max(errs)
  for k, key in zip(kernels, ('K1f', 'K1t', 'K1p', 'K2f', 'K2b')):
    k['launches_by_path'] = {path: run[key] for path, run in launches.items()}
    print(f"  {k['name']}: device {k['ms']:.4f} ms (per call with host "
          f"{k['call_ms']:.4f}), plain {k['plain_ms']:.4f} ms (per call "
          f"{k['plain_call_ms']:.4f}), bound {k['bound_ms']:.5f} ms "
          f"({k['bound_by']}), library {k['library_ms']}, launches "
          f"{k['launches']} {k['launches_by_path']}, max |err| "
          f"{k['max_abs_err']:.3e}"
          + (f" (relative {k['max_rel_err']:.3e})"
             if 'max_rel_err' in k else '')
          + (f", serving shape {k['serving_ms']:.4f} ms"
             if 'serving_ms' in k else ''))
  return kernels


def library_gru_ms(torch, dev):
  """(forward ms, backward ms) of torch.nn.GRU (cuDNN, float32) on the
  decoder's GRU at B = 16, T = 1000, as a yardstick only: it includes the
  input GEMM (and its backward) that the port hoists out of K2. Its output
  is checked against the port's float32 FastGRU first. The backward time is
  forward-and-backward minus forward."""
  from ddsp_torch.nn.layers import FastGRU
  in_dim = 2 * HIDDEN
  port_gru = FastGRU(in_dim, HIDDEN, compute_dtype='float32').to(dev)
  with torch.no_grad():
    port_gru.bi.normal_(0, 0.1)
    port_gru.bn.normal_(0, 0.1)
  lib = torch.nn.GRU(in_dim, HIDDEN, batch_first=True).to(dev)
  with torch.no_grad():
    lib.weight_ih_l0.copy_(port_gru.wi.t())
    lib.weight_hh_l0.copy_(port_gru.wh.t())
    lib.bias_ih_l0.copy_(port_gru.bi)
    lib.bias_hh_l0.zero_()
    lib.bias_hh_l0[2 * HIDDEN:].copy_(port_gru.bn)
    x = torch.randn((BATCH, N_FRAMES, in_dim), device=dev)
    err = (lib(x)[0] - port_gru(x)).abs().max().item()
    print(f'  torch.nn.GRU vs port FastGRU (float32): max |err| {err:.3e}')
    check(err <= K2_ATOL['float32'],
          'torch.nn.GRU yardstick computes the same GRU')
    fwd = device_ms(torch, lambda: lib(x), 3)

  def fwd_bwd():
    lib.zero_grad(set_to_none=True)
    lib(x)[0].pow(2).mean().backward()

  both = device_ms(torch, fwd_bwd, 3)
  return fwd, both - fwd


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--profile', action='store_true',
                      help='also print per-kernel device time over 3 requests '
                      'and over 3 training steps')
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
    phase_k2(torch, dev)
    phase_gradients_reach_parameters(torch, dev)
    with tempfile.TemporaryDirectory() as work_dir:
      write_export(torch, work_dir)
      port, reqs, launches['serve'] = phase_serve(torch, work_dir)
      launches['chain'], _ = phase_chain(torch, dev)
      launches['train'] = phase_train(torch, dev, work_dir, args.profile)
    kernels = phase_report(torch, port, reqs, launches, dev, args.profile)
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
