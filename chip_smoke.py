#!/usr/bin/env python3
"""Drive the ddsp_torch port on one NVIDIA GPU: build, check, serve, report.

Run from the repository root on a machine with a CUDA GPU and nvcc:

    python3 chip_smoke.py            # what the acceptance check runs
    python3 chip_smoke.py --profile  # also print a per-kernel breakdown

Phases (any failed check exits non-zero before the result lines):
  1. build the kernels of ddsp_torch/csrc with nvcc (all sources at once);
  2. K1 (fused harmonic synth) against its plain PyTorch version;
  3. K2 (fused GRU sequence) against its plain PyTorch version;
  4. serve 4 requests of 4 s through the full-width solo_instrument
     autoencoder (AutoencoderInference on a params-format export), check the
     audio, and check that K1 and K2 carried the path;
  5. report per-request time, the kernels line and the device line.

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
K1_ATOL = 4e-3
K2_ATOL = {'float32': 1e-4, 'bfloat16': 5e-2}
E2E_REL_L2 = 5e-2


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
  copies and fills it launched (torch.profiler), without host overhead."""
  from torch.profiler import ProfilerActivity, profile
  for _ in range(warmup):
    fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(iters):
      fn()
    torch.cuda.synchronize()
  rows = device_rows(prof)
  if not rows:
    raise CheckFailed('torch.profiler recorded no device time')
  return sum(r[0] for r in rows) / iters


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


def k1_bound(torch, phase0, f0_env, ham):
  """Least time for K1's work on these inputs: bytes vs fp32 operations.

  Bytes: phase, f0 read and audio written (12 B per sample) plus the frame
  amplitudes. Operations: 6 per sample per harmonic below Nyquist (the
  kernel stops at the first muted harmonic, so count this data's share).
  """
  n_bytes = 4 * (3 * phase0.numel() + ham.numel())
  hmax = (SR / 2.0) / torch.clamp(f0_env, min=1e-20)
  active = torch.clamp(torch.ceil(hmax) - 1, 0, ham.shape[-1]).sum().item()
  ops = 6.0 * active
  t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS['float32']
  return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def k2_inputs(torch, batch, dtype, seed, dev):
  g = torch.Generator(dev).manual_seed(seed)
  xp = 0.5 * torch.randn((N_FRAMES, batch, 3 * HIDDEN), generator=g,
                         device=dev)
  wh = torch.randn((HIDDEN, 3 * HIDDEN), generator=g, device=dev) / np.sqrt(
      HIDDEN)
  bn = 0.1 * torch.randn((HIDDEN,), generator=g, device=dev)
  h0 = 0.1 * torch.randn((batch, HIDDEN), generator=g, device=dev)
  return xp.to(dtype), wh.to(dtype), bn, h0


def k2_bound(xp, wh, dtype_name):
  """Least time for K2's work: bytes (xp, wh, bn, h0 in; ys out) vs the
  recurrent dots and gates at the peak rate of the operands' type."""
  seq_len, batch, three_h = xp.shape
  hidden = three_h // 3
  n_bytes = (xp.numel() * xp.element_size() + wh.numel() * wh.element_size()
             + 4 * (hidden + batch * hidden + seq_len * batch * hidden))
  ops = seq_len * batch * (2.0 * hidden * three_h + 12.0 * hidden)
  t_bytes, t_ops = n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype_name]
  return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


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


def phase_k1(torch, dev):
  from ddsp_torch.kernels import harmonic as kh
  print('[2] K1 fused harmonic synth vs plain', flush=True)
  # Hop 64 is the serving shape; 320 the VST hop; 32 and 128 bracket them.
  for method, n_frames in (('window', N_FRAMES), ('linear', N_SAMPLES // 320),
                           ('window', N_SAMPLES // 32),
                           ('linear', N_SAMPLES // 128)):
    phase0, f0_env, ham = k1_inputs(torch, 4, n_frames, 1, dev)
    out = kh.fused_harmonic_synthesis(phase0, f0_env, ham, SR, method)
    ref = kh.harmonic_synthesis_plain(phase0, f0_env, ham, SR, method)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    print(f'  {method} hop {N_SAMPLES // n_frames}: max |err| {err:.3e} '
          f'(atol {K1_ATOL})')
    check(torch.isfinite(out).all().item() and err <= K1_ATOL,
          f'K1 {method} hop {N_SAMPLES // n_frames} within {K1_ATOL}')


def phase_k2(torch, dev):
  from ddsp_torch.kernels import gru as kg
  print('[3] K2 fused GRU vs plain', flush=True)
  for name, dtype in (('float32', torch.float32),
                      ('bfloat16', torch.bfloat16)):
    xp, wh, bn, h0 = k2_inputs(torch, 4, dtype, 2, dev)
    ys = kg.gru_sequence(xp, wh, bn, h0)
    ref = kg.gru_sequence_plain(xp, wh, bn, h0)
    torch.cuda.synchronize()
    err = (ys - ref).abs().max().item()
    print(f'  {name}: max |err| {err:.3e} (atol {K2_ATOL[name]})')
    check(torch.isfinite(ys).all().item() and err <= K2_ATOL[name],
          f'K2 {name} within {K2_ATOL[name]}')


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
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import harmonic as kh
  print('[4] serve solo_instrument (full width, 48000-tap reverb)', flush=True)
  port = AutoencoderInference(export_dir, length_seconds=4,
                              remove_reverb=False)
  reqs = requests()
  kh.launches = 0
  kg.launches = 0
  audio = [port.get_audio(r) for r in reqs]
  torch.cuda.synchronize()
  launches = {'harmonic': kh.launches, 'gru': kg.launches}
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
  check(launches['harmonic'] >= 4 and launches['gru'] >= 4,
        'K1 and K2 each launched >= 4 times on the serving path')

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


def phase_report(torch, port, reqs, launches, dev, profile):
  from ddsp_torch.kernels import gru as kg
  from ddsp_torch.kernels import harmonic as kh
  print('[5] report', flush=True)
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
    profile_requests(torch, port, reqs, median_ms)

  kernels = []
  # K1 at the serving shape: one request, 64000 samples, 1000 frames.
  phase0, f0_env, ham = k1_inputs(torch, 1, N_FRAMES, 5, dev)
  err = (kh.fused_harmonic_synthesis(phase0, f0_env, ham, SR) -
         kh.harmonic_synthesis_plain(phase0, f0_env, ham, SR)).abs().max()
  check(err.item() <= K1_ATOL, f'K1 at the serving shape within {K1_ATOL}')
  bound_ms, bound_by = k1_bound(torch, phase0, f0_env, ham)
  k1 = lambda: kh.fused_harmonic_synthesis(phase0, f0_env, ham, SR)
  k1_plain = lambda: kh.harmonic_synthesis_plain(phase0, f0_env, ham, SR)
  kernels.append({
      'name': 'fused_harmonic_synthesis (K1 fwd)', 'route': 'cuda',
      'source': 'ddsp_torch/csrc/harmonic.cu',
      'replaces': 'ddsp_tpu/ops/pallas_kernels/harmonic.py:191',
      'launches': launches['harmonic'], 'max_abs_err': err.item(),
      'ms': device_ms(torch, k1, 100),
      'plain_ms': device_ms(torch, k1_plain, 20),
      'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
      'call_ms': cuda_ms(torch, k1, 100),
      'plain_call_ms': cuda_ms(torch, k1_plain, 20)})

  # K2 at the serving shape: B=1, T=1000, H=512, bf16 streams.
  xp, wh, bn, h0 = k2_inputs(torch, 1, torch.bfloat16, 6, dev)
  err = (kg.gru_sequence(xp, wh, bn, h0) -
         kg.gru_sequence_plain(xp, wh, bn, h0)).abs().max()
  check(err.item() <= K2_ATOL['bfloat16'],
        f"K2 at the serving shape within {K2_ATOL['bfloat16']}")
  bound_ms, bound_by = k2_bound(xp, wh, 'bfloat16')
  k2 = lambda: kg.gru_sequence(xp, wh, bn, h0)
  k2_plain = lambda: kg.gru_sequence_plain(xp, wh, bn, h0)
  kernels.append({
      'name': 'gru_sequence (K2 fwd)', 'route': 'cuda',
      'source': 'ddsp_torch/csrc/gru.cu',
      'replaces': 'ddsp_tpu/ops/pallas_kernels/gru.py:124',
      'launches': launches['gru'], 'max_abs_err': err.item(),
      'ms': device_ms(torch, k2, 20),
      'plain_ms': device_ms(torch, k2_plain, 3, warmup=1),
      'bound_ms': bound_ms, 'bound_by': bound_by,
      'library_ms': library_gru_ms(torch, dev),
      'call_ms': cuda_ms(torch, k2, 20),
      'plain_call_ms': cuda_ms(torch, k2_plain, 3, warmup=1)})
  for k in kernels:
    print(f"  {k['name']}: device {k['ms']:.4f} ms (per call with host "
          f"{k['call_ms']:.4f}), plain {k['plain_ms']:.4f} ms (per call "
          f"{k['plain_call_ms']:.4f}), bound {k['bound_ms']:.5f} ms "
          f"({k['bound_by']}), library {k['library_ms']}, launches "
          f"{k['launches']}")
  return kernels


def library_gru_ms(torch, dev):
  """torch.nn.GRU (cuDNN, float32) on the decoder's GRU at B=1, T=1000, as a
  yardstick only: it includes the input GEMM that the port hoists out of K2.
  Its output is checked against the port's float32 FastGRU first."""
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
    x = torch.randn((1, N_FRAMES, in_dim), device=dev)
    err = (lib(x)[0] - port_gru(x)).abs().max().item()
    print(f'  torch.nn.GRU vs port FastGRU (float32): max |err| {err:.3e}')
    check(err <= K2_ATOL['float32'],
          'torch.nn.GRU yardstick computes the same GRU')
    return device_ms(torch, lambda: lib(x), 20)


def profile_requests(torch, port, reqs, median_ms):
  """Device time by kernel over 3 requests (torch.profiler)."""
  from torch.profiler import ProfilerActivity, profile
  for r in reqs[1:3]:
    port.get_audio(r)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for r in reqs[1:4]:
      port.get_audio(r)
    torch.cuda.synchronize()
  rows = device_rows(p)
  busy_ms = sum(r[0] for r in rows) / 3
  print(f'  profile: device busy {busy_ms:.3f} ms per request, '
        f'{100 * busy_ms / median_ms:.1f}% of the median request time')
  for ms, count, key in rows[:15]:
    print(f'    {ms / 3:8.4f} ms/request  x{count // 3:<4d} {key[:80]}')


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--profile', action='store_true',
                      help='also print per-kernel device time over 3 requests')
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
  try:
    phase_build()
    phase_k1(torch, dev)
    phase_k2(torch, dev)
    with tempfile.TemporaryDirectory() as export_dir:
      write_export(torch, export_dir)
      port, reqs, launches = phase_serve(torch, export_dir)
    kernels = phase_report(torch, port, reqs, launches, dev, args.profile)
  except CheckFailed as e:
    print(f'chip_smoke: check failed: {e}', file=sys.stderr)
    return 1
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, check=True).stdout.strip().splitlines()[0]
  print(smi)
  print(json.dumps({'kernels': kernels}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
