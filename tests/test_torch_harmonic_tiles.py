"""Kernel family K1 on the CPU: the port's plain path against the JAX
package, on the shapes and phases the redesigned kernels must handle, and a
pure-torch mirror of K1t's tiled summation order.

The CUDA kernels themselves (ddsp_torch/csrc/harmonic.cu) are held against
the plain versions on the card by chip_smoke.py. Here:

- the plain forward and backward against the Pallas kernels in interpret
  mode at B in {1, 3}, H in {13, 60}, hops 64 and 320, both methods;
- unwrapped phases near 1e4 rad (a training step's plain cumsum reaches
  that in 4 s), against a float64 golden and the Pallas kernel;
- hop 100, which the Pallas kernel refuses, against the jnp path;
- more than 128 harmonics (past the Pallas kernel's lanes), through the
  synth op, against the jnp path;
- a training step's own phase (4 s of plain cumsum), where the port's
  float64 wrap and the Pallas kernel's float32 one part by design;
- the float32 Chebyshev chain's error at 60, 160 and 256 harmonics;
- the endpoint frame of the fold;
- K1t's order: per-thread sums over 8 samples, a shuffle tree over lane
  groups, rows summed in order, the fold inside the kernel.

Tolerances, each with its reason:
- forward 4e-3 absolute: the JAX package's tolerance for its Pallas kernel
  against its jnp path (tests/test_pallas_harmonic.py);
- backward 5e-3 relative to the largest reference element: the same test's
  tolerance for the Pallas VJP, used by tests/test_torch_kernels.py;
- against the float64 golden on unwrapped phases, 1e-4 relative (backward)
  and 1e-3 absolute (forward): float32 sines of a phase wrapped in float64,
  summed over 64-320 samples or 60 harmonics; the golden takes its own
  tap weights (numpy's hann) and its own fold, not the port's;
- the Pallas kernel on unwrapped phases, 2e-2 relative: it wraps with
  float32's `%`, by float32(2 pi) = 2 pi + 1.75e-7, so after q ~ 1600
  turns harmonic h's phase is off by h * 2.8e-4 rad (up to 1.7e-2 at
  h = 60); that is the reference's own error, which the port's float64
  wrap (and the kernels' two-part wrap) does not have;
- the mirror against the plain version 1e-5 relative: the same float32
  products summed in another order, over at most 2 * 320 terms per output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import oscillator as j_osc
from ddsp_tpu.ops.pallas_kernels import fused_harmonic_synthesis
from ddsp_tpu.ops.resample import resample as j_resample
from ddsp_torch.kernels import harmonic as k_harmonic
from ddsp_torch.ops import oscillator as t_osc
from ddsp_torch.ops.resample import resample as t_resample

torch.set_num_threads(1)

SR = 16000
FWD_ATOL = 4e-3
BWD_RTOL = 5e-3


def _inputs(batch, n_frames, hop, n_harmonics, seed, offset=0.0):
  """phase0, f0_env [B, n] float32 and ham [B, F, H], from numpy.

  f0 spans 200-2200 Hz, so the Nyquist mask cuts harmonics for H = 13 and
  H = 60; `offset` starts the phase at that many radians (a plain cumsum's
  phase late in a clip)."""
  rng = np.random.RandomState(seed)
  f0 = (200.0 + 2000.0 * rng.rand(batch, n_frames, 1)).astype(np.float32)
  ham = (rng.rand(batch, n_frames, 1) *
         rng.rand(batch, n_frames, n_harmonics)).astype(np.float32)
  f0_env = np.array(j_resample(jnp.asarray(f0), n_frames * hop))[..., 0]
  phase0 = offset + np.cumsum(f0_env.astype(np.float64) * 2 * np.pi / SR,
                              axis=1)
  return phase0.astype(np.float32), f0_env, ham


def _cotangent(phase0, seed=1):
  return np.random.RandomState(seed).randn(*phase0.shape).astype(np.float32)


def _scaled_close(a, b, rtol, what):
  a = np.asarray(a, np.float64).ravel()
  b = np.asarray(b, np.float64).ravel()
  scale = max(np.abs(b).max(), 1e-12)
  np.testing.assert_allclose(a / scale, b / scale, atol=rtol, err_msg=what)


def _port(phase0, f0_env, ham, g, method):
  """audio, dphase, dham through the port's HarmonicSynthesis (CPU)."""
  p = torch.from_numpy(phase0).requires_grad_()
  a = torch.from_numpy(ham).requires_grad_()
  out = k_harmonic.fused_harmonic_synthesis(p, torch.from_numpy(f0_env), a,
                                            SR, method)
  dphase, dham = torch.autograd.grad(out, (p, a), torch.from_numpy(g))
  return out.detach().numpy(), dphase.numpy(), dham.numpy()


def _pallas(phase0, f0_env, ham, g, method):
  """audio, dphase, dham through the Pallas kernels in interpret mode."""
  out, vjp = jax.vjp(
      lambda p, a: fused_harmonic_synthesis(
          p, jnp.asarray(f0_env), a, sample_rate=SR,
          amp_resample_method=method, interpret=True),
      jnp.asarray(phase0), jnp.asarray(ham))
  dphase, dham = vjp(jnp.asarray(g))
  return np.asarray(out), np.asarray(dphase), np.asarray(dham)


def _golden(phase0, f0_env, ham, g, method):
  """audio and dham in float64 from the definition, sharing no code with
  the port: sin(h * phase0) of the float32 phase, the mask rule
  h < nyquist / f0, the 2-tap weights (the first and second halves of a
  periodic hann of 2 hop samples, or linear), and the fold of tap 1 of hop
  k onto frame k + 1 with the endpoint copy's share on the last frame."""
  batch, n_samples = phase0.shape
  n_frames, n_harmonics = ham.shape[1:]
  hop = n_samples // n_frames
  if method == 'window':
    win = np.hanning(2 * hop + 1)[:-1]  # periodic hann of length 2 hop
    rise, fall = win[:hop], win[hop:]
  else:
    rise = np.arange(hop) / hop
    fall = 1.0 - rise
  h = np.arange(1, n_harmonics + 1)
  hmax = np.float32(SR / 2) / np.maximum(f0_env, np.float32(1e-20))
  sins = np.sin(phase0.astype(np.float64)[..., None] * h) * (
      hmax[..., None] > h)
  sins = sins.reshape(batch, n_frames, hop, n_harmonics)
  ham_ext = np.concatenate([ham, ham[:, -1:]], axis=1).astype(np.float64)
  amps = (fall[None, None, :, None] * ham_ext[:, :-1, None] +
          rise[None, None, :, None] * ham_ext[:, 1:, None])
  audio = (amps * sins).sum(-1).reshape(batch, n_samples)
  gw = g.reshape(batch, n_frames, 1, hop).astype(np.float64) * np.stack(
      [fall, rise])[None, None]
  taps = np.matmul(gw, sins)  # [B, F, 2, H]
  dham = taps[:, :, 0].copy()
  dham[:, 1:] += taps[:, :-1, 1]
  dham[:, -1] += taps[:, -1, 1]
  return audio, dham


@pytest.mark.parametrize('method', ['window', 'linear'])
@pytest.mark.parametrize('hop,n_frames', [(64, 6), (320, 3)])
@pytest.mark.parametrize('batch,n_harmonics', [(1, 13), (3, 60), (1, 60),
                                               (3, 13)])
def test_plain_matches_pallas(method, hop, n_frames, batch, n_harmonics):
  phase0, f0_env, ham = _inputs(batch, n_frames, hop, n_harmonics,
                                seed=hop + n_harmonics + batch)
  assert (f0_env * n_harmonics >= SR / 2).any()  # the mask is exercised
  g = _cotangent(phase0)
  out_t, dphase_t, dham_t = _port(phase0, f0_env, ham, g, method)
  out_p, dphase_p, dham_p = _pallas(phase0, f0_env, ham, g, method)
  np.testing.assert_allclose(out_t, out_p, atol=FWD_ATOL)
  _scaled_close(dham_t, dham_p, BWD_RTOL, 'dham')
  _scaled_close(dphase_t, dphase_p, BWD_RTOL, 'dphase')


@pytest.mark.parametrize('method,hop,n_frames,n_harmonics',
                         [('window', 64, 6, 60), ('linear', 320, 3, 13)])
def test_unwrapped_phases(method, hop, n_frames, n_harmonics):
  phase0, f0_env, ham = _inputs(2, n_frames, hop, n_harmonics, seed=3,
                                offset=1e4)
  assert phase0.min() > 9e3
  g = _cotangent(phase0)
  gold_audio, gold_dham = _golden(phase0, f0_env, ham, g, method)
  # The backward directly: the plain taps wrap in float64.
  _, _, dham_t = _port(phase0, f0_env, ham, g, method)
  _, _, dham_p = _pallas(phase0, f0_env, ham, g, method)
  _scaled_close(dham_t, gold_dham, 1e-4, 'dham, port vs float64')
  _scaled_close(dham_p, gold_dham, 2e-2, 'dham, Pallas vs float64')
  _scaled_close(dham_t, dham_p, 2e-2, 'dham, port vs Pallas')
  # The forward, fed the phase wrapped in float64 (the plain forward takes
  # sin(h * phase) of the phase it is given, as the jnp path does, and
  # h * phase in float32 alone is off by ~1e-3 * h rad at 1e4 rad).
  wrapped = np.remainder(phase0.astype(np.float64), 2 * np.pi).astype(
      np.float32)
  out_t = k_harmonic.harmonic_synthesis_plain(
      torch.from_numpy(wrapped), torch.from_numpy(f0_env),
      torch.from_numpy(ham), SR, method).numpy()
  out_p, _, _ = _pallas(wrapped, f0_env, ham, g, method)
  np.testing.assert_allclose(out_t, out_p, atol=FWD_ATOL)
  np.testing.assert_allclose(out_t, gold_audio, atol=1e-3)


@pytest.mark.parametrize('method', ['window', 'linear'])
def test_hop_100_matches_the_jnp_path(method):
  """Hop 100 (gcd 4 with 128 lanes: the Pallas kernel refuses it) against
  the JAX package's jnp path and its VJP, on wrapped phases (angular
  cumsum) as serving accumulates them."""
  hop, n_frames, n_harmonics = 100, 20, 13
  rng = np.random.RandomState(7)
  f0 = (200.0 + 2000.0 * rng.rand(2, n_frames, 1)).astype(np.float32)
  ham = (rng.rand(2, n_frames, 1) *
         rng.rand(2, n_frames, n_harmonics)).astype(np.float32)
  n_samples = hop * n_frames
  f0_env = j_resample(jnp.asarray(f0), n_samples)
  phase0 = j_osc.angular_cumsum(f0_env * 2 * np.pi / SR)
  phase0, f0_env = np.array(phase0[..., 0]), np.array(f0_env[..., 0])
  assert phase0.max() < 2 * np.pi + 1  # wrapped as it accumulates
  g = _cotangent(phase0)
  out_j, vjp = jax.vjp(
      lambda hd: j_osc.harmonic_synthesis(
          jnp.asarray(f0), jnp.ones_like(jnp.asarray(f0)),
          harmonic_distribution=hd, n_samples=n_samples, sample_rate=SR,
          amp_resample_method=method, use_angular_cumsum=True,
          use_pallas=False), jnp.asarray(ham))
  (dham_j,) = vjp(jnp.asarray(g))
  out_t, _, dham_t = _port(phase0, f0_env, ham, g, method)
  np.testing.assert_allclose(out_t, np.asarray(out_j), atol=FWD_ATOL)
  _scaled_close(dham_t, dham_j, BWD_RTOL, 'dham')


def test_the_backward_wrap_on_a_training_phase():
  """The training step's own phase: a plain cumsum over 4 s of a gliding
  f0 (chip_smoke.py's training batch), up to ~7.5e3 rad. The port's
  backward wraps it by 2 pi (float64 in the plain version) and holds the
  float64 golden to 1e-4; the Pallas VJP wraps by float32(2 pi) and
  departs from both by its own error (the 2e-2 tier above). Run with -s to
  see the departure's size."""
  batch, n_frames, hop, n_harmonics = 2, 1000, 64, 60
  rng = np.random.RandomState(0)
  t = np.arange(n_frames) / 250.0
  f0 = 110.0 * 2.0**(2.0 * rng.rand(batch, 1) + 0.15 * np.sin(
      2 * np.pi * (0.5 + rng.rand(batch, 1)) * t[None]))
  f0_env = np.repeat(f0, hop, axis=1).astype(np.float32)
  phase0 = np.cumsum(f0_env.astype(np.float64) * 2 * np.pi / SR,
                     axis=1).astype(np.float32)
  assert phase0.max() > 5e3
  ham = rng.rand(batch, n_frames, n_harmonics).astype(np.float32)
  g = _cotangent(phase0)
  _, gold_dham = _golden(phase0, f0_env, ham, g, 'window')
  _, _, dham_t = _port(phase0, f0_env, ham, g, 'window')
  _, _, dham_p = _pallas(phase0, f0_env, ham, g, 'window')
  scale = np.abs(gold_dham).max()
  port_err = np.abs(dham_t - gold_dham).max() / scale
  pallas_err = np.abs(dham_p - gold_dham).max() / scale
  departure = np.abs(dham_t - dham_p).max() / scale
  print(f'dham on a training phase (max {phase0.max():.1f} rad), relative '
        f'to its largest element: port vs float64 {port_err:.3e}, Pallas '
        f'vs float64 {pallas_err:.3e}, port vs Pallas {departure:.3e}')
  assert port_err <= 1e-4
  assert pallas_err <= 2e-2 and departure <= 2e-2


@pytest.mark.parametrize('method', ['window', 'linear'])
def test_more_than_128_harmonics_match_the_jnp_path(method):
  """150 harmonics (past the Pallas kernel's 128 lanes, so the JAX
  package takes its jnp path) through the port's synth op, which routes
  them to K1 as any other count; f0 from 30 Hz, so harmonics past 128 are
  audible and the Nyquist mask cuts the rest."""
  hop, n_frames, n_harmonics = 64, 8, 150
  rng = np.random.RandomState(13)
  f0 = (30.0 + 200.0 * rng.rand(2, n_frames, 1)).astype(np.float32)
  amps = rng.rand(2, n_frames, 1).astype(np.float32)
  hd = rng.rand(2, n_frames, n_harmonics).astype(np.float32)
  n_samples = hop * n_frames
  assert (f0 * 129 < SR / 2).any() and (f0 * n_harmonics >= SR / 2).any()
  kwargs = dict(n_samples=n_samples, sample_rate=SR,
                amp_resample_method=method, use_angular_cumsum=True)
  out_j, vjp = jax.vjp(
      lambda d: j_osc.harmonic_synthesis(jnp.asarray(f0), jnp.asarray(amps),
                                         harmonic_distribution=d,
                                         use_pallas=False, **kwargs),
      jnp.asarray(hd))
  g = _cotangent(np.asarray(out_j))
  (dhd_j,) = vjp(jnp.asarray(g))
  d = torch.from_numpy(hd).requires_grad_()
  out_t = t_osc.harmonic_synthesis(torch.from_numpy(f0),
                                   torch.from_numpy(amps),
                                   harmonic_distribution=d, **kwargs)
  (dhd_t,) = torch.autograd.grad(out_t, (d,), torch.from_numpy(g))
  np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                             atol=FWD_ATOL)
  _scaled_close(dhd_t.numpy(), dhd_j, BWD_RTOL, 'dhd')


@pytest.mark.parametrize('n_harmonics,f0_lo', [(60, 80.0), (160, 30.0),
                                                (256, 30.0)])
def test_the_float32_chain_error_grows_with_harmonics(n_harmonics, f0_lo):
  """K1f's forward in torch: the float32 Chebyshev chain (the Pallas
  kernel's, and the kernels' own) against the plain forward's sinf, on
  chip_smoke.py's K1 data at 16 x 4 s / 8 (2 rows of 64000 samples, hop
  64, f0 from f0_lo to 20 f0_lo Hz, amplitudes ~0.25 a harmonic, plain
  cumsum phases wrapped in float64). cos(phi) rounded to float32 shifts
  the chain's angle by up to ~6e-8 / |sin phi|, which harmonic h
  multiplies by h, so the absolute error grows ~H^2: K1_ATOL (4e-3) holds
  at 60 harmonics, and past 128 the error stays under 2e-3 of the audio's
  largest sample (chip_smoke.py's tier for those cases). Run with -s to
  see both errors."""
  batch, n_frames, hop = 2, 1000, 64
  rng = np.random.RandomState(n_harmonics)
  f0 = (f0_lo * 20.0**rng.rand(batch, n_frames, 1)).astype(np.float32)
  ham = torch.from_numpy((rng.rand(batch, n_frames, 1) * rng.rand(
      batch, n_frames, n_harmonics)).astype(np.float32))
  f0_env = np.array(j_resample(jnp.asarray(f0), n_frames * hop))[..., 0]
  phase0 = np.cumsum(f0_env.astype(np.float64) * 2 * np.pi / SR, axis=1)
  phase = torch.from_numpy(np.remainder(phase0, 2 * np.pi).astype(
      np.float32))
  f0_env = torch.from_numpy(f0_env)
  ref = k_harmonic.harmonic_synthesis_plain(phase, f0_env, ham, SR)
  amps = t_resample(ham, n_frames * hop, method='window')
  hmax = torch.full_like(f0_env, SR / 2.0) / f0_env
  s_cur, two_c = torch.sin(phase), 2.0 * torch.cos(phase)
  s_prev = torch.zeros_like(phase)
  chain = torch.zeros_like(phase)
  for h in range(1, n_harmonics + 1):
    chain = chain + torch.where(hmax > h, amps[..., h - 1] * s_cur,
                                torch.zeros_like(s_cur))
    s_cur, s_prev = two_c * s_cur - s_prev, s_cur
  abs_err = (chain - ref).abs().max().item()
  rel_err = abs_err / ref.abs().max().item()
  print(f'H = {n_harmonics}, f0 from {f0_lo} Hz: float32 chain vs sinf, '
        f'max |err| {abs_err:.3e}, relative {rel_err:.3e}')
  if n_harmonics <= 128:
    assert abs_err <= FWD_ATOL
  assert rel_err <= 2e-3


def test_the_endpoint_frame():
  """The last frame gets tap 0 of the last hop, tap 1 of the hop before,
  and tap 1 of the last hop (the endpoint copy's share), as the Pallas
  VJP folds it; no other frame gets the endpoint's share."""
  phase0, f0_env, ham = _inputs(1, 4, 64, 13, seed=11)
  g = _cotangent(phase0)
  taps = k_harmonic.harmonic_bwd_taps_plain(
      torch.from_numpy(phase0), torch.from_numpy(f0_env),
      torch.from_numpy(g), 4, 13, SR, 'window')
  _, _, dham_t = _port(phase0, f0_env, ham, g, 'window')
  _, _, dham_p = _pallas(phase0, f0_env, ham, g, 'window')
  last = (taps[:, -1, 0] + taps[:, -2, 1]) + taps[:, -1, 1]
  np.testing.assert_array_equal(dham_t[:, -1], last.numpy())
  np.testing.assert_array_equal(
      dham_t[:, 1:-1], (taps[:, 1:-1, 0] + taps[:, :-2, 1]).numpy())
  assert np.abs(taps[:, -1, 1].numpy()).max() > 0
  _scaled_close(dham_t[:, -1], dham_p[:, -1], BWD_RTOL, 'last frame')


def _tree(x, lanes):
  """K1t's shuffle reduce-scatter over an aligned group of `lanes`
  (last axis): lane l adds lane l ^ w for w = lanes / 2, ..., 1."""
  while lanes > 1:
    lanes //= 2
    x = x[..., :lanes] + x[..., lanes:]
  return x[..., 0]


def _tiled_taps_mirror(phase0, f0_env, g, n_frames, n_harmonics, method,
                       samples=8, threads=128):
  """dham in K1t's summation order, in torch (float32).

  A hop of `hop` samples is split over P = min(threads, ceil(hop / 8))
  threads; thread p takes samples d = pass * P * 8 + p + P * i. Each thread
  sums its samples' weighted, masked Chebyshev sines in order of i; lane
  groups of L (the largest of 8, 4, 2, 1 dividing P) add by a shuffle
  tree; each group's row adds its passes in order; a hop's rows are summed
  in order; the fold puts tap 1 of hop k on frame k + 1 and the endpoint's
  share on the last frame.
  """
  batch, n_samples = phase0.shape
  hop = n_samples // n_frames
  n_threads = min(threads, -(-hop // samples))
  passes = -(-hop // (n_threads * samples))
  lanes = next(l for l in (8, 4, 2, 1) if n_threads % l == 0)
  phase = torch.remainder(phase0.double(), 2 * np.pi).float()
  two_c, s_cur = 2.0 * torch.cos(phase), torch.sin(phase)
  s_prev = torch.zeros_like(phase)
  hmax = torch.full_like(f0_env, SR / 2.0) / torch.clamp(f0_env, min=1e-20)
  n_aud = torch.where(hmax > n_harmonics, torch.tensor(float(n_harmonics)),
                      torch.clamp(torch.ceil(hmax) - 1, min=0))
  sins = []
  for h in range(n_harmonics):
    sins.append(torch.where(h < n_aud, s_cur, torch.zeros_like(s_cur)))
    s_cur, s_prev = two_c * s_cur - s_prev, s_cur
  sins = torch.stack(sins, -1).reshape(batch, n_frames, hop, n_harmonics)
  weights = k_harmonic._tap_weights(hop, method, phase0.device)
  gw = g.reshape(batch, n_frames, 1, hop) * weights[None, None]
  # Zero-padded sample slots, laid out [passes, i, p] as the threads read.
  slots = passes * samples * n_threads
  gw = torch.nn.functional.pad(gw, (0, slots - hop)).reshape(
      batch, n_frames, 2, passes, samples, n_threads)
  sins = torch.nn.functional.pad(sins, (0, 0, 0, slots - hop)).reshape(
      batch, n_frames, 1, passes, samples, n_threads, n_harmonics)
  per_thread = torch.zeros(batch, n_frames, 2, passes, n_threads,
                           n_harmonics)
  for i in range(samples):
    per_thread = per_thread + gw[:, :, :, :, i, :, None] * sins[:, :, :, :, i]
  groups = per_thread.reshape(batch, n_frames, 2, passes,
                              n_threads // lanes, lanes, n_harmonics)
  rows = _tree(groups.movedim(-2, -1), lanes)  # [B, F, 2, passes, rows, H]
  row_sums = rows[:, :, :, 0]
  for ps in range(1, passes):
    row_sums = row_sums + rows[:, :, :, ps]
  taps = torch.zeros(batch, n_frames, 2, n_harmonics)
  for q in range(row_sums.shape[3]):
    taps = taps + row_sums[:, :, :, q]
  return k_harmonic.fold_taps(taps)


@pytest.mark.parametrize('method,hop,n_frames,n_harmonics', [
    ('window', 64, 6, 60),    # P = 8: one shuffle group of 8 lanes a hop
    ('linear', 320, 3, 13),   # P = 40: five groups a hop
    ('window', 100, 5, 13),   # P = 13: no shuffles, 13 rows a hop
    ('linear', 1100, 2, 6),   # P = 128, two passes
    ('window', 12, 10, 60),   # P = 2: a group of 2 lanes
])
def test_tiled_taps_mirror_matches_the_plain_version(method, hop, n_frames,
                                                     n_harmonics):
  phase0, f0_env, _ = _inputs(2, n_frames, hop, n_harmonics, seed=hop,
                              offset=1e4)
  g = torch.from_numpy(_cotangent(phase0))
  phase0, f0_env = torch.from_numpy(phase0), torch.from_numpy(f0_env)
  got = _tiled_taps_mirror(phase0, f0_env, g, n_frames, n_harmonics, method)
  want = k_harmonic.fold_taps(k_harmonic.harmonic_bwd_taps_plain(
      phase0, f0_env, g, n_frames, n_harmonics, SR, method))
  _scaled_close(got.numpy(), want.numpy(), 1e-5, 'mirror vs plain')


@pytest.mark.parametrize('method,hop,n_frames', [('window', 64, 6),
                                                 ('linear', 320, 3)])
def test_tiled_taps_mirror_matches_the_pallas_vjp(method, hop, n_frames):
  phase0, f0_env, ham = _inputs(3, n_frames, hop, 60, seed=5)
  g = _cotangent(phase0)
  got = _tiled_taps_mirror(torch.from_numpy(phase0),
                           torch.from_numpy(f0_env), torch.from_numpy(g),
                           n_frames, 60, method)
  _, _, dham_p = _pallas(phase0, f0_env, ham, g, method)
  _scaled_close(got.numpy(), dham_p, BWD_RTOL, 'mirror vs Pallas VJP')
