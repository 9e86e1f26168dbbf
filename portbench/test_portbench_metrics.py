"""The benchmark's arithmetic on fixed inputs: rates, the tail, roofline
bounds, mfu, the idle share and the attribution of device time to ops."""

import math

import numpy as np
import pytest
import torch

from portbench.harness import cells, check, roofline, stats, trace
from portbench.reference import solo_instrument


def _trace():
  """A window of 1000 us: two kernels launched under a gru_fwd op on the
  main thread (100 and 50 us), one outside it (200 us), a copy (50 us)."""
  x = lambda cat, name, ts, dur, tid=1, corr=None: {
      'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur, 'tid': tid,
      'args': {} if corr is None else {'correlation': corr}}
  return trace.Trace([
      x('user_annotation', 'window', 0, 1000),
      x('user_annotation', 'train_step', 10, 900),
      x('cpu_op', 'ddsp_torch::gru_fwd', 20, 30),
      x('cpu_op', 'ddsp_torch::gru_fwd', 25, 5),  # nested: one call
      x('cuda_runtime', 'cudaLaunchKernelExC', 22, 2, corr=1),
      x('cuda_driver', 'cuLaunchKernel', 40, 2, corr=2),
      x('cuda_runtime', 'cudaLaunchKernel', 60, 2, corr=3),
      x('cuda_runtime', 'cudaMemcpyAsync', 70, 2, corr=4),
      x('kernel', 'gru_fwd_kernel', 100, 100, tid=7, corr=1),
      x('kernel', 'gru_pad', 150, 50, tid=7, corr=2),
      x('kernel', 'elementwise', 300, 200, tid=7, corr=3),
      x('gpu_memcpy', 'Memcpy DtoH', 600, 50, tid=7, corr=4),
  ])


def test_busy_idle_and_breakdown():
  tr = _trace()
  assert tr.window_s == pytest.approx(1e-3)
  assert tr.busy_s() == pytest.approx(350e-6)  # 100-200, 300-500, 600-650
  # 350 us busy in 2 traced steps; the untraced window took 0.5 ms a step.
  reader = cells.metric_reader('device_idle_pct.train')
  record = {'trace': tr, 'steps': 2, 'window_steps': 10, 'window_s': 5e-3}
  assert reader(record) == pytest.approx(100.0 * (1 - 175e-6 / 5e-4))
  render = cells.metric_reader('device_idle_pct.render')
  record = {'trace': tr, 'traced_audio_s': 2.0, 'window_audio_s': 3000.0,
            'window_s': 2.0}
  assert render(record) == pytest.approx(100.0 * (1 - 175e-6 * 1500.0))
  gaps = dict(tr.idle_gaps())
  assert gaps['train_step'] == pytest.approx(550e-6)
  assert gaps['outside'] == pytest.approx(100e-6)
  assert tr.device_ops()[0] == ['elementwise', pytest.approx(200e-6)]


def test_launches_and_op_attribution():
  tr = _trace()
  assert tr.n_launches() == 3
  calls, seconds = tr.op_device_s(['ddsp_torch::gru_fwd'])
  assert (calls, seconds) == (1, pytest.approx(150e-6))
  assert tr.op_device_s(['ddsp_torch::gru_bwd']) == (0, 0.0)


def test_k2_bound_matches_its_count():
  # forward, B = 32, T = 1000, H = 512, bf16: operations bound.
  rows = 32 * 1000
  ops = rows * (2.0 * 512 * 1536 + 12.0 * 512)
  assert roofline.k2_bound_s('fwd', 1000, 32, 512, 'bfloat16') == (
      pytest.approx(ops / 989e12))
  assert roofline.k2_bwd_bound_s(1000, 32, 512, 'bfloat16') > (
      roofline.k2_bound_s('fwd', 1000, 32, 512, 'bfloat16'))


def test_k1_active_and_bound():
  # 1000 Hz throughout: harmonics 1..7 lie below 8 kHz (8 is at Nyquist).
  f0 = np.full((2, 10), 1000.0)
  assert roofline.k1_active(f0, 640, 60, 16000) == 2 * 640 * 7
  least = roofline.k1_bound_s('fwd', 2, 640, 10, 60, 2 * 640 * 7)
  n_bytes = 4 * (3 * 2 * 640 + 2 * 10 * 60)
  assert least == pytest.approx(max(n_bytes / 3.35e12,
                                    6.0 * 2 * 640 * 7 / 67e12))


def test_share_and_mfu():
  assert roofline.share_pct([1e-3, 1e-3], 4e-3) == pytest.approx(50.0)
  assert roofline.share_pct([1e-3], 0.0) is None
  cfg = {'ch': 512, 'rnn_channels': 512, 'layers_per_stack': 3,
         'n_harmonics': 60, 'n_noise_magnitudes': 65, 'time_steps': 1000}
  macs = (2 * (512 + 2 * 512 * 512) + 1024 * 1536 + 512 * 1536 +
          (1536 * 512 + 2 * 512 * 512) + 512 * 126)
  flops = solo_instrument.step_flops(cfg, 32, 1000)
  assert flops == 3 * 2.0 * macs * 32 * 1000
  record = {'window_steps': 10, 'window_s': 2.0, 'step_flops': flops,
            'config': {'peak_dtype': 'bfloat16'}}
  assert cells.metric_reader('mfu_pct.train')(record) == pytest.approx(
      100.0 * flops * 10 / (2.0 * 989e12))


def test_tail_and_distances():
  values = list(range(1, 101))
  assert stats.p95(values) == pytest.approx(95.05)
  a = torch.tensor([3.0, 4.0])
  assert stats.rel_l2(a * 1.01, a) == pytest.approx(0.01)
  tone = torch.sin(torch.arange(8192.0) * 0.3)
  assert stats.spectrum_gap(tone * 1.02, tone) == pytest.approx(0.02)
  # A shift of phase moves the waveform, not the spectrum's magnitudes.
  shifted = torch.sin(torch.arange(8192.0) * 0.3 + 0.5)
  assert stats.spectrum_gap(shifted, tone) < 0.01 < stats.rel_l2(shifted,
                                                                  tone)


def test_gaps_and_verdict():
  assert check.loss_gap(1.01, 1.0) == pytest.approx(0.01)
  ref = {'a': 1.0, 'b': 2.0, 'c': 1e-6}
  prog = {'a': 1.1, 'b': 2.4, 'c': 2e-6}
  # c's own norm is tiny: its gap is measured against the median leaf's.
  assert check.leaf_gaps(prog, ref, list(ref)) == pytest.approx(
      [0.1, 0.2, 1e-6])
  assert check.median_leaf_gap(prog, ref, list(ref)) == pytest.approx(0.1)
  assert check.moving_leaves(ref) == ['a', 'b']
  assert check.verdict({'x': 0.1}, {'x': 0.2})
  assert not check.verdict({'x': 0.3}, {'x': 0.2})
  assert not check.verdict({'x': math.nan}, {'x': 0.2})
  assert not check.verdict({}, {'x': 0.2})
