"""ddsp_torch.ops.spectral against ddsp_tpu.ops.spectral, on the CPU.

Same numpy inputs through both; the JAX side takes its jnp.fft branch off
the TPU (use_matmul=False is passed where it has the switch). Tolerances:
complex STFT and magnitudes atol 2e-4 on values up to ~1e2 (float32 FFTs of
two libraries), log magnitudes atol 2e-3 where the magnitude is above 1e-3,
loudness and power in dB atol 2e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.ops import core as j_core
from ddsp_tpu.ops import spectral as j_spectral
from ddsp_torch.ops import core as t_core
from ddsp_torch.ops import spectral as t_spectral

torch.set_num_threads(1)


def _audio(batch=2, n=4000, seed=0):
  rng = np.random.RandomState(seed)
  t = np.arange(n) / 16000.0
  tone = 0.4 * np.sin(2 * np.pi * 440.0 * t)[None] * rng.rand(batch, 1)
  return (tone + 0.05 * rng.randn(batch, n)).astype(np.float32)


@pytest.mark.parametrize('pad_end', [True, False])
@pytest.mark.parametrize('frame_size', [256, 300, 2048])
def test_stft_and_mag(frame_size, pad_end):
  x = _audio()
  s_t = t_spectral.stft(torch.from_numpy(x), frame_size, 0.75, pad_end)
  s_j = np.asarray(j_spectral.stft(jnp.asarray(x), frame_size, 0.75, pad_end))
  assert tuple(s_t.shape) == s_j.shape
  np.testing.assert_allclose(s_t.numpy(), s_j, atol=2e-4)
  mag_t = t_spectral.compute_mag(torch.from_numpy(x), frame_size,
                                 pad_end=pad_end)
  mag_j = np.asarray(j_spectral.compute_mag(jnp.asarray(x), frame_size,
                                            pad_end=pad_end))
  assert mag_t.dtype == torch.float32
  np.testing.assert_allclose(mag_t.numpy(), mag_j, atol=2e-4)


def test_stft_takes_1d_and_trailing_channel():
  x = _audio(batch=1)
  ref = t_spectral.stft(torch.from_numpy(x), 256)
  torch.testing.assert_close(t_spectral.stft(torch.from_numpy(x[0]), 256),
                             ref[0])
  torch.testing.assert_close(
      t_spectral.stft(torch.from_numpy(x[:, :, None]), 256), ref)


@pytest.mark.parametrize('size', [64, 512])
def test_logmag(size):
  x = _audio(seed=3)
  out_t = t_spectral.compute_logmag(torch.from_numpy(x), size).numpy()
  out_j = np.asarray(j_spectral.compute_logmag(jnp.asarray(x), size))
  loud = np.asarray(j_spectral.compute_mag(jnp.asarray(x), size)) > 1e-3
  assert loud.mean() > 0.9
  np.testing.assert_allclose(out_t[loud], out_j[loud], atol=2e-3)


@pytest.mark.parametrize('padding', ['center', 'same', 'valid'])
@pytest.mark.parametrize('n_fft', [512, 300])
def test_loudness(padding, n_fft):
  x = _audio(seed=4)
  out_t = t_spectral.compute_loudness(torch.from_numpy(x), n_fft=n_fft,
                                      padding=padding)
  out_j = np.asarray(j_spectral.compute_loudness(
      jnp.asarray(x), n_fft=n_fft, padding=padding, use_matmul=False))
  assert tuple(out_t.shape) == out_j.shape
  assert out_j.min() > -79.0  # above the floor: the comparison is live
  np.testing.assert_allclose(out_t.numpy(), out_j, atol=2e-3)
  one = t_spectral.compute_loudness(torch.from_numpy(x[0]), n_fft=n_fft,
                                    padding=padding)
  np.testing.assert_allclose(one.numpy(), out_j[0], atol=2e-3)


def test_loudness_floor_and_gradient():
  silent = t_spectral.compute_loudness(torch.zeros(1, 2000))
  assert float(silent.max()) == -t_core.DB_RANGE
  x = torch.from_numpy(_audio(batch=1, n=2000)).requires_grad_()
  t_spectral.compute_loudness(x).sum().backward()
  assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0


@pytest.mark.parametrize('padding', ['center', 'same', 'valid'])
def test_power_and_rms(padding):
  x = _audio(seed=5)
  rms_t = t_spectral.compute_rms_energy(torch.from_numpy(x), frame_size=256,
                                        padding=padding)
  rms_j = j_spectral.compute_rms_energy(jnp.asarray(x), frame_size=256,
                                        padding=padding)
  np.testing.assert_allclose(rms_t.numpy(), np.asarray(rms_j), atol=1e-6)
  pw_t = t_spectral.compute_power(torch.from_numpy(x), frame_size=256,
                                  padding=padding)
  pw_j = j_spectral.compute_power(jnp.asarray(x), frame_size=256,
                                  padding=padding)
  np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), atol=2e-3)


def test_db_conversions_diff_and_a_weighting():
  rng = np.random.RandomState(6)
  x = (rng.rand(3, 50) * 2.0).astype(np.float32)
  x[0, :5] = 0.0
  for name in ('amplitude_to_db', 'power_to_db', 'log10'):
    out_t = getattr(t_core, name)(torch.from_numpy(x)).numpy()
    out_j = np.asarray(getattr(j_core, name)(jnp.asarray(x)))
    np.testing.assert_allclose(out_t, out_j, atol=1e-4, err_msg=name)
  y = rng.randn(2, 5, 7).astype(np.float32)
  for axis in (0, 1, 2, -1):
    np.testing.assert_allclose(
        t_core.diff(torch.from_numpy(y), axis=axis).numpy(),
        np.asarray(j_core.diff(jnp.asarray(y), axis=axis)), atol=0)
  with pytest.raises(ValueError, match='axis'):
    t_core.diff(torch.from_numpy(y), axis=3)
  freqs = tuple(t_spectral.fft_frequencies(16000, 512).tolist())
  np.testing.assert_array_equal(
      freqs, j_spectral.fft_frequencies(16000, 512))
  np.testing.assert_array_equal(t_spectral.a_weighting_np(freqs),
                                j_spectral.a_weighting_np(freqs))
