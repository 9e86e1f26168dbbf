"""The port's synthetic controls against ddsp_tpu's, on the CPU.

`synth_convert` both ways, `generate_notes` / `generate_notes_v2` from one
np.random.RandomState (the draws in the same order: the generator's state
after a call is the same in both packages), the on-the-fly
SyntheticNotesProvider, and `generate_synthetic_dataset.main`'s shards.

Tolerance: float32, rtol 1e-5 and atol 1e-6 (the controls go through
float32 pow, sigmoid, exp and sums, whose last bits may differ between XLA
and torch). Shards written by the port are read bit for bit alike by both
packages' SyntheticNotesProvider.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.data import generate_synthetic_dataset as j_generate
from ddsp_tpu.data import multi as j_multi
from ddsp_tpu.data import synthetic_data as j_synthetic
from ddsp_tpu.ops import synth_convert as j_convert
from ddsp_torch.data import generate_synthetic_dataset, multi, synthetic_data
from ddsp_torch.ops import synth_convert

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
SIZES = dict(n_timesteps=40, n_harmonics=24, n_mags=16)


def _close(port, ref):
  assert sorted(port) == sorted(ref)
  for k in ref:
    a, b = np.asarray(port[k]), np.asarray(ref[k])
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, k
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=k)


def _same_state(a, b):
  sa, sb = a.get_state(), b.get_state()
  assert sa[0] == sb[0] and sa[2:] == sb[2:]
  np.testing.assert_array_equal(sa[1], sb[1])


def test_synth_convert_both_ways():
  rng = np.random.RandomState(0)
  f0 = (50 + 900 * rng.rand(2, 6, 1)).astype(np.float32)
  f0[0, 0, 0] = 0.0  # the safe divide
  harm_amp = rng.rand(2, 6, 1).astype(np.float32)
  harm_dist = rng.rand(2, 6, 30).astype(np.float32)
  amps, freqs = synth_convert.harmonic_to_sinusoidal(
      torch.from_numpy(harm_amp), torch.from_numpy(harm_dist),
      torch.from_numpy(f0), sample_rate=16000)
  j_amps, j_freqs = j_convert.harmonic_to_sinusoidal(
      jnp.asarray(harm_amp), jnp.asarray(harm_dist), jnp.asarray(f0),
      sample_rate=16000)
  _close({'amps': amps.numpy(), 'freqs': freqs.numpy()},
         {'amps': j_amps, 'freqs': j_freqs})

  sin_freqs = (f0 * rng.uniform(0.5, 12, (2, 6, 9))).astype(np.float32)
  sin_amps = rng.rand(2, 6, 9).astype(np.float32)
  for normalize in (False, True):
    port = synth_convert.sinusoidal_to_harmonic(
        torch.from_numpy(sin_amps), torch.from_numpy(sin_freqs),
        torch.from_numpy(f0), n_harmonics=12, normalize=normalize)
    ref = j_convert.sinusoidal_to_harmonic(
        jnp.asarray(sin_amps), jnp.asarray(sin_freqs), jnp.asarray(f0),
        n_harmonics=12, normalize=normalize)
    _close({'amp': port[0].numpy(), 'dist': port[1].numpy()},
           {'amp': ref[0], 'dist': ref[1]})


@pytest.mark.parametrize('generator', ['generate_notes', 'generate_notes_v2'])
@pytest.mark.parametrize('get_controls', [True, False])
def test_generate_notes(generator, get_controls):
  for seed in range(3):
    rng, j_rng = np.random.RandomState(seed), np.random.RandomState(seed)
    port = getattr(synthetic_data, generator)(
        2, get_controls=get_controls, random_state=rng, device='cpu', **SIZES)
    ref = getattr(j_synthetic, generator)(
        2, get_controls=get_controls, random_state=j_rng, **SIZES)
    _close(port, ref)
    _same_state(rng, j_rng)
  assert port['harm_dist'].shape == (2, 40, 24)


def test_modulate_and_normal_generator():
  signal = np.random.RandomState(0).rand(3, 20, 2).astype(np.float32)
  rng, j_rng = np.random.RandomState(1), np.random.RandomState(1)
  _close({'m': synthetic_data.modulate(signal, n_t=5, random_state=rng,
                                       device='cpu'),
          'n': synthetic_data.normal_generator([2, 4, 1], 20, 0.0, 1.0,
                                               random_state=rng,
                                               device='cpu')},
         {'m': j_synthetic.modulate(signal, n_t=5, random_state=j_rng),
          'n': j_synthetic.normal_generator([2, 4, 1], 20, 0.0, 1.0,
                                            random_state=j_rng)})
  _same_state(rng, j_rng)


def test_synthetic_notes_provider_on_the_fly():
  port = multi.SyntheticNotesProvider(n_examples=3, seed=2, device='cpu',
                                      **SIZES)
  ref = j_multi.SyntheticNotesProvider(n_examples=3, seed=2, **SIZES)
  port_examples = list(port.get_dataset())
  ref_examples = list(ref.get_dataset())
  assert len(port_examples) == len(ref_examples) == 3
  for a, b in zip(port_examples, ref_examples):
    _close(a, b)


def test_generate_synthetic_dataset(tmp_path):
  args = ['--num_examples=5', '--num_shards=2', '--n_timesteps=40',
          '--n_harmonics=24', '--n_mags=16', '--seed=3']
  (tmp_path / 'port').mkdir()
  (tmp_path / 'jax').mkdir()
  generate_synthetic_dataset.main(
      [f'--output_tfrecord_path={tmp_path}/port/synth', '--device=cpu'] +
      args)
  j_generate.main([f'--output_tfrecord_path={tmp_path}/jax/synth'] + args)
  names = sorted(os.listdir(tmp_path / 'port'))
  assert names == sorted(os.listdir(tmp_path / 'jax')) == [
      'synth-00000-of-00002.tfrecord', 'synth-00001-of-00002.tfrecord']

  pattern = str(tmp_path / 'port' / 'synth-*')
  port_read = list(multi.SyntheticNotesProvider(
      file_pattern=pattern, **SIZES).get_dataset())
  jax_read = list(j_multi.SyntheticNotesProvider(
      file_pattern=pattern, **SIZES).get_dataset())
  jax_written = list(j_multi.SyntheticNotesProvider(
      file_pattern=str(tmp_path / 'jax' / 'synth-*'), **SIZES).get_dataset())
  assert len(port_read) == len(jax_read) == len(jax_written) == 5
  for a, b, c in zip(port_read, jax_read, jax_written):
    assert sorted(a) == sorted(b)
    for k in a:
      np.testing.assert_array_equal(a[k], b[k])
    _close(a, c)
