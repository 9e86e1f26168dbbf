"""'synthetic_notes': self-supervised batches of synthetic notes (a seeded
copy of the DDSP library's generate_notes_v2): harmonic, sinusoidal and
noise controls, from which the model synthesizes its own audio, and the
three noise draws of its step."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.harness import weights


def _blend(length, start, end, exp_max, rng):
  """A curve from start to end of random steepness (random_blend)."""
  exp = rng.uniform(-exp_max, exp_max)
  v = np.linspace(1.0, 0.0, length)**(2.0**exp)
  return start * v + end * (1.0 - v)


def _spectrum(n, low_pass, rand_phase, rng):
  """A random smooth distribution over n bins (random_harm_dist)."""
  n_components = rng.randint(1, 21)
  smoothness = rng.uniform(1.0, 10.0)
  coeffs = rng.rand(n_components)
  freqs = rng.rand(n_components) * n / smoothness
  v = [coeffs[i] * np.cos(np.linspace(0.0, 2.0 * np.pi * freqs[i], n) +
                          rng.uniform(0.0, np.pi * 2.0 * rand_phase))
       for i in range(n_components)]
  if low_pass:
    v = [v_i * np.linspace(1.0, rng.uniform(0.0, 0.5), n)**rng.uniform(
        0.5, 2.0) for v_i in v]
  return np.sum(np.stack(v), axis=0)


def _exp_sigmoid(x):
  return 2.0 * (1.0 / (1.0 + np.exp(-x)))**np.log(10.0) + 1e-7


def _note_controls(tr, n_frames, sample_rate, rng):
  """One example's controls (generate_notes_v2 of the DDSP library's
  synthetic data, as ddsp_torch.data.synthetic_data computes it)."""
  n_h, n_m = tr['n_sinusoids'], tr['n_mags']
  lo, hi = tr['min_note_length'], tr['max_note_length']
  harm_amp = np.zeros([n_frames, 1])
  harm_dist = np.zeros([n_frames, n_h])
  f0_midi = np.zeros([n_frames, 1])
  mags = np.zeros([n_frames, n_m])
  t_start = 0
  while t_start < n_frames:
    t_end = min(t_start + rng.randint(lo, hi + 1), n_frames)
    length = t_end - t_start
    span = slice(t_start, t_end)
    if rng.uniform() <= tr['p_silent']:
      harm_amp[span] -= 10.0
    else:
      harm_amp[span] += _blend(length, rng.uniform(-1.0, 3.0),
                               rng.uniform(-1.0, 3.0), 2.0, rng)[:, None]
      harm_amp[span] += rng.uniform(0.0, 0.1) * rng.randn(length, 1)
      low_pass = rng.uniform() <= 0.8
      rand_phase = rng.uniform(0.0, 0.4)
      hd_start = _spectrum(n_h, low_pass, rand_phase, rng)[None]
      hd_end = _spectrum(n_h, low_pass, rand_phase, rng)[None]
      blend = _blend(length, 1.0, 0.0, 2.0, rng)[:, None]
      harm_dist[span] += hd_start * blend + hd_end * (1.0 - blend)
      harm_dist[span] += rng.uniform(0.0, 0.5) * rng.randn(length, n_h)
      f0 = rng.uniform(24.0, 84.0)
      if rng.uniform() <= tr['p_vibrato']:
        vib_blend = _blend(length, rng.uniform(0.0, 1.0),
                           rng.uniform(0.0, 1.0), 2.0, rng)
        periods = rng.uniform(0.0, length * 2.0 / lo)
        f0_note = f0 + vib_blend * np.sin(
            np.linspace(0.0, 2.0 * np.pi * periods, length))
      else:
        f0_note = f0 * np.ones([length])
      f0_midi[span] += f0_note[:, None]
      f0_midi[span] += rng.uniform(0.0, 0.1) * rng.randn(length, 1)
    low_pass = rng.uniform() <= 0.8
    rand_phase = rng.uniform(0.0, 0.4)
    m_start = _spectrum(n_m, low_pass, rand_phase, rng)[None]
    m_end = _spectrum(n_m, low_pass, rand_phase, rng)[None]
    blend = _blend(length, 1.0, 0.0, 2.0, rng)[:, None]
    mags[span] += m_start * blend + m_end * (1.0 - blend)
    mags[span] += rng.uniform(0.0, 0.2) * rng.randn(length, n_m)
    mags[span] -= rng.uniform(1.0, 10.0)
    t_start = t_end
  harm_amp = _exp_sigmoid(harm_amp)
  denom = rng.uniform(2.0, 10.0) if rng.uniform() <= 0.2 else 2.0
  harm_amp = harm_amp / rng.uniform(1.0, denom)
  f0_hz = 440.0 * 2.0**((f0_midi - 69.0) / 12.0)
  harm_dist = np.exp(harm_dist - harm_dist.max(axis=-1, keepdims=True))
  harm_dist /= harm_dist.sum(axis=-1, keepdims=True)
  freqs = f0_hz * np.arange(1, n_h + 1)
  harm_dist = np.where(freqs >= sample_rate / 2.0, 0.0, harm_dist)
  harm_dist /= np.maximum(harm_dist.sum(axis=-1, keepdims=True), 1e-7)
  return {'harm_amp': harm_amp, 'harm_dist': harm_dist, 'f0_hz': f0_hz,
          'sin_amps': harm_amp * harm_dist, 'sin_freqs': freqs,
          'noise_magnitudes': _exp_sigmoid(mags)}


def make(tr: Dict, cfg: Dict, seed: int, device
                    ) -> Dict[str, List]:
  """{'batches': [{'harm_amp', 'harm_dist', 'f0_hz', 'sin_amps',
  'sin_freqs', 'noise_magnitudes'}], 'noise': [{'noise', 'harmonic_noise',
  'synthetic_noise'}]} float32 on `device`: tr['pool'] self-supervised
  batches of tr['batch'] synthetic notes of tr['frames'] frames (a seeded
  copy of generate_notes_v2, as ddsp_torch's SyntheticNotesProvider
  makes them), and the three noise draws a step takes."""
  rng = np.random.RandomState(
      weights.stream_seed(seed, weights.TRAFFIC_STREAM) % 2**32)
  gn = weights.generator(seed, weights.NOISE_STREAM, device)
  n = cfg['n_samples']
  out = {'batches': [], 'noise': []}
  for _ in range(tr['pool']):
    rows = [_note_controls(tr, tr['frames'], cfg['sample_rate'], rng)
            for _ in range(tr['batch'])]
    out['batches'].append({
        k: torch.as_tensor(np.stack([r[k] for r in rows]).astype(np.float32),
                           device=device) for k in rows[0]})
    out['noise'].append({
        k: torch.rand((tr['batch'], n), generator=gn, device=device) * 2.0 -
        1.0 for k in ('synthetic_noise', 'noise', 'harmonic_noise')})
  return out
