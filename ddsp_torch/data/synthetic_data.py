"""Random harmonic/noise control trajectories for self-supervised training.

Port of ddsp_tpu/data/synthetic_data.py. Reference behavior:
magenta/ddsp's ddsp/training/data_preparation/synthetic_data.py
(generate_notes:62, generate_notes_v2:150, random_harm_dist:128,
random_blend:121, uniform/normal generators:39-60).

Host-side numpy generation (an explicit np.random.RandomState seeds it,
drawn from in the JAX package's order); outputs are the control dicts
InverseSynthesis consumes ('sin_amps', 'sin_freqs', 'noise_magnitudes',
'harm_amp', 'harm_dist', 'f0_hz'). Numpy in and numpy out: the port's torch
ops (resample, exp_sigmoid, midi_to_hz, remove_above_nyquist,
harmonic_to_sinusoidal) run in float32 on `device`, CUDA unless the caller
passes device='cpu', as the JAX ops run in float32.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ddsp_torch.ops import core as ops_core
from ddsp_torch.ops import synth_convert
from ddsp_torch.ops.core import torch_float32
from ddsp_torch.ops.oscillator import remove_above_nyquist
from ddsp_torch.ops.resample import resample
from ddsp_torch.utils.device import DeviceLike, resolve_device


def _rng(random_state) -> np.random.RandomState:
  if random_state is None:
    return np.random.mtrand._rand  # pylint: disable=protected-access
  return random_state


def _on(fn, *arrays, device: DeviceLike = None, **kwargs):
  """fn of the arrays as float32 tensors on `device`, back as numpy (a
  tuple of arrays where fn returns a tuple)."""
  device = resolve_device(device)
  out = fn(*(torch_float32(a, device) for a in arrays), **kwargs)
  if isinstance(out, tuple):
    return tuple(o.cpu().numpy() for o in out)
  return out.cpu().numpy()


def flip(p: float = 0.5, random_state=None) -> bool:
  return _rng(random_state).uniform() <= p


def uniform_int(minval=0, maxval=10, random_state=None) -> int:
  return int(_rng(random_state).randint(int(minval), int(maxval) + 1))


def uniform_float(minval=0.0, maxval=10.0, random_state=None) -> float:
  return float(_rng(random_state).uniform(float(minval), float(maxval)))


def uniform_generator(sample_shape, n_timesteps, minval, maxval,
                      method: str = 'linear', random_state=None,
                      device: DeviceLike = None):
  """Interpolate between a fixed number of uniform samples."""
  signal = _rng(random_state).uniform(minval, maxval, sample_shape)
  return _on(resample, signal, device=device, n_timesteps=n_timesteps,
             method=method)


def normal_generator(sample_shape, n_timesteps, mean, stddev,
                     method: str = 'linear', random_state=None,
                     device: DeviceLike = None):
  """Interpolate between a fixed number of normal samples."""
  signal = _rng(random_state).normal(mean, stddev, sample_shape)
  return _on(resample, signal, device=device, n_timesteps=n_timesteps,
             method=method)


def modulate(signal: np.ndarray, maxval: float = 0.5, n_t: int = 10,
             method: str = 'linear', random_state=None,
             device: DeviceLike = None) -> np.ndarray:
  """Multiply by |normal| noise whose stddev is drawn uniformly per batch."""
  rng = _rng(random_state)
  n_batch, n_timesteps, _ = signal.shape
  signal_std = rng.uniform(0.0, maxval, n_batch)
  # Draw [1, n_t, n_batch] so each batch row gets its own stddev, then
  # put batch first: [n_batch, n_t, 1].
  mod = np.abs(rng.normal(1.0, signal_std, [1, n_t, n_batch]))
  mod = np.transpose(mod, [2, 1, 0]).astype(np.float32)
  mod = _on(resample, mod, device=device, n_timesteps=n_timesteps,
            method=method)
  return signal * mod


def generate_notes(n_batch: int,
                   n_timesteps: int,
                   n_harmonics: int = 100,
                   n_mags: int = 65,
                   get_controls: bool = True,
                   sample_rate: int = 16000,
                   random_state: Optional[np.random.RandomState] = None,
                   device: DeviceLike = None) -> Dict[str, np.ndarray]:
  """Generate a self-supervision signal of discrete notes."""
  rng = _rng(random_state)
  device = resolve_device(device)
  n_notes = uniform_int(1, 20, rng)

  # Amplitudes.
  method = 'nearest' if flip(0.5, rng) else 'linear'
  harm_amp = uniform_generator([n_batch, n_notes, 1], n_timesteps,
                               minval=-2, maxval=2, method=method,
                               random_state=rng, device=device)
  if get_controls:
    harm_amp = _on(ops_core.exp_sigmoid, harm_amp, device=device)

  # Frequencies.
  note_midi = uniform_generator([n_batch, n_notes, 1], n_timesteps,
                                minval=24.0, maxval=84.0, method='nearest',
                                random_state=rng, device=device)
  f0_hz = _on(ops_core.midi_to_hz, note_midi, device=device)

  # Harmonic distribution: blend of power-law rolloff lines.
  method = 'nearest' if flip(0.5, rng) else 'linear'
  n_lines = 10
  exponents = [uniform_float(1.0, 6.0, rng) for _ in range(n_lines)]
  harm_dist_lines = np.stack(
      [-np.linspace(0.0, float(i), n_harmonics)**exponents[i]
       for i in range(n_lines)]).astype(np.float32)
  lines_dist = uniform_generator([n_batch, n_notes, n_lines], n_timesteps,
                                 minval=0.0, maxval=1.0, method=method,
                                 random_state=rng, device=device)
  harm_dist = np.sum(
      lines_dist[..., np.newaxis] *
      harm_dist_lines[np.newaxis, np.newaxis, :], axis=-2)

  if get_controls:
    harm_dist = _on(ops_core.exp_sigmoid, harm_dist, device=device)
    harm_dist = _on(remove_above_nyquist,
                    np.arange(1, n_harmonics + 1) * f0_hz, harm_dist,
                    sample_rate=sample_rate, device=device)
    harm_dist = harm_dist / np.maximum(
        harm_dist.sum(axis=-1, keepdims=True), 1e-7)

  # Noise magnitudes.
  method = 'nearest' if flip(0.5, rng) else 'linear'
  mags = uniform_generator([n_batch, n_notes, n_mags], n_timesteps,
                           minval=-6.0,
                           maxval=uniform_float(-4.0, 0.0, rng),
                           method=method, random_state=rng, device=device)
  if get_controls:
    mags = _on(ops_core.exp_sigmoid, mags, device=device)

  sin_amps, sin_freqs = _on(synth_convert.harmonic_to_sinusoidal, harm_amp,
                            harm_dist, f0_hz, sample_rate=sample_rate,
                            device=device)

  return {'harm_amp': np.asarray(harm_amp, np.float32),
          'harm_dist': np.asarray(harm_dist, np.float32),
          'f0_hz': np.asarray(f0_hz, np.float32),
          'sin_amps': np.asarray(sin_amps, np.float32),
          'sin_freqs': np.asarray(sin_freqs, np.float32),
          'noise_magnitudes': np.asarray(mags, np.float32)}


def random_blend(length: int, env_start: float = 1.0, env_end: float = 0.0,
                 exp_max: float = 2.0, random_state=None) -> np.ndarray:
  """Linear mix between two values with random curve steepness."""
  exp = uniform_float(-exp_max, exp_max, random_state)
  v = np.linspace(1.0, 0.0, length)**(2.0**exp)
  return env_start * v + env_end * (1.0 - v)


def random_harm_dist(n_harmonics: int = 100, low_pass: bool = True,
                     rand_phase: float = 0.0,
                     random_state=None) -> np.ndarray:
  """Harmonic distribution from random sinusoidal components."""
  rng = _rng(random_state)
  n_components = uniform_int(1, 20, rng)
  smoothness = uniform_float(1.0, 10.0, rng)
  coeffs = rng.rand(n_components)
  freqs = rng.rand(n_components) * n_harmonics / smoothness

  v = []
  for i in range(n_components):
    v_i = coeffs[i] * np.cos(
        np.linspace(0.0, 2.0 * np.pi * freqs[i], n_harmonics) +
        uniform_float(0.0, np.pi * 2.0 * rand_phase, rng))
    v.append(v_i)

  if low_pass:
    v = [v_i * np.linspace(1.0, uniform_float(0.0, 0.5, rng),
                           n_harmonics)**uniform_float(0.5, 2.0, rng)
         for v_i in v]
  return np.sum(np.stack(v), axis=0)


def generate_notes_v2(n_batch: int = 1,
                      n_timesteps: int = 125,
                      n_harmonics: int = 100,
                      n_mags: int = 65,
                      min_note_length: int = 5,
                      max_note_length: int = 25,
                      p_silent: float = 0.1,
                      p_vibrato: float = 0.5,
                      get_controls: bool = True,
                      sample_rate: int = 16000,
                      random_state: Optional[np.random.RandomState] = None,
                      device: DeviceLike = None) -> Dict[str, np.ndarray]:
  """More expressive self-supervision signal (vibrato, silences, blends)."""
  rng = _rng(random_state)
  device = resolve_device(device)
  harm_amp = np.zeros([n_batch, n_timesteps, 1])
  harm_dist = np.zeros([n_batch, n_timesteps, n_harmonics])
  f0_midi = np.zeros([n_batch, n_timesteps, 1])
  mags = np.zeros([n_batch, n_timesteps, n_mags])

  for b in range(n_batch):
    t_start = 0
    while t_start < n_timesteps:
      note_length = uniform_int(min_note_length, max_note_length, rng)
      t_end = min(t_start + note_length, n_timesteps)
      note_length = t_end - t_start

      if flip(p_silent, rng):
        harm_amp[b, t_start:t_end, :] -= 10.0
      else:
        # Amplitude envelope.
        amp_blend = random_blend(note_length,
                                 uniform_float(-1.0, 3.0, rng),
                                 uniform_float(-1.0, 3.0, rng),
                                 random_state=rng)
        harm_amp[b, t_start:t_end, :] += amp_blend[:, np.newaxis]
        harm_amp[b, t_start:t_end, :] += (
            uniform_float(0.0, 0.1, rng) *
            rng.randn(note_length, 1))

        # Harmonic distribution blend.
        low_pass = flip(0.8, rng)
        rand_phase = uniform_float(0.0, 0.4, rng)
        hd_start = random_harm_dist(n_harmonics, low_pass, rand_phase,
                                    rng)[np.newaxis, :]
        hd_end = random_harm_dist(n_harmonics, low_pass, rand_phase,
                                  rng)[np.newaxis, :]
        blend = random_blend(note_length, 1.0, 0.0,
                             random_state=rng)[:, np.newaxis]
        harm_dist[b, t_start:t_end, :] += (hd_start * blend +
                                           hd_end * (1.0 - blend))
        harm_dist[b, t_start:t_end, :] += (
            uniform_float(0.0, 0.5, rng) *
            rng.randn(note_length, n_harmonics))

        # Fundamental frequency (+ vibrato).
        f0 = uniform_float(24.0, 84.0, rng)
        if flip(p_vibrato, rng):
          vib_blend = random_blend(note_length,
                                   uniform_float(0.0, 1.0, rng),
                                   uniform_float(0.0, 1.0, rng),
                                   random_state=rng)
          vib_periods = uniform_float(
              0.0, note_length * 2.0 / min_note_length, rng)
          vib = vib_blend * np.sin(
              np.linspace(0.0, 2.0 * np.pi * vib_periods, note_length))
          f0_note = f0 + vib
        else:
          f0_note = f0 * np.ones([note_length])
        f0_midi[b, t_start:t_end, :] += f0_note[:, np.newaxis]
        f0_midi[b, t_start:t_end, :] += (
            uniform_float(0.0, 0.1, rng) * rng.randn(note_length, 1))

      # Filtered-noise magnitudes (also through silences).
      low_pass = flip(0.8, rng)
      rand_phase = uniform_float(0.0, 0.4, rng)
      m_start = random_harm_dist(n_mags, low_pass, rand_phase,
                                 rng)[np.newaxis, :]
      m_end = random_harm_dist(n_mags, low_pass, rand_phase,
                               rng)[np.newaxis, :]
      blend = random_blend(note_length, 1.0, 0.0,
                           random_state=rng)[:, np.newaxis]
      mags[b, t_start:t_end, :] += m_start * blend + m_end * (1.0 - blend)
      mags[b, t_start:t_end, :] += (uniform_float(0.0, 0.2, rng) *
                                    rng.randn(note_length, n_mags))
      mags[b, t_start:t_end, :] -= uniform_float(1.0, 10.0, rng)

      t_start = t_end

  if get_controls:
    harm_amp = _on(ops_core.exp_sigmoid, harm_amp, device=device)
    denom = (uniform_float(2.0, 10.0, rng) if flip(0.2, rng) else 2.0)
    harm_amp = harm_amp / uniform_float(1.0, denom, rng)

  f0_hz = _on(ops_core.midi_to_hz, f0_midi, device=device)

  if get_controls:
    exp = np.exp(harm_dist - harm_dist.max(axis=-1, keepdims=True))
    harm_dist = exp / exp.sum(axis=-1, keepdims=True)
    harm_dist = _on(remove_above_nyquist,
                    np.arange(1, n_harmonics + 1) * f0_hz, harm_dist,
                    sample_rate=sample_rate, device=device)
    harm_dist = harm_dist / np.maximum(
        harm_dist.sum(axis=-1, keepdims=True), 1e-7)
    mags = _on(ops_core.exp_sigmoid, mags, device=device)

  sin_amps, sin_freqs = _on(synth_convert.harmonic_to_sinusoidal, harm_amp,
                            harm_dist, f0_hz, sample_rate=sample_rate,
                            device=device)

  return {'harm_amp': np.asarray(harm_amp, np.float32),
          'harm_dist': np.asarray(harm_dist, np.float32),
          'f0_hz': np.asarray(f0_hz, np.float32),
          'sin_amps': np.asarray(sin_amps, np.float32),
          'sin_freqs': np.asarray(sin_freqs, np.float32),
          'noise_magnitudes': np.asarray(mags, np.float32)}
