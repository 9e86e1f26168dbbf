"""Helpers for tests: synthetic sinusoids (port of
ddsp_tpu/utils/test_util.py, numpy only, the same values bit for bit)."""

from __future__ import annotations

import numpy as np


def gen_np_sinusoid(frequency: float, amp: float, sample_rate: int,
                    audio_len_sec: float) -> np.ndarray:
  """A single sinusoid, shape [n_samples]."""
  x = np.linspace(0, audio_len_sec, int(audio_len_sec * sample_rate))
  return amp * np.sin(2 * np.pi * frequency * x)


def gen_np_batched_sinusoids(frequency: float, amp: float, sample_rate: int,
                             audio_len_sec: float,
                             batch_size: int) -> np.ndarray:
  """Identical sinusoids stacked on a batch axis, [batch, n_samples]."""
  return np.array([
      gen_np_sinusoid(frequency, amp, sample_rate, audio_len_sec)
      for _ in range(batch_size)
  ])
