"""Dataset postprocessing: note detection, loudness normalization, tuning.

Port of ddsp_tpu/eval/postprocessing.py: the timbre-transfer adjustments
(smooth, detect_notes, the QuantileTransformer and its fit, the dataset
statistics and their pickles, get_tuning_factor, auto_tune). Numpy on the
host, but the statistics' power, which the port's torch op computes. The
QuantileTransformer is the standard percentile-landmark quantile
normalization (as sklearn's) without an sklearn dependency.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional, Tuple

import numpy as np

from ddsp_torch.ops import spectral
from ddsp_torch.ops.core import hz_to_midi, torch_float32
from ddsp_torch.utils.device import DeviceLike, resolve_device

DB_RANGE = 80.0


def smooth(x: np.ndarray, filter_size: int = 3) -> np.ndarray:
  """Smooth a 1-D (or [batch, time]) signal with a box filter ('same')."""
  x = np.asarray(x, np.float32)
  is_1d = x.ndim == 1
  x2 = x[np.newaxis, :] if is_1d else x
  w = np.ones(filter_size, np.float32) / float(filter_size)
  # 'same' convolution with zero padding (matches tf.nn.conv1d SAME).
  pad_l = (filter_size - 1) // 2
  pad_r = filter_size - 1 - pad_l
  padded = np.pad(x2, ((0, 0), (pad_l, pad_r)))
  y = np.stack([np.convolve(row, w, mode='valid') for row in padded])
  return y[0] if is_1d else y


def detect_notes(loudness_db: np.ndarray,
                 f0_confidence: np.ndarray,
                 note_threshold: float = 1.0,
                 exponent: float = 2.0,
                 smoothing: int = 40,
                 f0_confidence_threshold: float = 0.7,
                 min_db: float = -DB_RANGE
                 ) -> Tuple[np.ndarray, np.ndarray]:
  """Detect note on-off using loudness and smoothed f0 confidence."""
  loudness_db = np.asarray(loudness_db)
  f0_confidence = np.asarray(f0_confidence)
  mean_db = np.mean(loudness_db)
  db = smooth(f0_confidence**exponent, smoothing) * (loudness_db - min_db)
  db_threshold = (mean_db - min_db) * f0_confidence_threshold**exponent
  note_on_ratio = db / db_threshold
  mask_on = note_on_ratio >= note_threshold
  return mask_on, note_on_ratio


class QuantileTransformer:
  """Quantile normalization via percentile landmarks (sklearn-compatible).

  Maps features to a uniform (or normal) distribution by interpolating each
  value against the empirical quantile function. Kept dependency-free so
  pickled dataset statistics survive library upgrades.
  """

  def __init__(self, n_quantiles: int = 1000,
               output_distribution: str = 'uniform',
               subsample: int = int(1e5)):
    self.n_quantiles = n_quantiles
    self.output_distribution = output_distribution
    self.subsample = subsample

  def fit(self, x: np.ndarray) -> 'QuantileTransformer':
    """x: [n_samples, n_features]."""
    if self.n_quantiles <= 0:
      raise ValueError(f'Invalid n_quantiles: {self.n_quantiles}; must be '
                       'at least one.')
    x = np.asarray(x)
    n_samples = x.shape[0]
    self.n_quantiles_ = max(1, min(self.n_quantiles, n_samples))
    self.references_ = np.linspace(0, 1, self.n_quantiles_, endpoint=True)

    rng = np.random.mtrand._rand  # pylint: disable=protected-access
    quantiles = []
    for col in x.T:
      if self.subsample < n_samples:
        idx = rng.choice(n_samples, size=self.subsample, replace=False)
        col = col.take(idx, mode='clip')
      quantiles.append(np.nanpercentile(col, self.references_ * 100))
    # Enforce monotonicity against nanpercentile fp error.
    self.quantiles_ = np.maximum.accumulate(np.transpose(quantiles))
    return self

  def _transform_col(self, x_col, quantiles, inverse):
    from scipy import stats  # pylint: disable=g-import-not-at-top
    out_norm = self.output_distribution == 'normal'
    eps = 1e-7

    if inverse:
      lo_x, hi_x, lo_y, hi_y = 0.0, 1.0, quantiles[0], quantiles[-1]
      if out_norm:
        with np.errstate(invalid='ignore'):
          x_col = stats.norm.cdf(x_col)
    else:
      lo_x, hi_x, lo_y, hi_y = quantiles[0], quantiles[-1], 0.0, 1.0

    with np.errstate(invalid='ignore'):
      if out_norm:
        lo_idx = x_col - eps < lo_x
        hi_idx = x_col + eps > hi_x
      else:
        lo_idx = x_col == lo_x
        hi_idx = x_col == hi_x

    finite = ~np.isnan(x_col)
    xf = x_col[finite]
    if inverse:
      x_col[finite] = np.interp(xf, self.references_, quantiles)
    else:
      # Average ascending/descending interpolation so ties in the
      # quantiles map to the middle of their plateau.
      x_col[finite] = 0.5 * (
          np.interp(xf, quantiles, self.references_) -
          np.interp(-xf, -quantiles[::-1], -self.references_[::-1]))

    x_col[hi_idx] = hi_y
    x_col[lo_idx] = lo_y

    if not inverse and out_norm:
      with np.errstate(invalid='ignore'):
        x_col = stats.norm.ppf(x_col)
        clip_min = stats.norm.ppf(eps - np.spacing(1))
        clip_max = stats.norm.ppf(1 - (eps - np.spacing(1)))
        x_col = np.clip(x_col, clip_min, clip_max)
    return x_col

  def _transform(self, x, inverse):
    x = np.array(x, dtype=float)  # Explicit copy.
    for j in range(x.shape[1]):
      x[:, j] = self._transform_col(x[:, j], self.quantiles_[:, j], inverse)
    return x

  def transform(self, x):
    return self._transform(x, inverse=False)

  def inverse_transform(self, x):
    return self._transform(x, inverse=True)

  def fit_transform(self, x):
    return self.fit(x).transform(x)


def fit_quantile_transform(loudness_db: np.ndarray, mask_on: np.ndarray,
                           inv_quantile: Optional[QuantileTransformer] = None):
  """Fit quantile normalization of note-on loudness.

  With inv_quantile, also renormalizes: the input loudness is mapped through
  its own quantiles then through the inverse of the pretrained transform.
  """
  quantile_transform = QuantileTransformer()
  loudness_flat = np.ravel(loudness_db[mask_on])[:, np.newaxis]
  loudness_flat_q = quantile_transform.fit_transform(loudness_flat)

  if inv_quantile is None:
    return quantile_transform
  loudness_flat_norm = inv_quantile.inverse_transform(loudness_flat_q)
  loudness_norm = np.ravel(np.array(loudness_db))[:, np.newaxis]
  loudness_norm[np.ravel(mask_on)] = loudness_flat_norm
  return quantile_transform, loudness_norm


def compute_dataset_statistics(data_provider, batch_size: int = 1,
                               power_frame_size: int = 1024,
                               power_frame_rate: int = 50,
                               device: DeviceLike = None) -> Dict:
  """Dataset statistics for timbre-transfer normalization.

  Returns an overcomplete dict of pitch/power/loudness stats (global and
  note-masked) plus a fitted loudness QuantileTransformer. The power is
  computed on `device` (CUDA unless the caller says otherwise).
  """
  device = resolve_device(device)
  ds = data_provider.get_batch(batch_size, shuffle=False, repeats=1)

  loudness, power, f0, f0_conf = [], [], [], []
  n_batches = 0
  for batch in ds:
    audio_key = 'audio_16k' if 'audio_16k' in batch else 'audio'
    loudness.append(np.atleast_2d(batch['loudness_db']))
    power.append(np.atleast_2d(spectral.compute_power(
        torch_float32(batch[audio_key]).to(device),
        frame_size=power_frame_size,
        frame_rate=power_frame_rate).cpu().numpy()))
    f0.append(np.atleast_2d(batch['f0_hz']))
    f0_conf.append(np.atleast_2d(batch['f0_confidence']))
    n_batches += 1

  def squeeze_channel(x):
    x = np.vstack(x)
    return x[..., 0] if x.ndim == 3 else x

  loudness = squeeze_channel(loudness)
  power = squeeze_channel(power)
  f0 = squeeze_channel(f0)
  f0_conf = squeeze_channel(f0_conf)

  # Trim the tail (transients from centered framing); adaptive for short
  # examples (20 frames of 1000-frame examples).
  n_frames = min(loudness.shape[1], power.shape[1], f0.shape[1],
                 f0_conf.shape[1])
  trim_end = min(20, max(1, n_frames // 4))
  keep = n_frames - trim_end
  pitch_trimmed = hz_to_midi(f0[:, :keep]).numpy()
  power_trimmed = power[:, :keep]
  loudness_trimmed = loudness[:, :keep]
  f0_conf_trimmed = f0_conf[:, :keep]

  mask_on, _ = detect_notes(loudness_trimmed, f0_conf_trimmed)
  # Default to the full signal when no notes are detected.
  mask_on = np.logical_or(
      mask_on, np.logical_not(np.any(mask_on, axis=1, keepdims=True)))

  quantile_transform = fit_quantile_transform(loudness_trimmed, mask_on)

  def get_stats(x, prefix, note_mask=None):
    if note_mask is None:
      mean_max = np.mean(np.max(x, axis=-1))
      mean_min = np.mean(np.min(x, axis=-1))
    else:
      maxes = [np.max(xi[m]) for xi, m in zip(x, note_mask) if np.any(m)]
      mins = [np.min(xi[m]) for xi, m in zip(x, note_mask) if np.any(m)]
      mean_max = np.mean(maxes)
      mean_min = np.mean(mins)
      x = x[note_mask]
    return {
        f'mean_{prefix}': np.mean(x),
        f'max_{prefix}': np.max(x),
        f'min_{prefix}': np.min(x),
        f'mean_max_{prefix}': mean_max,
        f'mean_min_{prefix}': mean_min,
        f'std_{prefix}': np.std(x),
    }

  ds_stats = {}
  ds_stats.update(get_stats(pitch_trimmed, 'pitch'))
  ds_stats.update(get_stats(power_trimmed, 'power'))
  ds_stats.update(get_stats(loudness_trimmed, 'loudness'))
  ds_stats.update(get_stats(pitch_trimmed, 'pitch_note', mask_on))
  ds_stats.update(get_stats(power_trimmed, 'power_note', mask_on))
  ds_stats.update(get_stats(loudness_trimmed, 'loudness_note', mask_on))
  ds_stats['quantile_transform'] = quantile_transform
  return ds_stats


def save_dataset_statistics(data_provider, file_path: Optional[str] = None,
                            batch_size: int = 1,
                            power_frame_size: int = 256,
                            device: DeviceLike = None) -> Dict:
  """Compute and optionally pickle dataset statistics."""
  ds_stats = compute_dataset_statistics(data_provider, batch_size,
                                        power_frame_size, device=device)
  if file_path is not None:
    with open(file_path, 'wb') as f:
      pickle.dump(ds_stats, f)
  return ds_stats


def load_dataset_statistics(file_path: str) -> Dict:
  with open(file_path, 'rb') as f:
    return pickle.load(f)


# ------------------------------------------------------------------------------
# Frequency tuning (timbre transfer)
# ------------------------------------------------------------------------------
def get_tuning_factor(f0_midi: np.ndarray, f0_confidence: np.ndarray,
                      mask_on: np.ndarray) -> float:
  """Offset in semitones to the most consistent chromatic grid (1-cent steps).

  Scores each candidate offset by confidence-weighted distance to the grid
  plus the number of induced note transitions.
  """
  tuning_factors = np.linspace(-0.5, 0.5, 101)
  midi_diffs = (f0_midi[mask_on][:, np.newaxis] -
                tuning_factors[np.newaxis, :]) % 1.0
  midi_diffs[midi_diffs > 0.5] -= 1.0
  weights = f0_confidence[mask_on][:, np.newaxis]

  cost_diffs = np.mean(weights * np.abs(midi_diffs), axis=0)

  f0_at = f0_midi[mask_on][:, np.newaxis] - midi_diffs
  deltas = (np.diff(f0_at, axis=0) != 0.0).astype(float)
  cost_deltas = np.mean(weights[:-1] * deltas, axis=0)

  norm = lambda x: (x - np.mean(x)) / np.std(x)
  cost = norm(cost_deltas) + norm(cost_diffs)
  return float(tuning_factors[np.argmin(cost)])


_KEYS = ['C', 'Db', 'D', 'Eb', 'E', 'F', 'Gb', 'G', 'Ab', 'A', 'Bb', 'B',
         'C']


def auto_tune(f0_midi: np.ndarray, tuning_factor: float,
              mask_on: np.ndarray, amount: float = 0.0,
              chromatic: bool = False) -> np.ndarray:
  """Pull f0 toward the chromatic grid or the best-fit major scale."""
  if chromatic:
    midi_diff = (f0_midi - tuning_factor) % 1.0
    midi_diff[midi_diff > 0.5] -= 1.0
  else:
    major_scale = np.ravel(
        [np.array([0, 2, 4, 5, 7, 9, 11]) + 12 * i for i in range(10)])
    all_scales = np.stack([major_scale + i for i in range(12)])

    f0_on = f0_midi[mask_on]
    f0_diff_tsn = (f0_on[:, np.newaxis, np.newaxis] -
                   all_scales[np.newaxis, :, :])
    f0_diff_ts = np.min(np.abs(f0_diff_tsn), axis=-1)
    scale_idx = int(np.argmin(np.mean(f0_diff_ts, axis=0)))

    f0_diff_tn = (f0_midi[:, np.newaxis] -
                  all_scales[scale_idx][np.newaxis, :])
    note_idx = np.argmin(np.abs(f0_diff_tn), axis=-1)
    midi_diff = np.take_along_axis(f0_diff_tn, note_idx[:, np.newaxis],
                                   axis=-1)[:, 0]

  return f0_midi - amount * midi_diff
