"""Straight-through estimators and note masking and pooling.

Port of ddsp_tpu/nn/stops.py. `stop_gradient` is `.detach()`; categorical
sampling takes an explicit torch.Generator. torch.round rounds half to even,
as jnp.round does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ddsp_torch.ops.core import diff, safe_divide


def straight_through_softmax(
    logits: torch.Tensor, key: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Straight-through estimator of a one-hot categorical distribution.

  Args:
    logits: Unnormalized log-probabilities, [..., n_classes].
    key: The torch.Generator of a categorical draw (where the JAX function
      takes a PRNG key). If None, takes the argmax (the mode) instead of
      sampling.

  Returns:
    (sample, probs): a one-hot sample with straight-through gradients into
    probs, and the softmax probabilities.
  """
  probs = torch.softmax(logits, dim=-1)
  if key is not None:
    flat = probs.detach().reshape(-1, probs.shape[-1])
    idx = torch.multinomial(flat, 1, generator=key).reshape(
        probs.shape[:-1])
  else:
    idx = torch.argmax(probs, dim=-1)
  one_hot = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(
      torch.float32)
  p_sample = probs * one_hot
  return (one_hot - p_sample).detach() + p_sample, probs


def straight_through_choice(logits: torch.Tensor, values: torch.Tensor,
                            key: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
  """Straight-through estimator of choosing a value by a one-hot mask."""
  choice, _ = straight_through_softmax(logits, key)
  return torch.sum(choice * values, dim=-1, keepdim=True)


def straight_through_int_quantization(x: torch.Tensor) -> torch.Tensor:
  """Round to the nearest integer (half to even) with identity gradients."""
  return x + (torch.round(x) - x).detach()


# ------------------ Note masking / pooling ------------------------------------
def _regions(edge_idx: torch.Tensor, max_regions: int) -> torch.Tensor:
  """[batch, time] region indices -> a [batch, time, max_regions] one-hot;
  indices at or past max_regions give an all-zero row."""
  return (edge_idx[..., None] == torch.arange(
      max_regions, device=edge_idx.device)).to(torch.float32)


def get_note_mask(q_pitch: torch.Tensor, max_regions: int = 100,
                  note_on_only: bool = True) -> torch.Tensor:
  """Binary mask [batch, time, max_regions] of each note region of a
  monophonic pitch track [batch, time(, 1)]: each change of the quantized
  pitch starts a region. With note_on_only, regions of pitch 0 are zeroed.
  """
  if q_pitch.ndim == 3:
    q_pitch = q_pitch[:, :, 0]
  # Onsets and offsets; the ends count as region starts and ends.
  edges = torch.abs(diff(q_pitch, axis=1)) > 0
  edges = torch.nn.functional.pad(edges[:, :-1].to(torch.int32), (1, 0),
                                  value=1)
  edges = torch.nn.functional.pad(edges, (0, 1), value=0)
  # -1 so that region 0 is the first note.
  note_mask = _regions(torch.cumsum(edges, dim=1) - 1, max_regions)
  if note_on_only:
    note_pitches = get_note_moments(q_pitch, note_mask, return_std=False)
    note_mask = note_mask * (note_pitches > 0.0).to(torch.float32)[:, None, :]
  return note_mask


def get_note_mask_from_onset(q_pitch: torch.Tensor, onset: torch.Tensor,
                             max_regions: int = 100,
                             note_on_only: bool = True) -> torch.Tensor:
  """Binary mask of each note region, with regions started by onsets."""
  if q_pitch.ndim == 3:
    q_pitch = q_pitch[:, :, 0]
  if onset.ndim == 3:
    onset = onset[:, :, 0]
  edges = torch.nn.functional.pad(onset[:, 1:].to(torch.int32), (1, 0),
                                  value=1)
  note_mask = _regions(torch.cumsum(edges, dim=1) - 1, max_regions)
  if note_on_only:
    note_mask = note_mask * (q_pitch > 0.0).to(torch.float32)[:, :, None]
  return note_mask


def get_note_lengths(note_mask: torch.Tensor) -> torch.Tensor:
  """Length of each note: [batch, time, notes] -> [batch, notes]."""
  return torch.sum(note_mask, dim=1)


def get_note_moments(x: torch.Tensor, note_mask: torch.Tensor,
                     return_std: bool = True):
  """Mean (and standard deviation) of x [batch, time(, dims)] over each
  note of note_mask [batch, time, notes]: [batch, notes(, dims)]."""
  is_2d = x.ndim == 2
  if is_2d:
    x = x[:, :, None]
  note_mask_d = note_mask[..., None]  # [b, t, n, 1]
  note_lengths = torch.sum(note_mask_d, dim=1)  # [b, n, 1]
  x_masked = x[:, :, None, :] * note_mask_d  # [b, t, n, d]
  x_mean = safe_divide(torch.sum(x_masked, dim=1), note_lengths)
  numerator = (x[:, :, None, :] - x_mean[:, None, :, :]) * note_mask_d
  numerator = torch.sum(numerator**2.0, dim=1)
  x_std = safe_divide(numerator, note_lengths)**0.5
  if is_2d:
    x_mean, x_std = x_mean[:, :, 0], x_std[:, :, 0]
  return (x_mean, x_std) if return_std else x_mean


def pool_over_notes(x: torch.Tensor, note_mask: torch.Tensor,
                    return_std: bool = True):
  """Per-note average of x [batch, time, dims], spread back over time:
  [batch, time, dims] (mean, or (mean, std))."""
  x_notes, x_notes_std = get_note_moments(x, note_mask, return_std=True)
  pooled_mean = torch.sum(x_notes[:, None] * note_mask[..., None], dim=2)
  if return_std:
    return pooled_mean, torch.sum(
        x_notes_std[:, None] * note_mask[..., None], dim=2)
  return pooled_mean


def get_short_note_loss_mask(note_mask: torch.Tensor,
                             note_lengths: torch.Tensor,
                             note_pitches: torch.Tensor,
                             min_length: float = 40) -> torch.Tensor:
  """Binary [batch, time] mask of the notes shorter than min_length."""
  short_notes = torch.logical_and(note_lengths < min_length,
                                  note_pitches > 0.0).to(torch.float32)
  return torch.sum(note_mask * short_notes[:, None, :], dim=-1)
