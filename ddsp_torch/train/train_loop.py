"""The training loop.

Port of ddsp_tpu/train/train_loop.py: iterate batches, track mean losses,
log steps/sec, periodic checkpoints and summaries, early stop. Loss scalars
stay on the device between summary intervals, so the loop never waits for
the card inside an interval; `profile_dir` captures a torch.profiler trace
of steps [profile_start, profile_start + profile_steps).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ddsp_torch.train.trainer import Trainer, TrainState

logger = logging.getLogger('ddsp_torch')


class MetricsWriter:
  """Scalar metrics -> JSONL file (<log_dir>/metrics.jsonl)."""

  def __init__(self, log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    self._path = os.path.join(log_dir, 'metrics.jsonl')
    self._file = open(self._path, 'a')

  def scalars(self, step: int, values: Dict[str, float]):
    record = {'step': int(step)}
    record.update({k: float(v) for k, v in values.items()})
    self._file.write(json.dumps(record) + '\n')
    self._file.flush()

  def close(self):
    self._file.close()


def _interval_means(pending: List[Dict[str, torch.Tensor]]) -> Dict[str,
                                                                     float]:
  """Mean of each loss over an interval, in one transfer to the host."""
  keys = list(pending[0])
  stacked = torch.stack([torch.stack([torch.as_tensor(p[k]).float()
                                      for k in keys]) for p in pending])
  means = stacked.mean(dim=0).cpu().numpy()
  return {k: float(v) for k, v in zip(keys, means)}


def train(data_iterator: Iterator[Dict[str, Any]],
          trainer: Trainer,
          num_steps: int = 1000000,
          steps_per_summary: int = 300,
          steps_per_save: int = 300,
          save_dir: Optional[str] = None,
          restore_dir: Optional[str] = None,
          early_stop_loss_value: Optional[float] = None,
          profile_dir: Optional[str] = None,
          profile_start: int = 10,
          profile_steps: int = 10,
          log_every_step: bool = False) -> TrainState:
  """Main training loop.

  Args:
    data_iterator: Iterator yielding feature-dict batches (host arrays or
      tensors); each batch is moved to the trainer's device as it is used.
    trainer: A Trainer binding model and optimizer.
    num_steps: Total training steps.
    steps_per_summary: Interval for scalar summaries / steps-per-sec logs.
      Loss values only cross to the host at this interval.
    steps_per_save: Interval for checkpoints.
    save_dir: Where to write checkpoints/summaries; None disables saving.
    restore_dir: Where to restore from (defaults to save_dir).
    early_stop_loss_value: Stop early when the interval mean of total_loss
      is <= this value (checked at summary intervals).
    profile_dir: Capture a torch.profiler trace (chrome trace JSON) into
      this directory.
    profile_start: First step of the trace window.
    profile_steps: Number of steps to trace.
    log_every_step: Log losses every step (waits for the device each step;
      debug only).

  Returns:
    The final TrainState.
  """
  batch = next(data_iterator)
  state = trainer.init(batch)
  logger.info('Trainer initialized: %d params.', trainer.param_count(state))

  restore_dir = restore_dir or save_dir
  if restore_dir and os.path.isdir(restore_dir):
    state = trainer.restore(state, restore_dir)
    if state.step > 0:
      logger.info('Restored at step %d.', state.step)

  writer = MetricsWriter(save_dir) if save_dir else None
  pending_losses: List[Dict[str, Any]] = []
  last_summary_time = time.time()
  last_summary_step = step = state.step
  profiler = None

  def stop_profiler():
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f'trace_step{profile_start}.json')
    profiler.export_chrome_trace(path)
    logger.info('Wrote profiler trace to %s', path)

  try:
    while step < num_steps:
      if profile_dir and step == profile_start and profiler is None:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if trainer.device.type == 'cuda':
          activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

      state, losses = trainer.train_step(state, batch)
      step += 1
      exhausted = False
      if step < num_steps:
        # Don't pull past the end: a finite iterator with exactly enough
        # batches would raise StopIteration here and skip the final save.
        try:
          batch = next(data_iterator)
        except StopIteration:
          logger.info('Data iterator exhausted at step %d.', step)
          exhausted = True
      pending_losses.append(losses)
      if exhausted:
        break

      if profiler is not None and step >= profile_start + profile_steps:
        if trainer.device.type == 'cuda':
          torch.cuda.synchronize(trainer.device)
        stop_profiler()
        profiler = None
        profile_dir = None

      if log_every_step:
        logger.info('step: %d\t%s', step, '\t'.join(
            f'{k}: {float(v):.2f}' for k, v in losses.items()))

      if step % steps_per_summary == 0 and pending_losses:
        mean_losses = _interval_means(pending_losses)
        elapsed = time.time() - last_summary_time
        steps_per_sec = (step - last_summary_step) / max(elapsed, 1e-9)
        logger.info('step: %d\tsteps/s: %.2f\t%s', step, steps_per_sec,
                    '\t'.join(f'{k}: {v:.2f}'
                              for k, v in mean_losses.items()))
        if writer:
          writer.scalars(step, dict(mean_losses,
                                    steps_per_sec=steps_per_sec))
        mean_total = float(mean_losses.get('total_loss', np.inf))
        pending_losses = []
        last_summary_time = time.time()
        last_summary_step = step

        # Stop on the interval MEAN of the total loss, not a single noisy
        # step.
        if (early_stop_loss_value is not None
            and mean_total <= early_stop_loss_value):
          logger.info('Total loss reached early stop value %s at step %d.',
                      early_stop_loss_value, step)
          break

      if save_dir and step % steps_per_save == 0:
        save_time = trainer.save(state, save_dir)
        logger.info('Saved checkpoint at step %d (%.2fs).', step, save_time)

    if save_dir:
      trainer.save(state, save_dir)
    logger.info('Training finished at step %d.', step)
    return state
  finally:
    if profiler is not None:
      stop_profiler()
    if writer:
      writer.close()
