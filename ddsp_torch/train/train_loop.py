"""The training loop.

Port of ddsp_tpu/train/train_loop.py: iterate batches (each copied to the
device ahead of its step, data/prefetch.py), track mean losses,
log steps/sec, periodic checkpoints and summaries, early stop. Loss scalars
stay on the device between summary intervals, so the loop never waits for
the card inside an interval; `profile_dir` captures a torch.profiler trace
of steps [profile_start, profile_start + profile_steps).

Across ranks (a Trainer on a mesh over torch.distributed ranks) every rank
runs the loop on its own batches; rank 0 alone writes summaries and the
profiler trace, and Trainer.save has rank 0 write each checkpoint while
the others wait. The losses the step returns are already reduced over the
ranks, so early stopping reads the same value on every rank and they stop
at the same step.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import numpy as np
import torch

from ddsp_torch.data.prefetch import prefetch_to_device
from ddsp_torch.parallel import distributed
from ddsp_torch.train.trainer import Trainer, TrainState

logger = logging.getLogger('ddsp_torch')


class MetricsWriter:
  """Scalar metrics -> JSONL file (<log_dir>/metrics.jsonl), plus, with
  use_tensorboard, TensorBoard event files in log_dir where
  torch.utils.tensorboard imports (it needs the tensorboard package;
  without it the writer is JSONL only, as the JAX writer is without
  TensorFlow)."""

  def __init__(self, log_dir: str, use_tensorboard: bool = True):
    os.makedirs(log_dir, exist_ok=True)
    self._path = os.path.join(log_dir, 'metrics.jsonl')
    self._file = open(self._path, 'a')
    self._tb = None
    if not use_tensorboard:
      return
    try:
      from torch.utils.tensorboard import SummaryWriter  # pylint: disable=g-import-not-at-top
    except ImportError:
      logger.info('No tensorboard package: metrics go to %s only.',
                  self._path)
    else:
      self._tb = SummaryWriter(log_dir)

  def scalars(self, step: int, values: Dict[str, float]):
    record = {'step': int(step)}
    record.update({k: float(v) for k, v in values.items()})
    self._file.write(json.dumps(record) + '\n')
    self._file.flush()
    if self._tb is not None:
      for k, v in values.items():
        self._tb.add_scalar(k, float(v), int(step))
      self._tb.flush()

  def close(self):
    self._file.close()
    if self._tb is not None:
      self._tb.close()


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
          report_loss_to_hypertune: bool = False,
          profile_dir: Optional[str] = None,
          profile_start: int = 10,
          profile_steps: int = 10,
          log_every_step: bool = False,
          prefetch: int = 2) -> TrainState:
  """Main training loop.

  Args:
    data_iterator: Iterator yielding feature-dict batches (host arrays or
      tensors).
    trainer: A Trainer binding model and optimizer.
    num_steps: Total training steps.
    steps_per_summary: Interval for scalar summaries / steps-per-sec logs.
      Loss values only cross to the host at this interval.
    steps_per_save: Interval for checkpoints.
    save_dir: Where to write checkpoints/summaries; None disables saving.
    restore_dir: Where to restore from (defaults to save_dir).
    early_stop_loss_value: Stop early when the interval mean of total_loss
      is <= this value (checked at summary intervals).
    report_loss_to_hypertune: Accepted as the JAX loop accepts it (a
      placeholder there); not read. utils.cloud.report_metric_to_hypertune
      reports a metric.
    profile_dir: Capture a torch.profiler trace (chrome trace JSON) into
      this directory.
    profile_start: First step of the trace window.
    profile_steps: Number of steps to trace.
    log_every_step: Log losses every step (waits for the device each step;
      debug only).
    prefetch: Depth of the host-to-device prefetch
      (data.prefetch_to_device: pinned memory, a copy stream on CUDA, the
      reading in this thread after each step is enqueued); 0 moves each
      batch inside the step instead (Trainer.to_device).

  Returns:
    The final TrainState.
  """
  if prefetch:
    data_iterator = prefetch_to_device(data_iterator, size=prefetch,
                                       device=trainer.device)
  writes = distributed.rank() == 0
  if not writes:
    profile_dir = None
  writer = None
  profiler = None

  def stop_profiler():
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f'trace_step{profile_start}.json')
    profiler.export_chrome_trace(path)
    logger.info('Wrote profiler trace to %s', path)

  try:
    batch = next(data_iterator)
    state = trainer.init(batch)
    logger.info('Trainer initialized: %d params.', trainer.param_count(state))

    restore_dir = restore_dir or save_dir
    if restore_dir and os.path.isdir(restore_dir):
      state = trainer.restore(state, restore_dir)
      if state.step > 0:
        logger.info('Restored at step %d.', state.step)

    writer = MetricsWriter(save_dir) if save_dir and writes else None
    pending_losses: List[Dict[str, Any]] = []
    last_summary_time = time.time()
    last_summary_step = step = state.step

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
          distributed.check()
          torch.cuda.synchronize(trainer.device)
        stop_profiler()
        profiler = None
        profile_dir = None

      if log_every_step:
        distributed.check()
        logger.info('step: %d\t%s', step, '\t'.join(
            f'{k}: {float(v):.2f}' for k, v in losses.items()))

      if step % steps_per_summary == 0 and pending_losses:
        distributed.check()  # the loss read below waits for the device
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
    if prefetch:
      # Release the prefetched device batches on every exit: normal, early
      # stop or exception.
      data_iterator.close()
