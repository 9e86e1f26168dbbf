"""The evaluation and sampling loop (the train job's sidecar).

Port of ddsp_tpu/eval/eval_util.py: poll a train directory for new
checkpoints (the port's ckpt-<step>.pt, utils/checkpoints.py), restore each
with Trainer.restore, run a fixed set of batches through the model in eval
mode on the trainer's device (through the sequence-parallel forward when
the trainer's mesh shards time), hand them to the evaluators, and write
their scalars to <save_dir>/<mode>/metrics.jsonl.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ddsp_torch.eval.evaluators import (BaseEvaluator, BasicEvaluator,
                                        F0LdEvaluator,
                                        MidiAutoencoderEvaluator,
                                        MidiHeuristicEvaluator, TWMEvaluator)
from ddsp_torch.models.inverse_synthesis import InverseSynthesis
from ddsp_torch.models.midi_autoencoder import MidiAutoencoder
from ddsp_torch.parallel import sp_model
from ddsp_torch.train.train_loop import MetricsWriter
from ddsp_torch.utils import checkpoints

logger = logging.getLogger('ddsp_torch')


def checkpoints_iterator(restore_dir: str,
                         delay_secs: float = 10.0,
                         timeout_secs: Optional[float] = None,
                         run_once: bool = False):
  """Yield the step of each new latest checkpoint as it appears
  (filesystem polling)."""
  seen = set()
  start = time.time()
  while True:
    steps = checkpoints.checkpoint_steps(restore_dir)
    step = steps[-1] if steps else None
    if step is not None and step not in seen:
      seen.add(step)
      yield step
      if run_once:
        return
      start = time.time()
    else:
      if run_once and step is None:
        logger.warning('No checkpoint found in %s', restore_dir)
        return
      if timeout_secs is not None and time.time() - start > timeout_secs:
        return
      time.sleep(delay_secs)


def to_host(tree: Any) -> Any:
  """Tensors of a nested dict as numpy arrays (float32 for bf16)."""
  if isinstance(tree, dict):
    return {k: to_host(v) for k, v in tree.items()}
  if isinstance(tree, torch.Tensor):
    tree = tree.detach()
    if tree.dtype == torch.bfloat16:
      tree = tree.float()
    return tree.cpu().numpy()
  return tree


def default_evaluators(model, data_provider, device,
                       batch: Dict[str, Any]) -> List[BaseEvaluator]:
  """[BasicEvaluator, F0LdEvaluator] on `device`, as in the JAX loop.

  A MidiAutoencoder has no 'audio_synth' (the JAX loop's evaluators fail
  on its outputs with a KeyError): it gets BasicEvaluator on its audio
  ('synth_audio'), and MidiAutoencoderEvaluator and MidiHeuristicEvaluator
  where the batches carry the ground-truth 'note_active_velocities'.
  Likewise an InverseSynthesis model (its audio 'harm_audio', or
  'sin_audio' without a harmonic encoder) gets BasicEvaluator, and
  TWMEvaluator on its sinusoids where the batches carry an 'f0_hz' at its
  control frames (a self-supervised batch's).
  """
  rates = (data_provider.sample_rate, data_provider.frame_rate)
  if isinstance(model, InverseSynthesis):
    audio_key = 'sin_audio' if model.harmonic_encoder is None else (
        'harm_audio')
    evaluators = [BasicEvaluator(*rates, audio_key=audio_key)]
    f0_hz = batch.get('f0_hz')
    if f0_hz is not None and np.shape(f0_hz)[1] == model.n_frames:
      evaluators.append(TWMEvaluator(*rates, device=device))
    return evaluators
  if not isinstance(model, MidiAutoencoder):
    return [BasicEvaluator(*rates), F0LdEvaluator(*rates, device=device)]
  audio_key = 'midi_audio' if model.midi_decoder is None else 'synth_audio'
  evaluators = [BasicEvaluator(*rates, audio_key=audio_key)]
  if 'note_active_velocities' in batch:
    evaluators += [MidiAutoencoderEvaluator(*rates, db_key=model.db_key),
                   MidiHeuristicEvaluator(*rates)]
  return evaluators


def evaluate_or_sample(data_provider,
                       trainer,
                       save_dir: str,
                       restore_dir: Optional[str] = None,
                       mode: str = 'eval',
                       evaluators: Optional[Sequence[BaseEvaluator]] = None,
                       batch_size: int = 4,
                       num_batches: int = 4,
                       ckpt_delay_secs: float = 10.0,
                       run_once: bool = True,
                       run_until_step: int = 0,
                       noise: Optional[Any] = None) -> Dict[str, float]:
  """Run evaluation or sampling over checkpoints as they appear.

  Args:
    data_provider: DataProvider for eval batches.
    trainer: Trainer binding the model; its device is where the forward
      (and the default evaluators' loudness and CREPE) run.
    save_dir: Where to write summaries and samples.
    restore_dir: Checkpoint directory (defaults to save_dir).
    mode: 'eval' (metrics) or 'sample' (audio/image artifacts).
    evaluators: Evaluator instances; default `default_evaluators` (for
      most models [BasicEvaluator, F0LdEvaluator] on the trainer's
      device).
    batch_size: Eval batch size.
    num_batches: Batches per checkpoint.
    ckpt_delay_secs: Poll interval.
    run_once: Evaluate only the latest checkpoint then return.
    run_until_step: Stop when a checkpoint >= this step was evaluated.
    noise: The noise processors' noise (as the model's forward takes it).
      None draws it from a generator seeded with 0 on the trainer's
      device for every batch, as the JAX loop fixes PRNGKey(0).

  Returns:
    The scalars of the last checkpoint evaluated ({} in 'sample' mode).

  Raises:
    ValueError: for a trainer whose mesh shards time and a model that the
      sharded forward does not take (parallel.sp_model.check_sp_model).
    NotImplementedError: for a trainer on a mesh over ranks.
  """
  if mode not in ('eval', 'sample'):
    raise ValueError(f"mode must be 'eval' or 'sample', got {mode!r}.")
  mesh = getattr(trainer, 'mesh', None)
  if mesh is not None and mesh.ranks is not None:
    raise NotImplementedError(
        'Evaluating and sampling on a mesh over ranks is ROADMAP.md queue 1 '
        'item 8; evaluate the checkpoint in one process.')
  restore_dir = restore_dir or save_dir
  # On a mesh that shards time the batches go through the training step's
  # sequence-parallel forward, so a model trained at audio lengths that
  # need the shards is evaluated at that length too.
  use_sp = sp_model.has_time_sharding(mesh)
  if use_sp:
    sp_model.check_sp_model(trainer.model)

  # A fixed evaluation set: the same batches for every checkpoint, so the
  # metric curve follows the model, not the data.
  iterator = data_provider.get_batch(batch_size, shuffle=False, repeats=-1)
  eval_batches = [next(iterator) for _ in range(num_batches)]
  if evaluators is None:
    evaluators = default_evaluators(trainer.model, data_provider,
                                    trainer.device, eval_batches[0])
  state = trainer.init(eval_batches[0])
  writer = MetricsWriter(os.path.join(save_dir, mode))
  model = trainer.model
  scalars = {}
  try:
    for _ in checkpoints_iterator(restore_dir, ckpt_delay_secs,
                                  run_once=run_once):
      state = trainer.restore(state, restore_dir)
      step = int(state.step)
      logger.info('Evaluating checkpoint at step %d.', step)

      for batch_idx, batch in enumerate(eval_batches):
        t0 = time.time()
        generator = (torch.Generator(trainer.device).manual_seed(0)
                     if noise is None else None)
        # training=False; the losses are computed all the same
        # (return_losses=True), as the JAX loop computes them.
        with torch.no_grad():
          if use_sp:
            outputs, losses = sp_model.sp_forward_with_losses(
                model, trainer.to_device(batch), mesh,
                halo_impl=trainer.halo_impl, training=False, noise=noise,
                generator=generator)
          else:
            outputs, losses = model(trainer.to_device(batch),
                                    training=False, return_losses=True,
                                    noise=noise, generator=generator)
        outputs = to_host(outputs)
        losses = {k: float(v) for k, v in losses.items()}
        logger.info('Predictions for batch %d/%d took %.2fs',
                    batch_idx + 1, num_batches, time.time() - t0)
        host_batch = {k: np.asarray(v) for k, v in batch.items()}
        for evaluator in evaluators:
          if mode == 'eval':
            evaluator.evaluate(host_batch, outputs, losses)
          else:
            evaluator.sample(host_batch, outputs, save_dir, step)

      if mode == 'eval':
        scalars = {}
        for evaluator in evaluators:
          scalars.update(evaluator.flush(step))
        writer.scalars(step, scalars)

      if run_until_step and step >= run_until_step:
        break
  finally:
    writer.close()
  return scalars
