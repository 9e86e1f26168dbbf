"""The evaluation and sampling loop (the train job's sidecar).

Port of ddsp_tpu/eval/eval_util.py: poll a train directory for new
checkpoints (the port's ckpt-<step>.pt, utils/checkpoints.py), restore each
with Trainer.restore, run a fixed set of batches through the model in eval
mode on the trainer's device (through the sequence-parallel forward when
the trainer's mesh shards time), hand them to the evaluators, and write
their scalars to <save_dir>/<mode>/metrics.jsonl.

On a mesh over torch.distributed ranks every rank reads the same fixed
eval set and runs the forward on its part of each batch; the outputs are
gathered into the global batch (`gather_outputs`), and rank 0 alone runs
the evaluators and writes. Every rank returns the same scalars.
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
from ddsp_torch.parallel import distributed, sp_model
from ddsp_torch.parallel import mesh as mesh_lib
from ddsp_torch.proc.synths import RowDraws
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


def _time_local_ids(outputs: Dict[str, Any]) -> set:
  """The ids of the time-local leaves of a sharded forward's outputs on a
  rank that shares its data rows: every processor node's signal
  ('audio_synth' among them) and the controls that are such signals."""
  signals = {id(v['signal']) for v in outputs.values()
             if isinstance(v, dict) and set(v) == {'signal', 'controls'}}

  def leaves(tree):
    if isinstance(tree, dict):
      for v in tree.values():
        yield from leaves(v)
    elif isinstance(tree, torch.Tensor):
      yield tree

  return {id(x) for x in leaves(outputs) if id(x) in signals}


def gather_outputs(outputs: Any, mesh, local_batch: int) -> Any:
  """A rank's forward outputs assembled into the global batch's.

  Collective: every rank calls it with outputs of the same structure. The
  rule: a tensor leaf whose first dim is the rank's `local_batch` rows is
  gathered over every rank, one block for each shard of the rank's run.
  The time-local leaves of a sharded forward on a rank that shares its
  data rows (each processor node's signal, 'audio_synth', and the controls
  that are those signals) are joined along the samples over each row's
  shards, then the rows over the data rows; every other leaf (the
  features, the frame-rate controls, the controls of a node that gathered
  its inputs) is replicated over 'time' and read from the row's first
  shard, then joined over the data rows.
  Other leaves are the same on every rank and kept. bf16 leaves come back
  float32.
  """
  distributed.check()  # the gather waits for the device
  ranks = mesh.ranks
  time_local = _time_local_ids(outputs) if ranks.shares_rows else set()
  done = {}

  def gather(tree):
    if isinstance(tree, dict):
      return {k: gather(v) for k, v in tree.items()}
    if not (isinstance(tree, torch.Tensor) and tree.ndim
            and tree.shape[0] == local_batch):
      return tree
    if id(tree) not in done:
      x = tree.detach()
      x = x.float() if x.dtype == torch.bfloat16 else x
      done[id(tree)] = mesh_lib.gather_local(
          mesh, x, time_local=id(tree) in time_local)
    return done[id(tree)]

  return gather(outputs)


def _checkpoint_steps(restore_dir, delay_secs, run_once, ranks):
  """checkpoints_iterator's steps; across ranks, rank 0's, broadcast."""
  if ranks is None:
    yield from checkpoints_iterator(restore_dir, delay_secs,
                                    run_once=run_once)
    return
  steps = (checkpoints_iterator(restore_dir, delay_secs, run_once=run_once)
           if ranks.rank == 0 else None)
  while True:
    step = distributed.broadcast_object(
        next(steps, None) if steps is not None else None)
    if step is None:
      return
    yield step


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
      device). Across ranks only rank 0's are used.
    batch_size: Eval batch size: the global batch across ranks, which
      must divide over the mesh's data rows.
    num_batches: Batches per checkpoint.
    ckpt_delay_secs: Poll interval.
    run_once: Evaluate only the latest checkpoint then return.
    run_until_step: Stop when a checkpoint >= this step was evaluated.
    noise: The noise processors' noise (as the model's forward takes it,
      for the global batch: across ranks each rank keeps its rows). None
      draws it from a generator seeded with 0 on the trainer's device for
      every batch, as the JAX loop fixes PRNGKey(0); across ranks each rank
      draws the global batch's and keeps its rows (RowDraws).

  Returns:
    The scalars of the last checkpoint evaluated ({} in 'sample' mode).

  Raises:
    ValueError: for a trainer whose mesh shards time and a model that the
      sharded forward does not take (parallel.sp_model.check_sp_model).
  """
  if mode not in ('eval', 'sample'):
    raise ValueError(f"mode must be 'eval' or 'sample', got {mode!r}.")
  mesh = getattr(trainer, 'mesh', None)
  ranks = mesh.ranks if mesh is not None else None
  writes = ranks is None or ranks.rank == 0
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
  if evaluators is None and writes:
    evaluators = default_evaluators(trainer.model, data_provider,
                                    trainer.device, eval_batches[0])
  state = trainer.init(eval_batches[0])
  writer = MetricsWriter(os.path.join(save_dir, mode)) if writes else None
  model = trainer.model
  if ranks is not None:
    rows = mesh_lib.local_rows(mesh, batch_size)
    if noise is not None:
      noise = noise[rows]
  scalars = {}
  try:
    for _ in _checkpoint_steps(restore_dir, ckpt_delay_secs, run_once,
                               ranks):
      state = trainer.restore(state, restore_dir)
      if ranks is not None:  # rank 0's checkpoint, whatever the others read
        mesh_lib.replicate(mesh, list(state.params.values()))
        state.step = distributed.broadcast_object(int(state.step))
      step = int(state.step)
      logger.info('Evaluating checkpoint at step %d.', step)

      for batch_idx, batch in enumerate(eval_batches):
        t0 = time.time()
        generator = None
        if noise is None:
          generator = (RowDraws(trainer.device) if ranks is not None
                       else torch.Generator(trainer.device)).manual_seed(0)
          if ranks is not None:
            generator.n_rows, generator.rows = batch_size, rows
        features = trainer.to_device(mesh_lib.shard_batch(mesh, batch)
                                     if ranks is not None else batch)
        # training=False; the losses are computed all the same
        # (return_losses=True), as the JAX loop computes them.
        with torch.no_grad():
          if use_sp:
            outputs, losses = sp_model.sp_forward_with_losses(
                model, features, mesh, halo_impl=trainer.halo_impl,
                training=False, noise=noise, generator=generator)
          else:
            outputs, losses = model(features, training=False,
                                    return_losses=True, noise=noise,
                                    generator=generator)
          if ranks is not None:
            if not use_sp:  # each rank's losses are its rows' means
              losses = dict(zip(losses, distributed.mean_over_ranks(
                  list(losses.values()))))
            outputs = gather_outputs(outputs, mesh, rows.stop - rows.start)
        outputs = to_host(outputs)
        losses = {k: float(v) for k, v in losses.items()}
        logger.info('Predictions for batch %d/%d took %.2fs',
                    batch_idx + 1, num_batches, time.time() - t0)
        if not writes:
          continue
        host_batch = {k: np.asarray(v) for k, v in batch.items()}
        for evaluator in evaluators:
          if mode == 'eval':
            evaluator.evaluate(host_batch, outputs, losses)
          else:
            evaluator.sample(host_batch, outputs, save_dir, step)

      if mode == 'eval':
        scalars = {}
        if writes:
          for evaluator in evaluators:
            scalars.update(evaluator.flush(step))
          writer.scalars(step, scalars)
        if ranks is not None:
          scalars = distributed.broadcast_object(scalars)

      if run_until_step and step >= run_until_step:
        break
  finally:
    if writer is not None:
      writer.close()
  return scalars
