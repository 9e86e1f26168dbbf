"""Evaluator classes dispatched by the eval loop.

Port of ddsp_tpu/eval/evaluators.py: BaseEvaluator, BasicEvaluator,
F0LdEvaluator, TWMEvaluator, MidiAutoencoderEvaluator and
MidiHeuristicEvaluator. Evaluators take host (numpy) batches and outputs.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict

import numpy as np
import torch

from ddsp_torch.eval import heuristics
from ddsp_torch.eval import metrics as metrics_lib
from ddsp_torch.eval import summaries
from ddsp_torch.utils.device import DeviceLike, resolve_device

logger = logging.getLogger('ddsp_torch')


class BaseEvaluator:
  """Base class for evaluators: evaluate() metrics, sample() artifacts."""

  def __init__(self, sample_rate: int = 16000, frame_rate: int = 250):
    self._sample_rate = sample_rate
    self._frame_rate = frame_rate
    self._sample_cursor = (None, 0)  # (step, global example offset)

  def _next_sample_offset(self, step: int, batch_len: int) -> int:
    """Global example offset for this step's next sample batch.

    sample() is called once per eval batch; without an offset each batch
    would overwrite the previous one's artifact files in step_<step>/.
    """
    last_step, offset = self._sample_cursor
    if last_step != step:
      offset = 0
    self._sample_cursor = (step, offset + batch_len)
    return offset

  def evaluate(self, batch: Dict[str, Any], outputs: Dict[str, Any],
               losses: Dict[str, float]):
    """Accumulate metrics for one batch."""

  def sample(self, batch: Dict[str, Any], outputs: Dict[str, Any],
             save_dir: str, step: int):
    """Write sample artifacts for one batch."""

  def flush(self, step: int) -> Dict[str, float]:
    """Aggregate, log, and reset; returns scalars."""
    return {}


class BasicEvaluator(BaseEvaluator):
  """Mean losses + audio sample artifacts (of outputs[audio_key]; the
  MIDI autoencoders' audio is 'synth_audio')."""

  def __init__(self, sample_rate=16000, frame_rate=250,
               audio_key: str = 'audio_synth'):
    super().__init__(sample_rate, frame_rate)
    self._loss_sums: Dict[str, list] = {}
    self._audio_key = audio_key

  def evaluate(self, batch, outputs, losses):
    for k, v in losses.items():
      self._loss_sums.setdefault(k, []).append(float(v))

  def sample(self, batch, outputs, save_dir, step):
    audio_gen = np.asarray(outputs[self._audio_key])
    offset = self._next_sample_offset(step, len(audio_gen))
    if 'audio' not in batch:
      # A self-supervised batch holds controls: its original is the audio
      # the model synthesized from them (outputs['audio']).
      batch = dict(batch, audio=outputs['audio'])
    summaries.sample_batch(save_dir, step, batch, audio_gen,
                           self._sample_rate, offset=offset)

  def flush(self, step):
    results = {f'losses/{k}': float(np.mean(v))
               for k, v in self._loss_sums.items() if v}
    for k, v in results.items():
      logger.info('step %d %s = %.4f', step, k, v)
    self._loss_sums = {}
    return results


class F0LdEvaluator(BaseEvaluator):
  """Loudness and f0 metrics.

  Two pitch measurements:
    * metrics/f0/*: the f0 control the model synthesized with vs the
      dataset f0, only when the DAG exposes it.
    * metrics/f0_{yin,crepe}/*: the pitch track of the generated audio
      (f0_dist, RPA/RCA, outlier_ratio). The estimator defaults to 'auto':
      CREPE (with Viterbi) when weights exist ($CREPE_WEIGHTS_DIR or the
      committed assets/crepe), else the weights-free YIN tracker
      (metrics.compute_f0_yin), so pitch metrics are always reported.

  Args:
    f0_estimator: 'auto', 'yin', 'crepe', or None (disable audio-pitch
      metrics).
    run_f0_crepe: Alias for f0_estimator='crepe'.
    device: Where loudness and CREPE run (CUDA unless the caller says
      otherwise).
  """

  def __init__(self, sample_rate=16000, frame_rate=250,
               run_f0_crepe: bool = False, f0_estimator='auto',
               device: DeviceLike = None):
    super().__init__(sample_rate, frame_rate)
    self._loudness_metrics = metrics_lib.LoudnessMetrics(
        sample_rate, frame_rate, device=device)
    self._f0_metrics = metrics_lib.F0Metrics(sample_rate, frame_rate)
    if run_f0_crepe:
      f0_estimator = 'crepe'
    if f0_estimator == 'auto':
      f0_estimator = ('crepe' if metrics_lib.crepe_weights_available()
                      else 'yin')
    self._f0_gen_metrics = None
    if f0_estimator is not None:
      self._f0_gen_metrics = metrics_lib.F0GenMetrics(
          sample_rate, frame_rate, estimator=f0_estimator, device=device)
    self._warned_no_f0 = False

  def evaluate(self, batch, outputs, losses):
    audio_gen = np.asarray(outputs['audio_synth'])
    self._loudness_metrics.update_state(batch, audio_gen)
    # f0 the model synthesized with, when the DAG exposes it.
    f0_synth = None
    if 'harmonic' in outputs:
      controls = outputs['harmonic'].get('controls', {})
      f0_synth = controls.get('f0_hz')
    if f0_synth is not None and 'f0_hz' in batch:
      self._f0_metrics.update_state(batch, np.asarray(f0_synth))
    # Pitch of the generated audio itself (not just the control input).
    if self._f0_gen_metrics is not None:
      self._f0_gen_metrics.update_state(batch, audio_gen)
    elif f0_synth is None and not self._warned_no_f0:
      # With the estimator disabled and no synth-exposed f0 the evaluator
      # narrows to loudness only: said once, so a missing pitch column in
      # eval results is not mistaken for a perfect one.
      self._warned_no_f0 = True
      logger.warning(
          'F0LdEvaluator: model outputs expose no f0 control and '
          'f0_estimator=None - skipping all pitch metrics (f0_dist, '
          'raw_pitch_accuracy, raw_chroma_accuracy); only loudness will '
          'be reported.')

  def flush(self, step):
    results = {}
    results.update(self._loudness_metrics.flush(step))
    results.update(self._f0_metrics.flush(step))
    if self._f0_gen_metrics is not None:
      results.update(self._f0_gen_metrics.flush(step))
    return results


class TWMEvaluator(BaseEvaluator):
  """F0 metrics of f0s that the TWM heuristic picks from the sinusoids.

  Every predicted sinusoid frequency is an f0 candidate, and
  TWMLoss.predict_f0 picks the best. The processor group's controls
  (outputs[processor_name]['controls']) go to `device` (CUDA unless the
  caller says otherwise), where the [batch, time, candidate, partial,
  component] mixture terms are evaluated (1.2 GB at 4 x 250 frames of 100
  sinusoids); only the per-candidate losses come back to the host.
  """

  def __init__(self, sample_rate=16000, frame_rate=250,
               processor_name: str = 'sinusoidal', noisy: bool = False,
               device: DeviceLike = None):
    super().__init__(sample_rate, frame_rate)
    self._noisy = noisy
    self._processor_name = processor_name
    self._device = resolve_device(device)
    self._f0_twm_metrics = metrics_lib.F0Metrics(
        sample_rate=sample_rate, frame_rate=frame_rate, name='f0_twm')

  def compute_twm_f0(self, outputs) -> np.ndarray:
    """The TWM f0 of each frame, [batch, time, 1] on the host."""
    from ddsp_torch.losses import TWMLoss  # pylint: disable=g-import-not-at-top
    controls = outputs[self._processor_name]['controls']
    freqs = np.asarray(controls['frequencies'], np.float32)
    amps = np.asarray(controls['amplitudes'], np.float32)
    if self._noisy:
      amps = amps * (1.0 - np.asarray(controls['noise_ratios'], np.float32))
    freqs = torch.from_numpy(freqs).to(self._device)
    return TWMLoss().predict_f0(freqs, freqs,
                                torch.from_numpy(amps).to(self._device))

  def evaluate(self, batch, outputs, losses):
    del losses
    self._f0_twm_metrics.update_state(batch, self.compute_twm_f0(outputs))

  def flush(self, step):
    return self._f0_twm_metrics.flush(step)


class MidiAutoencoderEvaluator(BaseEvaluator):
  """MIDI note metrics of the model's piano roll, and audio and plot
  artifacts, for the MidiAutoencoder. The ground truth is the outputs'
  'note_active_velocities' (the batch's, passed through the model)."""

  def __init__(self, sample_rate=16000, frame_rate=250,
               db_key='loudness_db', f0_key='f0_hz'):
    super().__init__(sample_rate, frame_rate)
    self._midi_metrics = metrics_lib.MidiMetrics(
        frames_per_second=frame_rate, tag='learned')
    self._db_key = db_key
    self._f0_key = f0_key

  def evaluate(self, batch, outputs, losses):
    del losses
    self._midi_metrics.update_state(outputs,
                                    np.asarray(outputs['pianoroll']))

  def sample(self, batch, outputs, save_dir, step):
    offset = self._next_sample_offset(step, len(batch['audio']))
    for k in ['midi_audio', 'synth_audio']:
      if k in outputs and outputs[k] is not None:
        summaries.sample_batch(save_dir, step, batch,
                               np.asarray(outputs[k]), self._sample_rate,
                               name=k, offset=offset)
    # Pitch, loudness and synth-control plots, numbered by the same global
    # offset so that successive eval batches keep their figures.
    out_dir = os.path.join(save_dir, 'samples', f'step_{step}')
    if self._f0_key in batch:
      summaries.midiae_f0_summary(out_dir, np.asarray(batch[self._f0_key]),
                                  outputs, offset=offset)
    if self._db_key in batch:
      summaries.midiae_ld_summary(out_dir, np.asarray(batch[self._db_key]),
                                  outputs, db_key=self._db_key,
                                  offset=offset)
    summaries.midiae_sp_summary(out_dir, outputs, offset=offset)

  def flush(self, step):
    return self._midi_metrics.flush(step)


class MidiHeuristicEvaluator(BaseEvaluator):
  """MIDI note metrics of notes segmented by heuristics from the synth
  controls (midi_heuristic, mean f0, median amplitude)."""

  def __init__(self, sample_rate=16000, frame_rate=250):
    super().__init__(sample_rate, frame_rate)
    self._midi_metrics = metrics_lib.MidiMetrics(
        tag='heuristic', frames_per_second=frame_rate)

  def compute_heuristic_notes(self, outputs):
    """One heuristics.NoteSequence per example of the outputs."""
    return heuristics.segment_notes_batch(
        binarize_f=heuristics.midi_heuristic,
        pick_f0_f=heuristics.mean_f0,
        pick_amps_f=heuristics.median_amps,
        controls_batch=outputs,
        frame_rate=self._frame_rate)

  def evaluate(self, batch, outputs, losses):
    del losses
    self._midi_metrics.update_state(outputs,
                                    self.compute_heuristic_notes(outputs))

  def flush(self, step):
    return self._midi_metrics.flush(step)
