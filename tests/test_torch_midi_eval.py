"""The MIDI eval stack of ddsp_torch against ddsp_tpu, on the CPU.

heuristics (segment_notes(_batch) with each binarizer and picker,
remove_short, pad_for_frame), the MIDI metrics (match_notes,
compute_note_metrics, compute_frame_metrics, the piano roll <-> note
sequence conversions, MidiMetrics with and without aligning to f0) and both
MIDI evaluators, on fixtures that pass through both packages: glides and
steps of f0 under an amplitude envelope with gaps, and piano rolls of the
nearest notes with shifted boundaries. Note sequences and counts must be
equal; every scalar is a ratio of integer counts, so exactly equal too.
power_pooled_outliers computes the power with each package's own spectral
ops (float32 STFTs): its binary output must be equal on this fixture.
Then the MIDI summaries: their files with matplotlib, the wavs alone
without it.
"""

import builtins
import os

import numpy as np
import pytest

from ddsp_tpu.eval import evaluators as j_evaluators
from ddsp_tpu.eval import heuristics as j_heur
from ddsp_tpu.eval import metrics as j_metrics
from ddsp_torch.eval import evaluators as t_evaluators
from ddsp_torch.eval import heuristics as t_heur
from ddsp_torch.eval import metrics as t_metrics
from ddsp_torch.eval import summaries as t_summaries

FRAME_RATE, T = 250, 500


def _controls(seed, batch=2):
  """Per-frame controls of a few notes: f0 in steps (with a glide and
  vibrato), amplitudes with near-silent gaps between notes, and the audio
  of those controls, (T - 1) hops long: the power's centred frames are
  then T, as the binarizers combine them frame by frame."""
  rng = np.random.RandomState(seed)
  f0 = np.zeros((batch, T), np.float64)
  amps = np.full((batch, T), 1e-4)
  for b in range(batch):
    t = 10
    while t < T - 40:
      n = rng.randint(30, 120)
      end = min(t + n, T - 5)
      pitch = rng.randint(48, 72) + 0.1 * rng.randn()
      f0[b, t:end] = 440.0 * 2**((pitch - 69) / 12 + 0.01 * np.sin(
          np.arange(end - t) / 5.0))
      amps[b, t:end] = 0.5 + 0.1 * rng.rand()
      gap = rng.randint(0, 15)
      f0[b, end:end + gap] = f0[b, end - 1]  # f0 held through short gaps
      t = end + gap
  f0 = np.where(f0 > 0, f0, 200.0)
  hop = 16000 // FRAME_RATE
  phase = 2 * np.pi * np.cumsum(np.repeat(f0, hop, axis=1), axis=1) / 16000
  audio = (np.repeat(amps, hop, axis=1) * np.sin(phase))[:, :-hop]
  return {'f0_hz': f0.astype(np.float32)[..., None],
          'harmonic': {'controls': {
              'amplitudes': amps.astype(np.float32)[..., None]}},
          'audio': audio.astype(np.float32)}


def _roll(f0_hz, amps, shift=0):
  """A piano roll of the nearest note where the amplitude is up, its
  boundaries moved by `shift` frames."""
  midi = np.round(12 * np.log2(f0_hz[..., 0] / 440.0) + 69).astype(int)
  on = amps[..., 0] > 1e-2
  roll = np.zeros(f0_hz.shape[:2] + (128,), np.float32)
  for b in range(roll.shape[0]):
    for t in range(roll.shape[1]):
      src = min(max(t - shift, 0), roll.shape[1] - 1)
      if on[b, src]:
        roll[b, t, midi[b, src]] = 90.0
  return roll


def _same_sequences(seqs_t, seqs_j):
  assert len(seqs_t) == len(seqs_j)
  for s_t, s_j in zip(seqs_t, seqs_j):
    assert [(n.pitch, n.start_time, n.end_time, n.velocity)
            for n in s_t.notes] == [(n.pitch, n.start_time, n.end_time,
                                     n.velocity) for n in s_j.notes]
    assert s_t.total_time == s_j.total_time


@pytest.mark.parametrize('binarize', ['midi_heuristic',
                                      'midi_heuristic_power',
                                      'amp_pooled_outliers',
                                      'strided_freq_change'])
@pytest.mark.parametrize('pick_f0', ['mean_f0', 'median_f0'])
def test_segment_notes_batch(binarize, pick_f0):
  controls = _controls(0)
  seqs = []
  for heur in (t_heur, j_heur):
    seqs.append(heur.segment_notes_batch(
        binarize_f=getattr(heur, binarize),
        pick_f0_f=getattr(heur, pick_f0), pick_amps_f=heur.median_amps,
        controls_batch=controls, frame_rate=FRAME_RATE))
  _same_sequences(*seqs)
  assert sum(len(s.notes) for s in seqs[0]) >= 4


@pytest.mark.parametrize('mode', ['front', 'center', 'end'])
def test_pad_for_frame_and_remove_short(mode):
  rng = np.random.RandomState(1)
  vec = rng.randn(37)
  for width in (1, 4, 9):
    np.testing.assert_array_equal(t_heur.pad_for_frame(vec, mode, width),
                                  j_heur.pad_for_frame(vec, mode, width))
  on = rng.rand(200) > 0.3
  for glue_back in (False, True):
    for min_samples in (2, 5):
      np.testing.assert_array_equal(
          t_heur.remove_short(on.copy(), min_samples, glue_back),
          j_heur.remove_short(on.copy(), min_samples, glue_back))
  with pytest.raises(ValueError, match='pad mode'):
    t_heur.pad_for_frame(vec, 'middle', 3)


def test_note_metrics_and_conversions():
  controls = _controls(2, batch=1)
  amps = controls['harmonic']['controls']['amplitudes']
  gt, pred = _roll(controls['f0_hz'], amps)[0], _roll(
      controls['f0_hz'], amps, shift=3)[0]
  pred[200:230] = 0.0
  seq = {}
  for name, m in (('t', t_metrics), ('j', j_metrics)):
    gt_seq = m.pianoroll_to_note_sequence(gt, FRAME_RATE)
    pred_seq = m.pianoroll_to_note_sequence(pred, FRAME_RATE)
    counts = m.compute_note_metrics(gt_seq, pred_seq)
    frame = m.compute_frame_metrics(gt, pred)
    back = m.note_sequence_to_pianoroll(pred_seq, FRAME_RATE, n_frames=T)
    iv = m.sequence_to_intervals(pred_seq)
    seq[name] = (gt_seq, pred_seq, [(c.tp, c.fp, c.fn) for c in counts],
                 (frame.tp, frame.fp, frame.fn), back, iv)
  _same_sequences(seq['t'][:2], seq['j'][:2])
  assert seq['t'][2] == seq['j'][2]
  assert seq['t'][3] == seq['j'][3]
  np.testing.assert_array_equal(seq['t'][4], seq['j'][4])
  for a, b in zip(seq['t'][5], seq['j'][5]):
    np.testing.assert_array_equal(a, b)
  ref = np.array([[0.0, 1.0], [1.0, 1.5]])
  est = np.array([[0.03, 1.1], [1.2, 1.5]])
  for kw in (dict(), dict(offset_ratio=None), dict(onset_tolerance=0.3)):
    assert t_metrics.match_notes(ref, np.array([220., 330.]), est,
                                 np.array([221., 330.]), **kw) == \
        j_metrics.match_notes(ref, np.array([220., 330.]), est,
                              np.array([221., 330.]), **kw)


@pytest.mark.parametrize('align', [True, False])
def test_midi_metrics(align):
  controls = _controls(3)
  amps = controls['harmonic']['controls']['amplitudes']
  batch = {'note_active_velocities': _roll(controls['f0_hz'], amps),
           'f0_hz': controls['f0_hz']}
  pred = _roll(controls['f0_hz'], amps, shift=2)
  results = []
  for m in (t_metrics, j_metrics):
    mm = m.MidiMetrics(FRAME_RATE, 'x', align_midi_with_f0=align)
    mm.update_state(batch, pred)
    results.append(mm.flush(step=1))
  assert results[0] == results[1]
  assert 0 < results[0]['metrics/midi/x/onset/f1'] <= 1


def test_evaluators_match_jax(tmp_path):
  """Both MIDI evaluators on one outputs dict (the model's piano roll,
  controls and ground truth), and MidiAutoencoderEvaluator's samples."""
  controls = _controls(4)
  amps = controls['harmonic']['controls']['amplitudes']
  rng = np.random.RandomState(5)
  outputs = dict(controls)
  outputs.update({
      'note_active_velocities': _roll(controls['f0_hz'], amps),
      'pianoroll': (_roll(controls['f0_hz'], amps, shift=1) > 0).astype(
          np.float32),
      'q_pitch': np.full((2, T, 1), 60.0, np.float32),
      'f0_midi_pred': np.full((2, T, 1), 60.2, np.float32),
      'amps': rng.rand(2, T, 1).astype(np.float32),
      'hd': rng.rand(2, T, 4).astype(np.float32),
      'noise': rng.rand(2, T, 3).astype(np.float32),
      'amps_pred': rng.rand(2, T, 1).astype(np.float32),
      'hd_pred': rng.rand(2, T, 4).astype(np.float32),
      'noise_pred': rng.rand(2, T, 3).astype(np.float32),
      'synth_audio': controls['audio'], 'midi_audio': controls['audio'],
  })
  scalars = []
  for ev_mod in (t_evaluators, j_evaluators):
    evs = [ev_mod.MidiAutoencoderEvaluator(frame_rate=FRAME_RATE),
           ev_mod.MidiHeuristicEvaluator(frame_rate=FRAME_RATE)]
    out = {}
    for ev in evs:
      ev.evaluate({}, outputs, {})
      out.update(ev.flush(step=0))
    scalars.append(out)
  assert scalars[0] == scalars[1]
  assert len(scalars[0]) == 18
  batch = {'audio': controls['audio'], 'f0_hz': controls['f0_hz'],
           'loudness_db': np.full((2, T, 1), -30.0, np.float32)}
  ev = t_evaluators.MidiAutoencoderEvaluator(frame_rate=FRAME_RATE)
  ev.sample(batch, outputs, str(tmp_path), step=7)
  ev.sample(batch, outputs, str(tmp_path), step=7)
  out_dir = tmp_path / 'samples' / 'step_7'
  for i in range(4):
    for name in ('midi_audio.wav', 'synth_audio.wav', 'midiae_f0.png',
                 'midiae_ld.png', 'midiae_hd.png'):
      assert (out_dir / f'{i}_{name}').exists(), (i, name)


def test_summaries_skip_figures_without_matplotlib(tmp_path, monkeypatch):
  """The card's machine has no matplotlib: the wavs are written, the
  figures skipped, nothing raises."""
  real_import = builtins.__import__

  def no_matplotlib(name, *args, **kwargs):
    if name.startswith('matplotlib'):
      raise ImportError(name)
    return real_import(name, *args, **kwargs)

  monkeypatch.setattr(builtins, '__import__', no_matplotlib)
  controls = _controls(6, batch=1)
  outputs = {'q_pitch': np.full((1, T, 1), 60.0, np.float32),
             'f0_midi_pred': np.full((1, T, 1), 60.0, np.float32),
             'amps': np.ones((1, T, 1), np.float32),
             'hd': np.ones((1, T, 2), np.float32),
             'noise': np.ones((1, T, 2), np.float32),
             'synth_audio': controls['audio'],
             'midi_audio': controls['audio']}
  batch = {'audio': controls['audio'], 'f0_hz': controls['f0_hz']}
  t_evaluators.MidiAutoencoderEvaluator(frame_rate=FRAME_RATE).sample(
      batch, outputs, str(tmp_path), step=1)
  roll = np.zeros((T, 128), np.float32)
  t_summaries.pianoroll_summary(str(tmp_path / 'roll.png'), roll)
  t_summaries.midi_summary(str(tmp_path / 'midi.png'),
                           t_metrics.pianoroll_to_note_sequence(roll, 250))
  files = sorted(os.listdir(tmp_path / 'samples' / 'step_1'))
  assert files == ['0_midi_audio.wav', '0_original.wav', '0_synth_audio.wav']
  assert not (tmp_path / 'roll.png').exists()
