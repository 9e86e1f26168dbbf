"""Faults planted in the program underneath a run, for the readings that
set the limits of `correct` (calibrate.py) and for the tests that see
`correct` come out false. Each is a context manager that patches the
program's entry and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, replacement):
  original = getattr(owner, name)
  setattr(owner, name, replacement(original))
  try:
    yield
  finally:
    setattr(owner, name, original)


def half_batch():
  """Every training step takes the first half of its batch's rows and of
  its noise draws; its loss is the mean over them."""
  from ddsp_torch.train import Trainer  # pylint: disable=g-import-not-at-top

  def replacement(original):
    def step(self, state, batch, **noise):
      half = int(next(iter(batch.values())).shape[0]) // 2
      return original(self, state, {k: v[:half] for k, v in batch.items()},
                      **{k: v[:half] for k, v in noise.items()})
    return step

  return _patched(Trainer, 'train_step', replacement)


def unchanged():
  """Every training step computes its loss and returns its state as it
  was given: parameters, moments, counts."""
  import torch  # pylint: disable=g-import-not-at-top
  from ddsp_torch.train import Trainer  # pylint: disable=g-import-not-at-top

  def replacement(original):
    def step(self, state, batch, **noise):
      kept = [t.detach().clone() for t in _tensors(state)]
      count, step_no = state.opt_state['count'], state.step
      state, losses = original(self, state, batch, **noise)
      with torch.no_grad():
        for t, old in zip(_tensors(state), kept):
          t.copy_(old)
      state.opt_state['count'], state.step = count, step_no
      return state, losses
    return step

  return _patched(Trainer, 'train_step', replacement)


def _tensors(state):
  return (list(state.params.values()) +
          [v for m in ('mu', 'nu') for v in state.opt_state[m].values()])


def altered_audio():
  """Every rendered answer comes back with its second half silenced."""
  from ddsp_torch.infer import AutoencoderInference  # pylint: disable=g-import-not-at-top

  def replacement(original):
    def call(self, features, noise=None):
      out = dict(original(self, features, noise=noise))
      audio = out['audio_synth'].clone()
      audio[:, audio.shape[1] // 2:] = 0.0
      out['audio_synth'] = audio
      return out
    return call

  return _patched(AutoencoderInference, '__call__', replacement)


def _sp_step(wrap):
  """make_sp_train_step whose train_step is wrap(train_step, decoder,
  optimizer)."""
  import ddsp_torch.parallel as parallel  # pylint: disable=g-import-not-at-top

  def replacement(original):
    def make(mesh, decoder, optimizer, *args, **kwargs):
      step, shard = original(mesh, decoder, optimizer, *args, **kwargs)
      return wrap(step, decoder, optimizer), shard
    return make

  return _patched(parallel, 'make_sp_train_step', replacement)


def sp_half_batch():
  """Every long-audio step takes the first half of its rows and noise."""
  def wrap(step, decoder, optimizer):
    del decoder, optimizer

    def half(batch, noise):
      rows = int(noise.shape[0]) // 2
      return step({k: v[:rows] for k, v in batch.items()}, noise[:rows])
    return half

  return _sp_step(wrap)


def sp_unchanged():
  """Every long-audio step computes its loss and leaves the decoder and
  the optimizer's state as they were."""
  import torch  # pylint: disable=g-import-not-at-top

  def wrap(step, decoder, optimizer):
    def same(batch, noise):
      params = list(decoder.parameters())
      kept = [p.detach().clone() for p in params]
      state = {p: {k: v.clone() if torch.is_tensor(v) else v
                   for k, v in optimizer.state[p].items()}
               for p in params if p in optimizer.state}
      loss = step(batch, noise)
      with torch.no_grad():
        for p, old in zip(params, kept):
          p.copy_(old)
      for p in params:
        if p in state:
          optimizer.state[p] = state[p]
        else:
          optimizer.state.pop(p, None)
      return loss
    return same

  return _sp_step(wrap)


def no_exchange():
  """Every halo shift between time shards (K3) delivers zeros."""
  import torch  # pylint: disable=g-import-not-at-top
  from ddsp_torch.kernels import halo  # pylint: disable=g-import-not-at-top

  def replacement(original):
    del original

    def shift(shards, mesh, direction):
      del mesh, direction
      return [torch.zeros_like(x) for x in shards]
    return shift

  return _patched(halo, '_shift', replacement)


FAULTS = {'half_batch': half_batch, 'unchanged': unchanged,
          'altered_audio': altered_audio, 'sp_half_batch': sp_half_batch,
          'sp_unchanged': sp_unchanged, 'no_exchange': no_exchange}
