"""Drives `ddsp_torch.train.Trainer.train_step` back to back on a pool of
batches that lie on the card, handing over each step's noise draw.

Set-up builds one Trainer, loads the seeded weights, and takes the first
three steps through the window's own call and feed (batches 0, 1, 2 of
the pool, every row different): their losses, each leaf's first gradient
as Adam holds it after one step (its first moment over 1 - b1) and each
leaf's change over the three steps are what the reference checks. Two
more steps settle the allocator; the same Trainer then runs the window.
"""

from __future__ import annotations

import importlib
import time
from typing import Dict, List

import torch

from portbench.harness import check as check_lib
from portbench.harness import cells, trace, traffic, weights
from portbench.harness.trace import sync

WARM_STEPS = 2
TRACE_STEPS = 4


class LayerTimer:
  """CUDA events around each forward of the named modules: device ms of
  each layer's forward, per step (forward pre-hooks and hooks)."""

  def __init__(self, layers: Dict[str, List[torch.nn.Module]]):
    self.events = {name: [] for name in layers}
    self.handles = []
    for name, modules in layers.items():
      for module in modules:
        self.handles.append(module.register_forward_pre_hook(
            lambda m, a, name=name: self._start(name)))
        self.handles.append(module.register_forward_hook(
            lambda m, a, o, name=name: self._end(name)))

  def _start(self, name):
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    self.events[name].append([event, None])

  def _end(self, name):
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    self.events[name][-1][1] = event

  def ms(self) -> Dict[str, float]:
    """Summed ms of each layer (after a synchronize)."""
    for h in self.handles:
      h.remove()
    return {name: sum(a.elapsed_time(b) for a, b in pairs)
            for name, pairs in self.events.items()}


class Run:
  """One run of a training cell."""

  def __init__(self, cell, seed: int, device):
    self.cell, self.seed, self.device = cell, int(seed), device
    self.cfg = cells.reference_cfg(cell.config)
    self.reference = importlib.import_module(
        f'portbench.reference.{cell.config["reference"]}')
    self.batch = cell.traffic['batch']
    self.seconds_per_row = float(
        cell.traffic.get('seconds') or
        self.cfg['n_samples'] / self.cfg['sample_rate'])
    self.step_index = 0
    self._setup_peak = 0

  def _step(self, i):
    return self._step_terms(i)['total_loss']

  def _step_terms(self, i) -> Dict[str, torch.Tensor]:
    """One step; its loss terms under the program's names."""
    pool = self.pool
    k = i % len(pool['batches'])
    self.state, losses = self.trainer.train_step(
        self.state, pool['batches'][k], **pool['noise'][k])
    return losses

  def _build(self) -> None:
    """The program's training step, its state and the traffic's pool."""
    from ddsp_torch.train import Trainer  # pylint: disable=g-import-not-at-top
    from ddsp_torch.utils import build_model  # pylint: disable=g-import-not-at-top
    config = self.cell.config
    self.model = build_model(config['preset'], device=self.device,
                             **config['model'])
    weights.load(self.model, self.init)
    opt = self.cfg['optimizer']
    self.trainer = Trainer(
        self.model, device=self.device, learning_rate=opt['learning_rate'],
        lr_decay_steps=opt['lr_decay_steps'],
        lr_decay_rate=opt['lr_decay_rate'],
        grad_clip_norm=opt['grad_clip_norm'])
    self.state = self.trainer.init()
    self.pool = traffic.make(self.cell.traffic, self.cfg, self.seed,
                             self.device)

  def _first_moments(self) -> Dict[str, torch.Tensor]:
    """Adam's first moment of each leaf, by the reference's names."""
    return self.state.opt_state['mu']

  def _params(self) -> Dict[str, torch.Tensor]:
    return self.state.params

  @property
  def frames(self) -> int:
    """Frames a step's sequences have (its GRU's T)."""
    return self.cfg.get('time_steps') or self.cell.traffic['frames']

  def optimizer(self) -> Dict:
    return self.cfg['optimizer']

  def setup(self) -> None:
    self.init = weights.make(self.reference.param_spec(self.cfg), self.seed,
                             self.device,
                             self.cell.config.get('weight_offsets', ()))
    self._build()
    first = self._step_terms(0)
    self.terms = {k: float(v) for k, v in first.items() if k != 'total_loss'}
    losses = [first['total_loss']]
    b1 = self.optimizer()['b1']
    self.grad = {k: float(m.double().norm()) / (1.0 - b1)
                 for k, m in self._first_moments().items()}
    losses += [self._step(1), self._step(2)]
    params = self._params()
    self.change = {k: float((params[k].detach() - self.init[k]).double()
                            .norm()) for k in params}
    self.losses = [float(x) for x in losses]
    for i in range(3, 3 + WARM_STEPS):
      self._step(i)
    self.step_index = 3 + WARM_STEPS
    sync(self.device)
    if self.device.type == 'cuda':
      self._setup_peak = torch.cuda.max_memory_allocated(self.device)

  def window(self, seconds: float) -> Dict:
    sync(self.device)
    if self.device.type == 'cuda':
      torch.cuda.reset_peak_memory_stats(self.device)
    start_wall = time.time()
    start = time.perf_counter()
    losses = []
    while time.perf_counter() - start < seconds:
      losses.append(self._step(self.step_index))
      self.step_index += 1
    sync(self.device)
    elapsed = time.perf_counter() - start
    self._window_peak = (torch.cuda.max_memory_allocated(self.device)
                         if self.device.type == 'cuda' else 0)
    n = len(losses)
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if n else 0
    self.window_steps, self.window_s = n, elapsed
    return {'start': start_wall, 'attempted': n, 'failed': failed,
            'metrics': {
                'train_audio_s_per_s': (n * self.batch *
                                        self.seconds_per_row / elapsed),
                'train_peak_gib': self._window_peak / 2**30}}

  def _layers(self):
    """The modules of each layer, by the child names that the
    configuration's reference module lists in LAYERS."""
    children = dict(self.model.named_children())
    layers = {}
    for layer, names in self.reference.LAYERS.items():
      layers[layer] = []
      for name in names:
        child = children.get(name)
        if isinstance(child, torch.nn.ModuleList):
          layers[layer] += list(child)
        elif child is not None:
          layers[layer].append(child)
    return layers

  def traced(self, path: str) -> Dict:
    """TRACE_STEPS steps under the profiler, then TRACE_STEPS more with
    CUDA events around each layer's forward (outside the profiler, whose
    host overhead would widen the gaps inside a layer)."""
    self._step(self.step_index)  # outside the trace: the profiler starts
    self.step_index += 1
    first = self.step_index
    with trace.profiled(path):
      for _ in range(TRACE_STEPS):
        with trace.span('train_step'):
          self._step(self.step_index)
        self.step_index += 1
    pool = self.pool['batches']
    f0 = [pool[i % len(pool)]['f0_hz'][..., 0].cpu().numpy()
          for i in range(first, self.step_index)]
    timer = LayerTimer(self._layers())
    for _ in range(TRACE_STEPS):
      self._step(self.step_index)
      self.step_index += 1
    sync(self.device)
    layer_ms = timer.ms()
    return {'trace': trace.Trace.load(path), 'steps': TRACE_STEPS,
            'window_steps': self.window_steps, 'window_s': self.window_s,
            'config': self.cell.config, 'cfg': self.cfg,
            'batch': self.batch, 'f0_frames': f0,
            'gru': (self.frames, self.batch,
                    self.reference.rnn_hidden(self.cfg),
                    self.cfg['compute_dtype']),
            'layer_ms': {k: v / TRACE_STEPS for k, v in layer_ms.items()},
            'step_flops': self.reference.step_flops(self.cfg, self.batch,
                                                    self.frames)}

  def memory_peak_bytes(self) -> int:
    return max(self._setup_peak, getattr(self, '_window_peak', 0))

  def release(self) -> None:
    """Drop the program's state (the reference runs after)."""
    for name in ('trainer', 'model', 'state', 'pool', 'init', 'optim',
                 'train_step'):
      if hasattr(self, name):
        delattr(self, name)
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def reference_numbers(self, lower: bool = False):
    """(losses, first step's loss terms, first gradient norms, change
    norms) of the reference's three steps from the same weights, batches
    and noise; `lower`: the control's."""
    from portbench.reference import plain  # pylint: disable=g-import-not-at-top
    init = weights.make(self.reference.param_spec(self.cfg), self.seed,
                        self.device,
                        self.cell.config.get('weight_offsets', ()))
    pool = traffic.make(self.cell.traffic, self.cfg, self.seed, self.device)
    n = len(pool['batches'])
    pool = {k: [v[i % n] for i in range(3)] for k, v in pool.items()}
    init = {k: init[k] for k in self.grad}
    precision = plain.Precision(self.cfg['compute_dtype'], lower=lower)
    with precision.products():
      losses, terms, first, final = plain.adam_steps(
          init, pool['batches'], pool['noise'], self.cfg, precision,
          **self.reference_step())
    grad = {k: float(g.double().norm()) for k, g in first.items()}
    change = {k: float((final[k] - init[k]).double().norm()) for k in init}
    return losses, terms, grad, change

  def reference_step(self) -> Dict:
    """The reference's loss and optimiser for this entry."""
    return {'loss_fn': self.reference.training_loss}

  def compare(self, program, reference) -> Dict[str, float]:
    """The first step's loss ('loss_gap') and each of its terms
    ('loss_gap.<term>'), the median leaf's first gradient ('grad_gap')
    and change ('change_gap'), and, beside them, the worst leaf's
    ('worst_grad_gap', 'worst_change_gap') and the worst step's loss
    ('worst_loss_gap'); the cell's limits say which are compared."""
    (p_loss, p_terms, p_grad, p_change), (r_loss, r_terms, r_grad,
                                          r_change) = program, reference
    moving = check_lib.moving_leaves(r_grad)
    values = {'loss_gap': check_lib.loss_gap(p_loss[0], r_loss[0]),
              'grad_gap': check_lib.median_leaf_gap(p_grad, r_grad,
                                                    list(r_grad)),
              'change_gap': check_lib.median_leaf_gap(p_change, r_change,
                                                      moving),
              'worst_grad_gap': max(check_lib.leaf_gaps(p_grad, r_grad,
                                                        list(r_grad))),
              'worst_change_gap': max(check_lib.leaf_gaps(
                  p_change, r_change, moving)),
              'worst_loss_gap': max(check_lib.loss_gap(p, r)
                                    for p, r in zip(p_loss, r_loss))}
    if len(r_terms) > 1:
      for k in r_terms:
        if k in p_terms:
          values[f'loss_gap.{k}'] = check_lib.loss_gap(p_terms[k],
                                                       r_terms[k])
    return values

  def readings(self, kind: str = 'program') -> Dict[str, float]:
    """The compared numbers of the program ('program') or of the control
    ('control': the reference a precision lower in the program's place)."""
    reference = self.reference_numbers()
    if kind == 'control':
      return self.compare(self.reference_numbers(lower=True), reference)
    return self.compare((self.losses, self.terms, self.grad, self.change),
                        reference)

  def check(self) -> Dict[str, float]:
    return self.readings('program')
