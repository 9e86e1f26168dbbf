"""Drives the step of `ddsp_torch.parallel.make_sp_train_step`: the
decoder of a configuration on frame-rate features, then the synthesis and
the spectral loss with every audio-rate tensor sharded over the time axis
of a mesh of the card, torch.optim.Adam; a pool of long batches on the
card, each step's noise handed over.

Set-up, window and check are the training driver's (train_step.py): the
first three steps through the window's call, their losses, Adam's first
moments after one step and the parameters' change after three, against
the reference's dense forward of the same decoder and synthesis.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench.harness import cells, traffic, weights

TrainRun = cells.driver('train_step').Run
PREFIX = 'decoder.'


class Run(TrainRun):
  """One run of a long-audio training cell."""

  def _build(self) -> None:
    from ddsp_torch.parallel import create_mesh, make_sp_train_step  # pylint: disable=g-import-not-at-top
    from ddsp_torch.utils import build_model  # pylint: disable=g-import-not-at-top
    config, settings = self.cell.config, self.cell.settings
    n_data, n_time = settings['mesh']
    mesh = create_mesh(n_data, n_time,
                       devices=[self.device] * (n_data * n_time))
    self.model = build_model(config['preset'], device=self.device,
                             **config['model'])
    weights.load(self.model, self.init)
    decoder = self.model.decoder
    opt = self.optimizer()
    self.optim = torch.optim.Adam(decoder.parameters(),
                                  lr=opt['learning_rate'],
                                  betas=(opt['b1'], opt['b2']),
                                  eps=opt['eps'])
    self.pool = traffic.make(self.cell.traffic, self.cfg, self.seed,
                             self.device)
    self.train_step, shard_batch = make_sp_train_step(
        mesh, decoder, self.optim,
        n_samples=self.pool['noise'][0]['noise'].shape[1],
        sample_rate=self.cfg['sample_rate'], fft_sizes=self.cfg['fft_sizes'])
    sharded = [shard_batch(b, n['noise'])
               for b, n in zip(self.pool['batches'], self.pool['noise'])]
    self.pool = {'batches': [b for b, _ in sharded],
                 'noise': [n for _, n in sharded]}
    self.names = {p: PREFIX + k for k, p in decoder.named_parameters()}
    self.state = None

  def _step_terms(self, i) -> Dict[str, torch.Tensor]:
    k = i % len(self.pool['batches'])
    return {'total_loss': self.train_step(self.pool['batches'][k],
                                          self.pool['noise'][k])}

  def _first_moments(self) -> Dict[str, torch.Tensor]:
    return {self.names[p]: self.optim.state[p].get('exp_avg',
                                                   torch.zeros_like(p))
            for p in self.names}

  def _params(self) -> Dict[str, torch.Tensor]:
    return {name: p for p, name in self.names.items()}

  @property
  def frames(self) -> int:
    return traffic.frames_per_second(self.cfg) * self.cell.traffic['seconds']

  def optimizer(self) -> Dict:
    return self.cell.settings['optimizer']

  def _layers(self):
    return {'nn': [self.model.decoder]}

  def reference_step(self) -> Dict:
    return {'loss_fn': self.reference.decoder_loss,
            'opt': self.optimizer()}
