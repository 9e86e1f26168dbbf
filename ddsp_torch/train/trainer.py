"""Trainer: optimizer, train step, checkpointing.

Port of ddsp_tpu/train/trainer.py for one device, or for a mesh whose
'time' shards share one device (sequence-parallel training,
parallel/sp_model.py). The optimizer has optax's
semantics, written out: clip the gradients to a global norm, then Adam
(bias-corrected, eps outside the root) at an exponentially decaying,
non-staircased learning rate whose count starts at 0. Parameters and
optimizer moments are updated in place.

Checkpoints are torch.save files, one per step ('ckpt-<step>.pt' holding
the model's state_dict, the optimizer state and the step); the oldest are
pruned and the latest is found by step number.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ddsp_torch.parallel import sp_model
from ddsp_torch.parallel.halo import check_halo_impl
from ddsp_torch.parallel.mesh import normalize_device
from ddsp_torch.utils.device import DeviceLike, resolve_device

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8

_CKPT_RE = re.compile(r'ckpt-(\d+)\.pt$')


@dataclasses.dataclass
class TrainState:
  """Training state: step, parameters (the model's own, by name) and the
  optimizer state (Adam's first and second moments and its update count).

  `Trainer.train_step` updates the tensors in place and returns the same
  object with `step` advanced.
  """

  step: int
  params: Dict[str, torch.nn.Parameter]
  opt_state: Dict[str, Any]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
  """(g * max_norm / max(norm, max_norm) for each g, the global norm).

  optax.clip_by_global_norm's rule: gradients under the limit pass
  unchanged (the factor is exactly 1) and nothing is added to the norm.
  """
  # pylint: disable=protected-access
  norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
  scale = max_norm / torch.clamp(norm, min=max_norm)
  return torch._foreach_mul(grads, scale), norm


class Trainer:
  """Binds a model, the optimizer and the train step on one device.

  Attributes:
    model: A ddsp_torch Model; it is moved to `device` (CUDA unless the
      caller passes device='cpu'; raises without a GPU).
    mesh: Optional parallel.Mesh. A mesh that shards 'time' routes the
      step's forward through parallel.sp_model.sp_forward_with_losses; the
      frame-rate network runs on the mesh's first device, which is the
      trainer's device. No mesh, or one that does not shard time: the
      dense step.
    halo_impl: 'xla' or 'pallas', the JAX Trainer's names for its halo
      collectives. The port has one: kernel K3 on a CUDA mesh, its plain
      version on a CPU mesh, whichever name is given. Others raise.
    learning_rate / lr_decay_steps / lr_decay_rate: Adam with exponential
      decay (defaults 3e-4, 10k, 0.98).
    grad_clip_norm: Global-norm gradient clipping (3.0).
    checkpoints_to_keep: Older checkpoints are deleted on save.
    seed: The noise of step s is drawn from a generator seeded with
      seed + 2 + s, so a restored run continues with the same noise.
  """

  def __init__(self, model, mesh=None, learning_rate: float = 3e-4,
               lr_decay_steps: int = 10000, lr_decay_rate: float = 0.98,
               grad_clip_norm: float = 3.0, checkpoints_to_keep: int = 100,
               seed: int = 0, device: DeviceLike = None,
               halo_impl: str = 'xla'):
    check_halo_impl(halo_impl)
    if mesh is not None and device is None:
      device = mesh.first_device
    self.device = resolve_device(device)
    if mesh is not None and mesh.first_device != normalize_device(
        self.device):
      raise ValueError(f'The mesh lies on {mesh.first_device}, the trainer '
                       f'on {self.device}.')
    self.mesh = mesh
    self.halo_impl = halo_impl
    self.model = model.to(self.device)
    self.learning_rate = learning_rate
    self.lr_decay_steps = lr_decay_steps
    self.lr_decay_rate = lr_decay_rate
    self.grad_clip_norm = grad_clip_norm
    self.checkpoints_to_keep = checkpoints_to_keep
    self.seed = seed
    self._generator = torch.Generator(self.device)

  def lr_schedule(self, count: int) -> float:
    """lr * rate ** (count / steps), not staircased."""
    return self.learning_rate * self.lr_decay_rate**(count /
                                                     self.lr_decay_steps)

  # ----------------------------------------------------------------------
  # Build / init
  # ----------------------------------------------------------------------
  def init(self, batch: Optional[Dict[str, Any]] = None) -> TrainState:
    """A TrainState at step 0 over the model's current parameters.

    The parameters are those the model was built with
    (`build_model(..., seed=...)` draws them); `batch` is accepted for the
    JAX Trainer's signature and not read.
    """
    del batch
    params = dict(self.model.named_parameters())
    opt_state = {
        'count': 0,
        'mu': {k: torch.zeros_like(p) for k, p in params.items()},
        'nu': {k: torch.zeros_like(p) for k, p in params.items()},
    }
    return TrainState(step=0, params=params, opt_state=opt_state)

  def param_count(self, state: TrainState) -> int:
    return int(sum(np.prod(p.shape) for p in state.params.values()))

  # ----------------------------------------------------------------------
  # Train step
  # ----------------------------------------------------------------------
  def to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The batch as float32 tensors on the trainer's device."""
    out = {}
    for k, v in batch.items():
      if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v, np.float32))
      out[k] = v.to(self.device, torch.float32, non_blocking=True)
    return out

  def train_step(self, state: TrainState, batch: Dict[str, Any],
                 noise: Optional[torch.Tensor] = None
                 ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimization step; returns (state, losses on the device).

    `noise` ([batch, n_samples], uniform in [-1, 1)) replaces the draw of
    the step's generator, for tests that hand over another framework's.
    """
    batch = self.to_device(batch)
    self._generator.manual_seed(self.seed + 2 + state.step)
    if sp_model.has_time_sharding(self.mesh):
      _, losses = sp_model.sp_forward_with_losses(
          self.model, batch, self.mesh, halo_impl=self.halo_impl,
          training=True, noise=noise, generator=self._generator)
    else:
      _, losses = self.model(batch, training=True, return_losses=True,
                             noise=noise, generator=self._generator)
    params = [p for p in state.params.values() if p.requires_grad]
    grads = torch.autograd.grad(losses['total_loss'], params,
                                allow_unused=True)
    names = [k for k, p in state.params.items() if p.requires_grad]
    used = [(k, p, g) for k, p, g in zip(names, params, grads)
            if g is not None]
    self.apply_gradients(state, [k for k, _, _ in used],
                         [p for _, p, _ in used], [g for _, _, g in used])
    state.step += 1
    return state, {k: v.detach() for k, v in losses.items()}

  @torch.no_grad()
  def apply_gradients(self, state: TrainState, names: List[str],
                      params: List[torch.Tensor],
                      grads: List[torch.Tensor]) -> torch.Tensor:
    """Clip, then one Adam update in place; returns the unclipped norm."""
    # pylint: disable=protected-access
    grads, norm = clip_by_global_norm(grads, self.grad_clip_norm)
    opt = state.opt_state
    lr = self.lr_schedule(opt['count'])
    opt['count'] += 1
    mu = [opt['mu'][k] for k in names]
    nu = [opt['nu'][k] for k in names]
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
    # update = -lr * mu_hat / (sqrt(nu_hat) + eps)
    denom = torch._foreach_div(nu, 1.0 - ADAM_B2**opt['count'])
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, ADAM_EPS)
    torch._foreach_addcdiv_(params, mu, denom,
                            value=-lr / (1.0 - ADAM_B1**opt['count']))
    return norm

  # ----------------------------------------------------------------------
  # Checkpointing
  # ----------------------------------------------------------------------
  @staticmethod
  def checkpoint_steps(directory: str) -> List[int]:
    """Steps of the checkpoints in `directory`, ascending."""
    if not os.path.isdir(directory):
      return []
    found = (_CKPT_RE.match(name) for name in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)

  @staticmethod
  def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f'ckpt-{step:08d}.pt')

  def save(self, state: TrainState, save_dir: str) -> float:
    """Saves model and optimizer to a step-numbered checkpoint; returns the
    seconds it took. Keeps the newest `checkpoints_to_keep`."""
    start_time = time.time()
    os.makedirs(save_dir, exist_ok=True)
    path = self.checkpoint_path(save_dir, state.step)
    tmp = f'{path}.{os.getpid()}.tmp'
    torch.save({'step': state.step,
                'params': self.model.state_dict(),
                'opt_state': state.opt_state}, tmp)
    os.replace(tmp, path)
    steps = self.checkpoint_steps(save_dir)
    for old in steps[:max(0, len(steps) - self.checkpoints_to_keep)]:
      os.remove(self.checkpoint_path(save_dir, old))
    return time.time() - start_time

  def restore(self, state: TrainState, restore_dir: str,
              restore_keys: Optional[list] = None) -> TrainState:
    """Restore model and optimizer from the latest checkpoint, if any.

    Args:
      state: A freshly initialized TrainState.
      restore_dir: Directory with step-numbered checkpoints.
      restore_keys: Optional list of top-level submodule names to restore
        (partial restore, e.g. ['decoder']); the other parameters, the
        optimizer state and the step keep their fresh values. Names absent
        from the checkpoint or the model are skipped.

    Returns:
      The restored TrainState (the input state if no checkpoint is found).
    """
    steps = self.checkpoint_steps(restore_dir)
    if not steps:
      return state
    restored = torch.load(self.checkpoint_path(restore_dir, steps[-1]),
                          map_location=self.device, weights_only=True)
    if restore_keys is None:
      self.model.load_state_dict(restored['params'])
      state.step = int(restored['step'])
      state.opt_state['count'] = int(restored['opt_state']['count'])
      with torch.no_grad():
        for moment in ('mu', 'nu'):
          for k, v in state.opt_state[moment].items():
            v.copy_(restored['opt_state'][moment][k])
      return state
    own = self.model.state_dict()
    chosen = {k: v for k, v in restored['params'].items()
              if k.split('.')[0] in restore_keys and k in own}
    self.model.load_state_dict(chosen, strict=False)
    return state
