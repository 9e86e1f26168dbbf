"""Seeded weights, made on the device in one draw and handed to both the
program and the reference.

Every leaf comes from one torch.randn of all the parameters, on the card's
generator, sliced in the reference's fixed order and scaled by the leaf's
kind: products' and convolutions' kernels by 1 / sqrt(fan in), biases
and shifts by 0.1, normalisations' scales 1 + 0.1 x, a reverb's impulse response an audible decaying burst
(0.02 x exp(-t / 8000)), so that every path carries signal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

WEIGHTS_STREAM = 1
TRAFFIC_STREAM = 2
NOISE_STREAM = 3
SAMPLE_STREAM = 4


def stream_seed(seed: int, stream: int) -> int:
  """A seed of its own for each use of the run's seed (any whole number
  up to 2**60)."""
  return (int(seed) * 8 + stream) % (2**63)


def generator(seed: int, stream: int, device) -> torch.Generator:
  return torch.Generator(device).manual_seed(stream_seed(seed, stream))


def _scaled(name: str, x: torch.Tensor, shape: Tuple[int, ...]):
  leaf = name.rsplit('.', 1)[-1]
  if leaf in ('kernel', 'wi', 'wh'):
    return x / float(torch.Size(shape[:-1]).numel())**0.5
  if leaf in ('bias', 'bi', 'bn', 'shift'):
    return 0.1 * x
  if leaf == 'scale':
    return 1.0 + 0.1 * x
  if leaf == 'ir':
    t = torch.arange(shape[0], device=x.device, dtype=torch.float32)
    return 0.02 * x * torch.exp(-t / 8000.0)
  raise ValueError(f'no initial scale for the leaf {name!r}')


def make(spec: Sequence[Tuple[str, Tuple[int, ...]]], seed: int,
         device, offsets: Sequence[Dict] = ()) -> Dict[str, torch.Tensor]:
  """{name: float32 tensor on `device`} for every (name, shape) of spec.

  offsets: the configuration's {'leaf', 'start', 'stop', 'value'}, each
  added to a slice of a leaf (a head's bias that would leave a branch
  silent at these scales, so that the check sees it)."""
  sizes = [int(torch.Size(shape).numel()) for _, shape in spec]
  flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS_STREAM,
                                                     device), device=device)
  out, start = {}, 0
  for (name, shape), size in zip(spec, sizes):
    out[name] = _scaled(name, flat[start:start + size].view(shape), shape)
    start += size
  for o in offsets:
    out[o['leaf']][o['start']:o['stop']] += o['value']
  return out


@torch.no_grad()
def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
  """Copy `weights` into the model's parameters by name; raises unless
  the names and shapes are exactly the model's."""
  own = dict(model.named_parameters())
  if set(own) != set(weights):
    raise ValueError(f'weights and model differ: only in the weights '
                     f'{sorted(set(weights) - set(own))}, only in the model '
                     f'{sorted(set(own) - set(weights))}')
  for name, p in own.items():
    if tuple(p.shape) != tuple(weights[name].shape):
      raise ValueError(f'{name}: model {tuple(p.shape)}, weights '
                       f'{tuple(weights[name].shape)}')
    p.copy_(weights[name])
