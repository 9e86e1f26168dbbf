"""Device prefetching for the training input pipeline.

Port of ddsp_tpu/data/prefetch.py. The reference relies on tf.data's
prefetch (data.py:58-80) to overlap host batch preparation and the
host-to-device copy with the train step. Here the copy of each batch is
started `size - 1` batches ahead of its use, so it runs on the card while
the steps before it do.

There is no producer thread: the batch is read in the caller's thread, at
its `next()`, which the training loop calls after it has enqueued a step,
so the reader's Python runs while the card works, as it does without
prefetch, and never competes with the launch loop for the GIL. On CUDA
every array of a batch is copied into pinned host memory and sent with
`non_blocking=True` on a copy stream; an event recorded after the batch
orders the consumer's stream behind the copy (nothing else waits for it),
and `record_stream` tells the caching allocator that the consumer's stream
uses the memory. The pinned buffers stay in the queue until their batch is
handed over; after that PyTorch's pinned-memory allocator keeps each one
until the copy's event has passed. On the CPU the arrays become tensors.

As in the reference, the queue holds at most `size` batches, a source's
exception reaches the consumer after the batches read before it, and
closing the iterator (train() does, on every exit) releases the batches
in flight.

Floating arrays arrive as float32, as `jax.device_put` gives them without
64-bit mode, so the step casts nothing on the card.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator, List

import numpy as np
import torch

from ddsp_torch.parallel.mesh import normalize_device
from ddsp_torch.utils.device import DeviceLike, resolve_device


def _map(fn, tree):
  """fn over the arrays of a batch: dicts, tuples and lists of arrays."""
  if isinstance(tree, dict):
    return {k: _map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_map(fn, v) for v in tree)
  return fn(tree)


def _leaves(tree) -> List[Any]:
  out = []
  _map(out.append, tree)
  return out


def _host_tensor(value, pin: bool) -> torch.Tensor:
  """value as a host tensor, floats as float32, in pinned memory if asked."""
  if isinstance(value, torch.Tensor):
    tensor = value
  else:
    array = np.asarray(value)
    if np.issubdtype(array.dtype, np.floating):
      array = array.astype(np.float32, copy=False)
    tensor = torch.from_numpy(np.ascontiguousarray(array))
  if tensor.is_floating_point() and tensor.dtype != torch.float32:
    tensor = tensor.float()
  if pin and tensor.device.type == 'cpu':
    tensor = tensor.pin_memory()
  return tensor


def prefetch_to_device(iterator: Iterator[Any],
                       size: int = 2,
                       device: DeviceLike = None,
                       mesh=None) -> Iterator[Any]:
  """Wrap a host batch iterator with ahead-of-use device placement.

  Args:
    iterator: Yields host feature dicts (numpy arrays or CPU tensors), or
      tuples of them (ZippedProvider).
    size: Prefetch depth (2 = double buffering): at most this many batches
      are in the queue, the one handed over included; each `next()` reads
      one batch and starts its copy before it hands over the oldest.
    device: Where the batches go: CUDA unless the caller passes
      device='cpu' (raises without a GPU).
    mesh: Optional parallel.Mesh: the batches go to its first device, which
      every shard of a port mesh shares.

  Yields:
    The batches as tensors on the device, ready for the current stream.
  """
  if device is None and mesh is not None:
    device = mesh.first_device
  device = normalize_device(resolve_device(device))
  on_cuda = device.type == 'cuda'
  size = max(1, int(size))
  source = iter(iterator)
  # (batch on the device, its copy's event or None, its pinned buffers).
  queue = collections.deque()
  error: list = []

  def read_one() -> bool:
    """Read one batch and start its copy; False once the source ended."""
    try:
      batch = next(source)
    except StopIteration:
      return False
    except Exception as e:  # pylint: disable=broad-except
      # Delivered after the batches already queued, as the reference's
      # producer queues its exception behind them.
      error.append(e)
      return False
    if not on_cuda:
      queue.append((_map(lambda v: _host_tensor(v, pin=False), batch), None,
                    None))
      return True
    pinned = _map(lambda v: _host_tensor(v, pin=True), batch)
    with torch.cuda.device(device), torch.cuda.stream(copy_stream):
      moved = _map(lambda t: t.to(device, non_blocking=True), pinned)
      ready = torch.cuda.Event()
      ready.record(copy_stream)
    queue.append((moved, ready, pinned))
    return True

  copy_stream = torch.cuda.Stream(device) if on_cuda else None
  try:
    more = True
    while True:
      while more and not error and len(queue) < size:
        more = read_one()
      if not queue:
        if error:
          raise error[0]
        return
      batch, ready, _ = queue.popleft()
      if ready is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(ready)
        for tensor in _leaves(batch):
          tensor.record_stream(stream)
      yield batch
  finally:
    queue.clear()
