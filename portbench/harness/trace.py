"""A traced window: torch.profiler over the benchmark's own spans, and the
reduction of its Chrome trace to busy time, idle gaps, launches and the
device time under an op.

The trace is written under the run's TMPDIR and read back from the file:
the Chrome trace's event categories ('kernel', 'gpu_memcpy',
'gpu_memset' on the device; 'cpu_op', 'user_annotation', 'cuda_runtime',
'cuda_driver' on the host) and its correlation ids, which tie a kernel to
the launch call that enqueued it, are what this module reads.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')
WINDOW_SPAN = 'window'
# The spans the benchmark records around its calls into the program.
SPANS = ('train_step', 'render.request', 'copy_out')


def sync(device) -> None:
  """Wait for the card's queue (nothing on the CPU)."""
  import torch  # pylint: disable=g-import-not-at-top
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def span(name: str):
  """A torch.profiler.record_function span (traced windows only)."""
  import torch  # pylint: disable=g-import-not-at-top
  return torch.profiler.record_function(name)


@contextlib.contextmanager
def profiled(path: str):
  """Profile CPU and CUDA activity inside a 'window' span; the Chrome trace
  goes to `path` when the block ends."""
  import torch  # pylint: disable=g-import-not-at-top
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with torch.profiler.record_function(WINDOW_SPAN):
      yield
      torch.cuda.synchronize()
  prof.export_chrome_trace(path)


def trace_path(cell: str) -> str:
  """A fresh file under TMPDIR for one run's trace."""
  fd, path = tempfile.mkstemp(prefix=f'portbench_{cell}_', suffix='.json')
  os.close(fd)
  return path


def _union(intervals: Iterable[Tuple[float, float]]):
  merged: List[List[float]] = []
  for start, end in sorted(intervals):
    if merged and start <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], end)
    else:
      merged.append([start, end])
  return merged


class Trace:
  """The events of one traced window (times in microseconds)."""

  def __init__(self, events: Sequence[Dict]):
    events = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
    windows = [e for e in events if e.get('cat') == 'user_annotation' and
               e['name'] == WINDOW_SPAN]
    if not windows:
      raise ValueError('the trace has no window span')
    w = max(windows, key=lambda e: e['dur'])
    self.start, self.end = float(w['ts']), float(w['ts']) + float(w['dur'])
    inside = lambda e: self.start <= float(e['ts']) <= self.end
    self.device = [e for e in events if e.get('cat') in DEVICE_CATS and
                   inside(e)]
    self.launches = [e for e in events if e.get('cat') in LAUNCH_CATS and
                     inside(e)]
    self.ops = [e for e in events if e.get('cat') == 'cpu_op' and inside(e)]
    self.spans = [e for e in events if e.get('cat') == 'user_annotation' and
                  e['name'] in SPANS and inside(e)]

  @classmethod
  def load(cls, path: str) -> 'Trace':
    with open(path) as f:
      return cls(json.load(f)['traceEvents'])

  @property
  def window_s(self) -> float:
    return (self.end - self.start) * 1e-6

  def _busy(self):
    return _union((max(float(e['ts']), self.start),
                   min(float(e['ts']) + float(e['dur']), self.end))
                  for e in self.device)

  def busy_s(self) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(end - start for start, end in self._busy()) * 1e-6

  def device_ops(self, top: int = 10) -> List[List]:
    """[name, seconds] of the device operations that took most time."""
    total: Dict[str, float] = collections.defaultdict(float)
    for e in self.device:
      total[e['name'][:160]] += float(e['dur']) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]

  def idle_gaps(self, top: int = 10) -> List[List]:
    """[span, seconds]: the device's idle time in the window, summed by
    the innermost benchmark span that the host was in when each gap
    began ('outside' where it was in none)."""
    busy = self._busy()
    edges = [self.start] + [x for interval in busy for x in interval] + [
        self.end]
    total: Dict[str, float] = collections.defaultdict(float)
    for start, end in zip(edges[::2], edges[1::2]):
      if end <= start:
        continue
      covering = [s for s in self.spans
                  if float(s['ts']) <= start < float(s['ts']) + float(s['dur'])]
      name = (min(covering, key=lambda s: s['dur'])['name'] if covering
              else 'outside')
      total[name] += (end - start) * 1e-6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]

  def n_launches(self) -> int:
    """Kernel launch calls (runtime and driver API) in the window."""
    return sum(1 for e in self.launches if 'Launch' in e['name'])

  def op_device_s(self, op_names: Sequence[str]) -> Tuple[int, float]:
    """(calls, device seconds) of the ops named: each outermost call of
    one of them, and every device operation whose launch call the host
    made inside one."""
    by_thread: Dict[object, List[Tuple[float, float]]] = (
        collections.defaultdict(list))
    for e in sorted(self.ops, key=lambda e: float(e['ts'])):
      if e['name'] not in op_names:
        continue
      start, end = float(e['ts']), float(e['ts']) + float(e['dur'])
      outer = by_thread[e.get('tid')]
      if not outer or start >= outer[-1][1]:
        outer.append((start, end))
    n_calls = sum(len(v) for v in by_thread.values())
    if not n_calls:
      return 0, 0.0
    starts = {tid: [c[0] for c in v] for tid, v in by_thread.items()}
    launched_inside = set()
    for e in self.launches:
      tid, ts = e.get('tid'), float(e['ts'])
      if tid not in by_thread:
        continue
      i = bisect.bisect_right(starts[tid], ts) - 1
      if i >= 0 and ts <= by_thread[tid][i][1]:
        corr = (e.get('args') or {}).get('correlation')
        if corr is not None:
          launched_inside.add(corr)
    seconds = sum(float(e['dur']) for e in self.device
                  if (e.get('args') or {}).get('correlation') in
                  launched_inside) * 1e-6
    return n_calls, seconds


def maybe_remove(path: Optional[str]) -> None:
  if path and os.path.exists(path):
    os.remove(path)
