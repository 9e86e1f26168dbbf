"""Drives `ddsp_torch.infer.AutoencoderInference.__call__`: one client in
a closed loop, each request's audio copied to the host before the next is
sent.

Set-up writes a params export of the seeded weights under TMPDIR, builds
one instance per clip length of the traffic (the class fixes the length at
construction), and warms each up. A request is done when its audio is on
the host; its latency is timed on the host clock from the call to that
copy. After the window, a sample of the finished requests drawn from the
seed, with a request of the longest length in it, is rendered again by
the plain reference from the same weights, features and noise.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import cells, stats, trace, traffic, weights
from portbench.harness.trace import sync

WARM_CALLS = 2


class Run:
  """One run of a rendering cell."""

  def __init__(self, cell, seed: int, device):
    self.cell, self.seed, self.device = cell, int(seed), device
    self.cfg = cells.reference_cfg(cell.config)
    self.reference = importlib.import_module(
        f'portbench.reference.{cell.config["reference"]}')
    self._setup_peak = self._window_peak = 0

  def _export(self, directory: str) -> None:
    """A params-format export (operative_spec.json, params.npz)."""
    config = self.cell.config
    w = weights.make(self.reference.param_spec(self.cfg), self.seed,
                     self.device, config.get('weight_offsets', ()))
    with open(os.path.join(directory, 'operative_spec.json'), 'w') as f:
      json.dump({'preset': config['preset'], 'kwargs': config['model']}, f)
    np.savez(os.path.join(directory, 'params.npz'),
             **{k.replace('.', '/'): v.cpu().numpy() for k, v in w.items()})

  def _request(self, length: int, index: int) -> torch.Tensor:
    return self.ports[length](self.mix.pool[length][index],
                              noise=self.mix.noise[length][index])[
                                  'audio_synth']

  def setup(self) -> None:
    from ddsp_torch.infer import AutoencoderInference  # pylint: disable=g-import-not-at-top
    self.mix = traffic.make(self.cell.traffic, self.cfg, self.seed,
                            self.device)
    directory = tempfile.mkdtemp(prefix='portbench_export_')
    try:
      self._export(directory)
      self.ports = {length: AutoencoderInference(
          directory, length_seconds=length, remove_reverb=False,
          device=self.device) for length in self.mix.lengths}
    finally:
      shutil.rmtree(directory)
    for length in self.mix.lengths:
      for _ in range(WARM_CALLS):
        self._request(length, 0).cpu()
    self.schedule = self.mix.schedule()
    sync(self.device)
    if self.device.type == 'cuda':
      self._setup_peak = torch.cuda.max_memory_allocated(self.device)

  def window(self, seconds: float) -> Dict:
    sync(self.device)
    if self.device.type == 'cuda':
      torch.cuda.reset_peak_memory_stats(self.device)
    self.done: List = []
    latency, host = [], []
    start_wall = time.time()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
      length, index = next(self.schedule)
      t0 = time.perf_counter()
      audio = self._request(length, index)
      t1 = time.perf_counter()
      answer = audio.cpu()
      t2 = time.perf_counter()
      latency.append(t2 - t0)
      host.append(t1 - t0)
      self.done.append((length, index, answer))
    sync(self.device)
    elapsed = time.perf_counter() - start
    if self.device.type == 'cuda':
      self._window_peak = torch.cuda.max_memory_allocated(self.device)
    audio_s = float(sum(length for length, _, _ in self.done))
    failed = sum(1 for _, _, a in self.done
                 if not bool(torch.isfinite(a).all()))
    self.window_s, self.host_ms = elapsed, 1e3 * float(np.mean(host))
    self.window_audio_s = audio_s
    self.window_frames = [length * traffic.frames_per_second(self.cfg)
                          for length, _, _ in self.done]
    return {'start': start_wall, 'attempted': len(self.done),
            'failed': failed,
            'metrics': {'render_audio_s_per_s': audio_s / elapsed,
                        'render_ms_p95': 1e3 * stats.p95(latency)}}

  def traced(self, path: str) -> Dict:
    """One block of the mix's requests under the profiler."""
    self._request(*next(self.schedule)).cpu()
    lengths = []
    with trace.profiled(path):
      for _ in range(sum(self.mix.block)):
        length, index = next(self.schedule)
        with trace.span('render.request'):
          audio = self._request(length, index)
        with trace.span('copy_out'):
          audio.cpu()
        lengths.append(length)
    rate = traffic.frames_per_second(self.cfg)
    return {'trace': trace.Trace.load(path), 'cfg': self.cfg,
            'config': self.cell.config,
            'traced_frames': [length * rate for length in lengths],
            'gru_hidden': self.reference.rnn_hidden(self.cfg),
            'traced_audio_s': float(sum(lengths)),
            'window_s': self.window_s, 'window_audio_s': self.window_audio_s,
            'host_ms': self.host_ms,
            'window_flops': sum(
                self.reference.step_flops(self.cfg, 1, frames, passes=1)
                for frames in self.window_frames)}

  def memory_peak_bytes(self) -> int:
    return max(self._setup_peak, self._window_peak)

  def release(self) -> None:
    del self.ports, self.mix
    if self.device.type == 'cuda':
      torch.cuda.empty_cache()

  def sample(self) -> List:
    """(length, pool index, answer) of the sampled finished requests: one
    of the longest length and tr['check_sample'] - 1 more, drawn from the
    seed."""
    rng = np.random.default_rng(weights.stream_seed(self.seed,
                                                    weights.SAMPLE_STREAM))
    longest = max(length for length, _, _ in self.done)
    chosen = [int(rng.choice([i for i, d in enumerate(self.done)
                              if d[0] == longest]))]
    rest = [i for i in range(len(self.done)) if i not in chosen]
    k = min(len(rest), self.cell.traffic['check_sample'] - 1)
    chosen += [int(i) for i in rng.choice(rest, size=k, replace=False)]
    return [self.done[i] for i in chosen]

  def reference_audio(self, length: int, index: int, lower: bool):
    """The reference's answer to pool request (length, index); `lower`:
    the control's."""
    from portbench.reference import plain  # pylint: disable=g-import-not-at-top
    precision = plain.Precision(self.cfg['compute_dtype'], lower=lower)
    rate = traffic.frames_per_second(self.cfg)
    cfg = dict(self.cfg, n_samples=length * self.cfg['sample_rate'],
               time_steps=length * rate)
    request = self._mix.pool[length][index]
    f0 = torch.as_tensor(request['f0_hz'], device=self.device)[None, :, None]
    ld = torch.as_tensor(request['loudness_db'],
                         device=self.device)[None, :, None]
    with precision.products():
      return self.reference.render(self._weights, f0, ld,
                                   self._mix.noise[length][index], cfg,
                                   precision).cpu()

  def readings(self, kind: str = 'program') -> Dict[str, float]:
    """The worst sampled answer's distance from the reference's, in the
    magnitudes of their spectrograms ('spectrum_gap'; the waveforms'
    'audio_gap' beside it, not compared: the program's chunked float32
    phase drifts from the exact one over a minute, which the ear and the
    spectrogram do not see): the program's ('program') or the control's
    ('control': the reference a precision lower in the program's place)."""
    self._mix = traffic.make(self.cell.traffic, self.cfg, self.seed,
                             self.device)
    self._weights = weights.make(
        self.reference.param_spec(self.cfg), self.seed, self.device,
        self.cell.config.get('weight_offsets', ()))
    spectrum, audio, cache = [], [], {}
    for length, index, answer in self.sample():
      key = (length, index)
      if key not in cache:
        cache[key] = self.reference_audio(length, index, lower=False)
      truth = cache[key]
      if kind == 'control':
        answer = self.reference_audio(length, index, lower=True)
      spectrum.append(stats.spectrum_gap(answer, truth))
      audio.append(stats.rel_l2(answer, truth))
    del self._mix, self._weights
    return {'spectrum_gap': max(spectrum), 'audio_gap': max(audio)}

  def check(self) -> Dict[str, float]:
    return self.readings('program')
