"""Time-axis (sequence-parallel) sharding of audio synthesis and the loss.

Port of ddsp_tpu/parallel/time_shard.py. The audio time axis is split over
the mesh's 'time' axis; per shard the decompositions are the JAX package's:

  * phase accumulation: a local cumsum per shard, the per-shard totals
    (mod 2 pi) gathered, and an exclusive prefix as each shard's carry;
  * fft_convolve: each shard convolves its own frames (block FFT and
    overlap-add); the tail that spills past a shard boundary rides a ring
    of right shifts, and the group-delay head a ring of left shifts;
  * STFT magnitudes and loudness: each shard frames the samples that start
    inside it, with a right halo from its neighbour;
  * the spectral loss: per-shard masked sums, summed over the mesh and
    divided by the global count.

Layout. The `local_*` functions take and return lists of shards, one per
mesh position of this process in row-major ('data', 'time') order. The
per-shard work is a loop with the shard's indices as Python ints; the
collectives (the neighbour shift of parallel/halo.py, the gather of the
phase totals, the sums of the loss) act on the whole list between such
loops. Frame-rate controls are lists too: each shard holds its data row's
rows. The `time_sharded_*` wrappers take and return global tensors, as the
JAX wrappers' in_specs and out_specs do; on a mesh over ranks, the
process-local ones (parallel/mesh.py), and the gather and the sums run
over the ranks (parallel/distributed.py). Everything is differentiable
through autograd; the shifts' adjoints are the reverse shifts.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ddsp_torch.ops import fftconv as fftconv_ops
from ddsp_torch.ops import spectral as spectral_ops
from ddsp_torch.ops.core import DB_RANGE, power_to_db, safe_log
from ddsp_torch.ops.oscillator import phase_cumsum, remove_above_nyquist
from ddsp_torch.ops.resample import resample as resample_fn
from ddsp_torch.parallel import distributed
from ddsp_torch.parallel import mesh as mesh_lib
from ddsp_torch.parallel.halo import neighbor_shift
from ddsp_torch.parallel.mesh import Mesh

Shards = List[torch.Tensor]
_TWO_PI = 2.0 * np.pi


def _ceil_div(a: int, b: int) -> int:
  return -(-a // b)


# ---------------------------------------------------------------------------
# Per-shard building blocks
# ---------------------------------------------------------------------------
def local_phase_cumsum(omega: Shards, mesh: Mesh) -> Shards:
  """Phase cumsum over time-sharded angular frequency [batch, t_local, ...].

  Returns each shard of the global cumulative phase (shard-count invariant
  up to float rounding of the carry, which is kept mod 2 pi).
  """
  local = [phase_cumsum(w) for w in omega]
  totals = [torch.remainder(x[:, -1:], _TWO_PI) for x in local]
  n = mesh.n_time
  ranks = mesh.ranks
  if ranks is not None and ranks.shares_rows:
    # Every shard's totals from every rank, in row-major order: a run may
    # touch two rows that it shares with other ranks.
    table, first = distributed.gather_shards(torch.stack(totals), ranks), 0
  else:
    table, first = torch.stack(totals), mesh.first_shard
  out = []
  for i, x in enumerate(local):
    d, t = mesh.shard_coords(i)
    # The row's totals, [n_time, batch, 1, ...].
    all_totals = table[d * n - first:(d + 1) * n - first]
    mask = (torch.arange(n, device=x.device) < t).to(x.dtype)
    mask = mask.reshape((n,) + (1,) * totals[i].ndim)
    carry = torch.remainder(torch.sum(all_totals * mask, dim=0), _TWO_PI)
    out.append(x + carry)
  return out


def local_fft_convolve_same(audio: Shards, ir: Shards, n_ir_frames: int,
                            ir_size: int, mesh: Mesh,
                            delay_compensation: int = -1,
                            halo_impl: str = 'xla') -> Shards:
  """Time-sharded LTV fft_convolve with 'same' padding.

  Args:
    audio: Audio shards, [batch, t_local]. The global length t_local *
      n_time must be divisible by n_ir_frames, and frames must not straddle
      shard boundaries.
    ir: Per-shard impulse responses of the shard's data row,
      [batch, n_ir_frames, ir_size].
    n_ir_frames: Global number of IR frames.
    ir_size: IR length in samples.
    mesh: The mesh the shards lie on.
    delay_compensation: Group-delay pre-crop; -1 = (ir_size - 1) // 2 - 1.
    halo_impl: 'xla' or 'pallas' (parallel/halo.py: both run K3).

  Returns:
    Shards of fft_convolve(audio, ir, 'same', delay_compensation).
  """
  n_shards = mesh.n_time
  batch, t_local = audio[0].shape
  t_global = t_local * n_shards
  frame_size = int(np.ceil(t_global / n_ir_frames))
  # A frame larger than the shard splits into shard-sized sub-frames that
  # reuse the same IR (the reverb case, n_ir_frames < n_shards).
  sub_frame = min(frame_size, t_local)
  if t_local % sub_frame != 0 or frame_size % sub_frame != 0:
    raise ValueError(
        f'Shard length {t_local} and frame size {frame_size} '
        '(= ceil(T / n_ir_frames)) must align; pick shard counts so frames '
        'do not straddle shard boundaries.')
  frames_per_shard = t_local // sub_frame
  fft_size = fftconv_ops.get_fft_size(sub_frame, ir_size)
  delay = ((ir_size - 1) // 2 - 1 if delay_compensation < 0
           else delay_compensation)

  results, tails, heads = [], [], []
  for i, (a, h) in enumerate(zip(audio, ir)):
    t = mesh.shard_coords(i)[1]
    # IR frame of each local sub-frame: consecutive indices (one sub-frame
    # per shard, or sub-frames that are whole frames), so a slice.
    sub_starts = t * t_local + np.arange(frames_per_shard) * sub_frame
    ir_idx = sub_starts // frame_size
    ir_local = h[:, int(ir_idx[0]):int(ir_idx[0]) + frames_per_shard]
    audio_frames = a.reshape(batch, frames_per_shard, sub_frame)
    audio_fft = torch.fft.rfft(audio_frames, fft_size)
    ir_fft = torch.fft.rfft(ir_local, fft_size)
    frames_out = torch.fft.irfft(audio_fft * ir_fft,
                                 fft_size).to(torch.float32)
    out_local = fftconv_ops.overlap_and_add(frames_out, sub_frame)
    # Group-delay compensation as a pre-crop: global output position p sums
    # out_i[p + delay - i * t_local].
    heads.append(out_local[:, :delay] if delay > 0 else None)
    if delay > 0:
      out_local = out_local[:, delay:]
    result = out_local[:, :t_local]
    if result.shape[1] < t_local:
      result = torch.nn.functional.pad(result, (0, t_local - result.shape[1]))
    results.append(result)
    tails.append(out_local[:, t_local:])

  # Ring the spilled tail to the following shards.
  tail_len = tails[0].shape[1]
  if tail_len:
    k_steps = max(1, _ceil_div(tail_len, t_local))
    pad = k_steps * t_local - tail_len
    carry = [torch.nn.functional.pad(x, (0, pad)) for x in tails]
    for step in range(k_steps):
      carry = neighbor_shift(carry, mesh, +1, impl=halo_impl)
      results = [r + c[:, :t_local] for r, c in zip(results, carry)]
      if step + 1 < k_steps:
        carry = [torch.cat([c[:, t_local:], torch.zeros_like(c[:, :t_local])],
                           dim=1) for c in carry]

  # Left halo: output positions of the preceding ceil(delay / t_local)
  # shards draw on this shard's head (its first `delay` raw samples). Ring
  # the heads left; step s delivers the chunk aligned with the receiver's
  # own output span.
  if heads[0] is not None and heads[0].shape[1] > 0:
    k_left = _ceil_div(delay, t_local)
    carry = [torch.nn.functional.pad(x, (k_left * t_local - delay, 0))
             for x in heads]
    for s in range(1, k_left + 1):
      carry = neighbor_shift(carry, mesh, -1, impl=halo_impl)
      lo = (k_left - s) * t_local
      results = [r + c[:, lo:lo + t_local] for r, c in zip(results, carry)]
  return results


def _two_tap_weights(hop: int, method: str, device):
  """(rise, fall) over one hop, as the JAX package builds them: 'window'
  from a periodic hann in float32, 'linear' from float64 rounded once."""
  if method == 'window':
    t = torch.arange(2 * hop, dtype=torch.float32, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * np.pi * t / (2 * hop))
    return w[:hop], w[hop:]
  if method == 'linear':
    d = torch.arange(hop, dtype=torch.float64, device=device) / hop
    d = d.to(torch.float32)
    return d, 1.0 - d
  raise ValueError(f'Unsupported 2-tap method: {method!r}')


def _local_upsample_2tap(frames: torch.Tensor, n_samples: int, t_local: int,
                         start: int, method: str) -> torch.Tensor:
  """The [start, start + t_local) window of resample(frames, n_samples).

  For hop-aligned windows (t_local a multiple of hop = n_samples //
  n_frames) 'window' and 'linear' resampling are 2-tap interpolations with
  a per-hop-periodic weight pattern, so the window needs only its own
  t_local // hop + 1 frames; a shard never holds the global envelope.

  Args:
    frames: [batch, n_frames, channels] frame-rate controls.
    n_samples: Global output length of the full resample.
    t_local: The window's length.
    start: First global sample of the window (hop-aligned).
    method: 'window' or 'linear'.

  Returns:
    [batch, t_local, channels].
  """
  n_frames = int(frames.shape[1])
  hop = n_samples // n_frames
  n_loc = t_local // hop
  rise, fall = _two_tap_weights(hop, method, frames.device)
  # Endpoint extension (hold the last frame), as in the global resample.
  ext = torch.cat([frames, frames[:, -1:, :]], dim=1)
  q0 = start // hop
  blk = ext[:, q0:q0 + n_loc + 1]
  seg = blk[:, 1:, :, None] * rise + blk[:, :-1, :, None] * fall
  seg = seg.permute(0, 1, 3, 2)
  return seg.reshape(frames.shape[0], t_local, frames.shape[-1])


def _local_upsample_2tap_gather(frames: torch.Tensor, n_samples: int,
                                t_local: int, start: int,
                                method: str) -> torch.Tensor:
  """_local_upsample_2tap for windows that are not hop-aligned (any
  integer hop): output position p = start + j reads frames p // hop and
  p // hop + 1 from a (t_local // hop + 2)-frame block."""
  n_frames = int(frames.shape[1])
  hop = n_samples // n_frames
  rise, fall = _two_tap_weights(hop, method, frames.device)
  # Enough held-last frames that the block never runs past the end.
  n_blk = t_local // hop + 2
  ext = torch.cat([frames, frames[:, -1:, :].expand(-1, n_blk, -1)], dim=1)
  q0 = start // hop
  blk = ext[:, q0:q0 + n_blk]
  p = start + torch.arange(t_local, device=frames.device)
  ql = torch.div(p, hop, rounding_mode='floor') - q0
  r = p % hop
  lo = blk[:, ql]
  hi = blk[:, ql + 1]
  return hi * rise[r][None, :, None] + lo * fall[r][None, :, None]


def local_harmonic_synthesis(frequencies: Shards, amplitudes: Shards,
                             harmonic_distribution: Optional[Shards],
                             n_samples: int, mesh: Mesh,
                             sample_rate: int = 16000,
                             amp_resample_method: str = 'window') -> Shards:
  """Time-sharded harmonic synthesis: controls per data row, audio sharded.

  Each shard upsamples only its own t_local-long window of the envelopes,
  accumulates its local phase and takes one carry per batch row from the
  gathered totals; sin(phase * h) is plain torch, as in the JAX function.
  Returns the audio shards, [batch, t_local].
  """
  n_shards = mesh.n_time
  if n_samples % n_shards:
    raise ValueError(f'n_samples {n_samples} must divide over {n_shards} '
                     'time shards.')
  t_local = n_samples // n_shards

  def local_env(arr, method, start):
    """The shard's envelope window, O(t_local) memory when sharded.

    One shard keeps the global resample (the dense forward's own path);
    sharded windows take the 2-tap reshape when hop-aligned and the gather
    otherwise. Other configurations raise rather than build the global
    envelope.
    """
    if n_shards == 1:
      env = resample_fn(arr, n_samples, method=method)
      return env[:, start:start + t_local]
    n_frames = int(arr.shape[1])
    if method in ('window', 'linear') and n_samples % n_frames == 0:
      if t_local % (n_samples // n_frames) == 0:
        return _local_upsample_2tap(arr, n_samples, t_local, start, method)
      return _local_upsample_2tap_gather(arr, n_samples, t_local, start,
                                         method)
    raise ValueError(
        'Time-sharded harmonic synthesis has no memory-sharded upsampling '
        f'path for method={method!r} with n_frames={n_frames}, '
        f'n_samples={n_samples} (hop must be an integer and the method '
        "'window' or 'linear'). Falling back to the dense global envelope "
        'would defeat time sharding; pick n_samples divisible by n_frames '
        'or run unsharded.')

  amp_envs, f0_envs, omegas = [], [], []
  for i in range(len(frequencies)):
    start = mesh.shard_coords(i)[1] * t_local
    if harmonic_distribution is not None:
      harmonic_amplitudes = amplitudes[i] * harmonic_distribution[i]
    else:
      harmonic_amplitudes = amplitudes[i]
    amp_envs.append(local_env(harmonic_amplitudes, amp_resample_method,
                              start))
    f0_env = local_env(frequencies[i], 'linear', start)
    f0_envs.append(f0_env)
    omegas.append(f0_env * (2.0 * np.pi) / float(sample_rate))

  phases = local_phase_cumsum(omegas, mesh)

  out = []
  for amp_env, f0_env, phase0 in zip(amp_envs, f0_envs, phases):
    n_harmonics = int(amp_env.shape[-1])
    f_ratios = torch.linspace(1.0, float(n_harmonics), n_harmonics,
                              device=amp_env.device)[None, None, :]
    amp_env = remove_above_nyquist(f0_env * f_ratios, amp_env, sample_rate)
    wavs = torch.sin(phase0 * f_ratios)
    out.append(torch.sum(amp_env * wavs, dim=-1))
  return out


# ---------------------------------------------------------------------------
# Wrappers on global tensors
# ---------------------------------------------------------------------------
def time_sharded_harmonic_synthesis(mesh: Mesh, frequencies: torch.Tensor,
                                    amplitudes: torch.Tensor,
                                    harmonic_distribution: Optional[
                                        torch.Tensor],
                                    n_samples: int, sample_rate: int = 16000,
                                    amp_resample_method: str = 'window'
                                    ) -> torch.Tensor:
  """Harmonic synthesis with the audio sharded over the mesh's 'time' axis.

  Controls are [batch, n_frames, ...]; returns the gathered audio
  [batch, n_samples] on the mesh's first device.
  """
  split = lambda x: mesh_lib.split_batch(mesh, x)
  out = local_harmonic_synthesis(
      split(frequencies), split(amplitudes),
      None if harmonic_distribution is None else split(harmonic_distribution),
      n_samples, mesh, sample_rate=sample_rate,
      amp_resample_method=amp_resample_method)
  return mesh_lib.concat_time(mesh, out, int(frequencies.shape[0]))


def time_sharded_fft_convolve(mesh: Mesh, audio: torch.Tensor,
                              impulse_response: torch.Tensor,
                              delay_compensation: int = -1,
                              halo_impl: str = 'xla') -> torch.Tensor:
  """fft_convolve(audio, ir, 'same') with the audio sharded over 'time'.

  audio: [batch, T]; impulse_response: [batch, n_ir_frames, ir_size] or
  [batch, ir_size]. Returns the gathered [batch, T].
  """
  if impulse_response.ndim == 2:
    impulse_response = impulse_response[:, None, :]
  _, n_ir_frames, ir_size = impulse_response.shape
  out = local_fft_convolve_same(
      mesh_lib.split_time(mesh, audio),
      mesh_lib.split_batch(mesh, impulse_response), n_ir_frames, ir_size,
      mesh, delay_compensation=delay_compensation, halo_impl=halo_impl)
  return mesh_lib.concat_time(mesh, out, int(audio.shape[0]))


# ---------------------------------------------------------------------------
# Time-sharded STFT magnitudes, loudness and the multi-scale spectral loss
# ---------------------------------------------------------------------------
def _frames(ext: torch.Tensor, first: int, n_valid: int, n_slots: int,
            size: int, hop: int, invalid: torch.Tensor) -> torch.Tensor:
  """[batch, n_slots, size]: n_valid frames of ext starting at first, first
  + hop, ..., then n_slots - n_valid copies of `invalid` [batch, 1, size or
  1], what the JAX package's clamped indices read there (the caller masks
  those slots out)."""
  parts = []
  if n_valid:
    span = ext[:, first:first + (n_valid - 1) * hop + size]
    parts.append(span.unfold(-1, size, hop))
  if n_slots > n_valid:
    parts.append(invalid.expand(-1, n_slots - n_valid, size))
  return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _slot_mask(n_valid: int, n_slots: int, device) -> torch.Tensor:
  return (torch.arange(n_slots, device=device) < n_valid).to(torch.float32)


def _stft_slots(t: int, t_local: int, n_time: int, hop: int):
  """(offset of the first frame, number of valid slots) of time shard t's
  STFT frames: the global frames that start inside it."""
  n_slots = t_local // hop + 1
  total_frames = _ceil_div(t_local * n_time, hop)  # global ceil
  shard_start = t * t_local
  first_k = _ceil_div(shard_start, hop)
  offset = first_k * hop - shard_start
  # Slot j is valid while first_k + j < total_frames and its start
  # offset + j * hop < t_local.
  return offset, min(n_slots, total_frames - first_k,
                     _ceil_div(t_local - offset, hop))


def _loudness_slots(t: int, t_local: int, n_time: int, hop: int,
                    pad_left: int):
  """(first global frame, number of valid slots) of time shard t's
  loudness frames ('center' padding: frame k starts at k * hop -
  pad_left)."""
  total_frames = t_local * n_time // hop + 1  # 'center' padding count.
  n_slots = (t_local + pad_left) // hop + 2
  shard_start = t * t_local
  first_k = 0 if t == 0 else _ceil_div(shard_start + pad_left, hop)
  next_first = (total_frames if t == n_time - 1 else
                min(_ceil_div(shard_start + t_local + pad_left, hop),
                    total_frames))
  return first_k, max(0, min(n_slots, next_first - first_k))


def local_stft_mag(audio: Shards, size: int, mesh: Mesh,
                   overlap: float = 0.75, halo_impl: str = 'xla'):
  """STFT magnitudes of a time-sharded signal, with a right halo.

  Matches ops.spectral.compute_mag(audio, size, overlap, pad_end=True) on
  the gathered signal: global frames start every hop samples, and each
  shard takes the frames that start inside it, reading up to size - 1 halo
  samples of its right neighbour (the last shard's halo is zeros: pad_end).
  Every shard keeps t_local // hop + 1 frame slots; the valid ones are a
  prefix.

  Returns:
    (mags, n_valid, row_frames): per-shard [batch, n_slots, size // 2 + 1]
    magnitudes, per-shard numbers of valid slots (host ints) and the
    number of frames of a whole data row (the sum of its shards' n_valid).
  """
  batch, t_local = audio[0].shape
  hop = int(size * (1.0 - overlap))
  if t_local < size:
    raise ValueError(f'Shard length ({t_local}) must be >= frame size '
                     f'({size}) for the single-neighbor halo exchange.')
  # The halo is a strided view of each shard; K3 reads it in place.
  right_halo = neighbor_shift([a[:, :size - 1] for a in audio], mesh, -1,
                              impl=halo_impl)
  n_slots = t_local // hop + 1
  window = fftconv_ops.hann_window(size, device=audio[0].device)
  fft_size = int(2**np.ceil(np.log2(size)))
  mags, n_valid = [], []
  for i, (a, halo) in enumerate(zip(audio, right_halo)):
    offset, valid = _stft_slots(mesh.shard_coords(i)[1], t_local,
                                mesh.n_time, hop)
    ext = torch.cat([a, halo], dim=1)
    # An invalid slot's indices clamp to 0 element by element.
    frames = _frames(ext, offset, valid, n_slots, size, hop,
                     ext[:, None, :1])
    mags.append(torch.abs(torch.fft.rfft(frames * window,
                                         fft_size)).to(torch.float32))
    n_valid.append(valid)
  row_frames = sum(_stft_slots(t, t_local, mesh.n_time, hop)[1]
                   for t in range(mesh.n_time))
  return mags, n_valid, row_frames


def _prepend_left_neighbor_frame(mags: Shards, n_valid: Sequence[int],
                                 mesh: Mesh, halo_impl: str = 'xla') -> Shards:
  """[batch, n_slots, bins] of each slot's previous global frame.

  Slot j's predecessor is slot j - 1, and slot 0's is the left
  neighbour's last valid frame: one [batch, 1, bins] shift. Time shard 0
  receives zeros (the caller masks its first slot).
  """
  last = [m[:, max(n, 1) - 1:max(n, 1)] for m, n in zip(mags, n_valid)]
  received = neighbor_shift(last, mesh, +1, impl=halo_impl)
  return [torch.cat([r, m[:, :-1]], dim=1) for r, m in zip(received, mags)]


def local_loudness(audio: Shards, mesh: Mesh, sample_rate: int = 16000,
                   frame_rate: int = 250, n_fft: int = 2048,
                   range_db: Optional[float] = None, ref_db: float = 0.0,
                   halo_impl: str = 'xla'):
  """Per-frame A-weighted loudness of a time-sharded signal.

  Matches ops.spectral.compute_loudness(audio, sample_rate, frame_rate,
  n_fft, padding='center') on the gathered signal: global frame k starts at
  k * hop - n_fft // 2 and belongs to the shard holding that start (time
  shard 0 also owns the negative starts, read from its zero pad); each
  shard reads an n_fft right halo.

  Returns:
    (loudness, n_valid, row_frames): per-shard [batch, n_slots] loudness in
    dB, per-shard numbers of valid slots (host ints; a prefix) and the
    number of frames of a whole data row.
  """
  if range_db is None:
    range_db = DB_RANGE
  n_shards = mesh.n_time
  batch, t_local = audio[0].shape
  frame_size = n_fft
  hop = sample_rate // frame_rate
  pad_left = frame_size // 2
  if t_local < frame_size:
    raise ValueError(f'Shard length ({t_local}) must be >= n_fft '
                     f'({frame_size}) for the single-neighbor halo '
                     'exchange in the loudness term.')
  right = neighbor_shift([a[:, :frame_size] for a in audio], mesh, -1,
                         impl=halo_impl)
  n_slots = (t_local + pad_left) // hop + 2
  fft_size = int(2**np.ceil(np.log2(frame_size)))
  freqs = tuple(spectral_ops.fft_frequencies(sample_rate, fft_size).tolist())
  weighting = torch.as_tensor(
      10**(np.asarray(spectral_ops.a_weighting_np(freqs)) / 10),
      dtype=torch.float32, device=audio[0].device)
  window = fftconv_ops.hann_window(frame_size, device=audio[0].device)
  n_bins = fft_size // 2 + 1
  loudness, n_valid = [], []
  for i, (a, r) in enumerate(zip(audio, right)):
    shard_start = mesh.shard_coords(i)[1] * t_local
    first_k, valid = _loudness_slots(mesh.shard_coords(i)[1], t_local,
                                     n_shards, hop, pad_left)
    ext = torch.cat([a.new_zeros(batch, pad_left), a, r], dim=1)
    # ext index of frame k's start: k * hop - shard_start.
    # An invalid slot's start clamps to 0.
    frames = _frames(ext, first_k * hop - shard_start, valid, n_slots,
                     frame_size, hop, ext[:, None, :frame_size]) * window
    power = torch.abs(torch.fft.rfft(frames, fft_size))**2
    avg_power = torch.sum(power * weighting, dim=-1) / n_bins
    loudness.append(power_to_db(avg_power, ref_db=ref_db,
                                range_db=range_db).to(torch.float32))
    n_valid.append(valid)
  row_frames = sum(_loudness_slots(t, t_local, n_shards, hop, pad_left)[1]
                   for t in range(n_shards))
  return loudness, n_valid, row_frames


def local_spectral_loss(target: Shards, audio: Shards, mesh: Mesh,
                        fft_sizes=(2048, 1024, 512, 256, 128, 64),
                        mag_weight: float = 1.0,
                        delta_time_weight: float = 0.0,
                        delta_freq_weight: float = 0.0,
                        cumsum_freq_weight: float = 0.0,
                        logmag_weight: float = 0.0,
                        loudness_weight: float = 0.0,
                        batch_sharded: bool = True,
                        halo_impl: str = 'xla') -> torch.Tensor:
  """Multi-scale spectral loss over time-sharded signals, all six terms.

  Equals losses.SpectralLoss(...) (L1) on the gathered signals: per-size
  masked sums of each shard are summed over the mesh and divided by the
  global element count. The frequency-axis terms are frame-local; the
  delta_time term shifts one boundary frame per shard; the loudness term
  frames with 'center' padding and an n_fft halo.

  Args:
    batch_sharded: Whether the batch splits over 'data' (the sums then run
      over every shard and the count over the global batch). A replicated
      batch sums one data row, which every row repeats. Across ranks the
      batch is sharded, and the sums run over every rank: each returns the
      global loss.

  Returns:
    The scalar loss.
  """
  n_rows = mesh.n_data if batch_sharded else 1
  n_batch_shards = mesh.n_data if batch_sharded else 1
  if mesh.ranks is not None:
    summed = range(len(target))  # this rank's part of the psum
  else:
    summed = range(n_rows * mesh.n_time)  # the shards the psum reads

  def masked_mean(diff_abs, masks, count):
    total = sum(torch.sum(diff_abs[i] * masks[i]) for i in summed)
    if mesh.ranks is not None:
      total = distributed.sum_over_ranks(total)
    return total / count

  loss = 0.0
  for size in fft_sizes:
    target_mag, n_valid, row_frames = local_stft_mag(target, size, mesh,
                                                     halo_impl=halo_impl)
    value_mag, _, _ = local_stft_mag(audio, size, mesh, halo_impl=halo_impl)
    n_slots = target_mag[0].shape[1]
    n_bins = target_mag[0].shape[-1]
    m = [_slot_mask(n, n_slots, x.device)[None, :, None]
         for n, x in zip(n_valid, target_mag)]
    batch = target_mag[0].shape[0] * n_batch_shards
    n_frames = float(row_frames)
    count = n_frames * batch * n_bins
    if mag_weight > 0:
      loss += mag_weight * masked_mean(
          [torch.abs(t - v) for t, v in zip(target_mag, value_mag)], m, count)
    if delta_time_weight > 0:
      t_prev = _prepend_left_neighbor_frame(target_mag, n_valid, mesh,
                                            halo_impl)
      v_prev = _prepend_left_neighbor_frame(value_mag, n_valid, mesh,
                                            halo_impl)
      # Global frame 0 has no predecessor: mask time shard 0's first slot.
      dm = []
      for i, mask in enumerate(m):
        if mesh.shard_coords(i)[1] == 0:
          mask = mask.clone()
          mask[:, 0] = 0.0
        dm.append(mask)
      d_count = (n_frames - 1.0) * batch * n_bins
      loss += delta_time_weight * masked_mean(
          [torch.abs((t - tp) - (v - vp)) for t, tp, v, vp in
           zip(target_mag, t_prev, value_mag, v_prev)], dm, d_count)
    if delta_freq_weight > 0:
      loss += delta_freq_weight * masked_mean(
          [torch.abs(torch.diff(t, dim=2) - torch.diff(v, dim=2))
           for t, v in zip(target_mag, value_mag)], m,
          n_frames * batch * (n_bins - 1))
    if cumsum_freq_weight > 0:
      loss += cumsum_freq_weight * masked_mean(
          [torch.abs(torch.cumsum(t, dim=2) - torch.cumsum(v, dim=2))
           for t, v in zip(target_mag, value_mag)], m, count)
    if logmag_weight > 0:
      loss += logmag_weight * masked_mean(
          [torch.abs(safe_log(t) - safe_log(v))
           for t, v in zip(target_mag, value_mag)], m, count)

  if loudness_weight > 0:
    t_loud, l_valid, l_frames = local_loudness(target, mesh, n_fft=2048,
                                               halo_impl=halo_impl)
    v_loud, _, _ = local_loudness(audio, mesh, n_fft=2048,
                                  halo_impl=halo_impl)
    n_slots = t_loud[0].shape[1]
    lm = [_slot_mask(n, n_slots, x.device)[None, :]
          for n, x in zip(l_valid, t_loud)]
    batch = t_loud[0].shape[0] * n_batch_shards
    l_count = float(l_frames) * batch
    loss += loudness_weight * masked_mean(
        [torch.abs(t - v) for t, v in zip(t_loud, v_loud)], lm, l_count)
  return loss


def time_sharded_spectral_loss(mesh: Mesh, target_audio: torch.Tensor,
                               audio: torch.Tensor,
                               fft_sizes=(2048, 1024, 512, 256, 128, 64),
                               mag_weight: float = 1.0,
                               delta_time_weight: float = 0.0,
                               delta_freq_weight: float = 0.0,
                               cumsum_freq_weight: float = 0.0,
                               logmag_weight: float = 0.0,
                               loudness_weight: float = 0.0,
                               halo_impl: str = 'xla') -> torch.Tensor:
  """SpectralLoss (L1, all six terms) with both [batch, T] signals sharded
  over the mesh; only scalar sums and small halos cross shards."""
  return local_spectral_loss(
      mesh_lib.split_time(mesh, target_audio),
      mesh_lib.split_time(mesh, audio), mesh, fft_sizes=tuple(fft_sizes),
      mag_weight=mag_weight, delta_time_weight=delta_time_weight,
      delta_freq_weight=delta_freq_weight,
      cumsum_freq_weight=cumsum_freq_weight, logmag_weight=logmag_weight,
      loudness_weight=loudness_weight,
      batch_sharded=mesh_lib.batch_is_sharded(mesh, int(audio.shape[0])),
      halo_impl=halo_impl)
