"""Offline dataset preparation: audio files -> feature TFRecords.

Port of ddsp_tpu/data/prepare.py: load each WAV (scipy, resampled with its
FFT resampler), chunk it, attach CREPE's f0 and confidence (Viterbi by
default) and the A-weighted loudness, split train/eval by chunk hash, window
into examples and write sharded TFRecords with the port's writer
(data/tfrecord.py). CREPE and the loudness run on `device`: CUDA unless the
caller says otherwise.

    python -m ddsp_torch.data.prepare --input_audio_filepatterns 'a/*.wav' \
        --output_tfrecord_path data/train.tfrecord --num_shards 2
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

from ddsp_torch.data import tfrecord
from ddsp_torch.ops import spectral
from ddsp_torch.ops.core import torch_float32
from ddsp_torch.ops.crepe import CREPE_SAMPLE_RATE
from ddsp_torch.utils.audio_io import pcm_to_float_mono
from ddsp_torch.utils.device import DeviceLike, resolve_device


def load_audio(audio_path: str, sample_rate: int) -> np.ndarray:
  """Load a WAV file as mono float32 at the requested sample rate."""
  from scipy import signal as sps  # pylint: disable=g-import-not-at-top
  from scipy.io import wavfile  # pylint: disable=g-import-not-at-top
  sr, audio = wavfile.read(audio_path)
  audio = pcm_to_float_mono(audio)
  if sr != sample_rate:
    n_out = int(round(len(audio) * sample_rate / sr))
    audio = sps.resample(audio, n_out).astype(np.float32)
  return audio


def _chunk(audio: np.ndarray, chunk_size: int) -> List[np.ndarray]:
  """Split into chunks, zero-padding the last one (pad_end framing)."""
  n_chunks = int(np.ceil(len(audio) / chunk_size)) if len(audio) else 0
  out = []
  for i in range(n_chunks):
    chunk = audio[i * chunk_size:(i + 1) * chunk_size]
    if len(chunk) < chunk_size:
      chunk = np.pad(chunk, (0, chunk_size - len(chunk)))
    out.append(chunk.astype(np.float32))
  return out


def add_f0_estimate(ex: Dict, frame_rate: int, center: bool, viterbi: bool,
                    device: DeviceLike = None) -> Dict:
  """Attach CREPE f0/confidence computed from the 16 kHz audio."""
  padding = 'center' if center else 'same'
  f0_hz, f0_confidence = spectral.compute_f0(
      ex['audio_16k'], frame_rate, viterbi=viterbi, padding=padding,
      device=device)
  return dict(ex, f0_hz=np.asarray(f0_hz, np.float32),
              f0_confidence=np.asarray(f0_confidence, np.float32))


def add_loudness(ex: Dict, frame_rate: int, n_fft: int, center: bool,
                 device: DeviceLike = None) -> Dict:
  """Attach A-weighted loudness in dB."""
  padding = 'center' if center else 'same'
  audio = torch_float32(ex['audio_16k']).to(resolve_device(device))
  loudness_db = spectral.compute_loudness(audio, CREPE_SAMPLE_RATE,
                                          frame_rate, n_fft, padding=padding)
  return dict(ex, loudness_db=loudness_db.cpu().numpy().astype(np.float32))


def split_example(ex: Dict, sample_rate: int, frame_rate: int,
                  example_secs: float, hop_secs: float,
                  center: bool) -> Iterator[Dict]:
  """Sliding-window split into training examples (no end padding)."""

  def get_windows(sequence, rate, centered):
    window_size = int(example_secs * rate)
    if centered:
      window_size += 1
    hop_size = int(hop_secs * rate)
    n_windows = int(np.floor((len(sequence) - window_size) / hop_size)) + 1
    for i in range(n_windows):
      start = i * hop_size
      yield sequence[start:start + window_size]

  for audio, audio_16k, loudness_db, f0_hz, f0_confidence in zip(
      get_windows(ex['audio'], sample_rate, False),
      get_windows(ex['audio_16k'], CREPE_SAMPLE_RATE, False),
      get_windows(ex['loudness_db'], frame_rate, center),
      get_windows(ex['f0_hz'], frame_rate, center),
      get_windows(ex['f0_confidence'], frame_rate, center)):
    yield {
        'audio': audio,
        'audio_16k': audio_16k,
        'loudness_db': loudness_db,
        'f0_hz': f0_hz,
        'f0_confidence': f0_confidence,
    }


def prepare_records(input_audio_paths: Iterable[str],
                    output_record_path: str,
                    num_shards: Optional[int] = None,
                    sample_rate: int = 16000,
                    frame_rate: int = 250,
                    example_secs: float = 4,
                    hop_secs: float = 1,
                    eval_split_fraction: float = 0.0,
                    chunk_secs: float = 20.0,
                    center: bool = False,
                    viterbi: bool = True,
                    compute_f0: bool = True,
                    device: DeviceLike = None) -> List[str]:
  """Prepare TFRecords of (audio, f0, loudness) features for training.

  Args:
    input_audio_paths: Audio files (WAV) to include.
    output_record_path: Output path prefix; '-train'/'-eval' and shard
      numbers are appended.
    num_shards: Shards per split (None = 1).
    sample_rate: Audio sample rate for the 'audio' feature.
    frame_rate: f0/loudness frame rate (None skips features).
    example_secs: Sliding window size in seconds (0 = no split).
    hop_secs: Sliding window hop in seconds.
    eval_split_fraction: Fraction of chunks reserved for the eval split.
    chunk_secs: Chunk size for splitting long files (also the unit of the
      train/eval split).
    center: Zero-pad audio so frame timestamps are centered.
    viterbi: Viterbi-decode pitch.
    compute_f0: Run CREPE; False writes zero f0 with zero confidence.
    device: Where CREPE and the loudness run (CUDA unless the caller says
      otherwise; raises without a GPU).

  Returns:
    List of written file paths.
  """
  from scipy import signal as sps  # pylint: disable=g-import-not-at-top
  device = resolve_device(device)

  examples = []
  for path in input_audio_paths:
    logging.info('Loading %s', path)
    audio = load_audio(path, sample_rate)
    if sample_rate == CREPE_SAMPLE_RATE:
      audio_16k = audio
    else:
      # Resample the already-loaded array (one disk read per file).
      n_out = int(round(len(audio) * CREPE_SAMPLE_RATE / sample_rate))
      audio_16k = sps.resample(audio, n_out).astype(np.float32)

    chunks = _chunk(audio, int(chunk_secs * sample_rate))
    chunks_16k = _chunk(audio_16k, int(chunk_secs * CREPE_SAMPLE_RATE))
    if abs(len(chunks) - len(chunks_16k)) > 1:
      raise ValueError(
          f'{path}: chunk count mismatch between {sample_rate} Hz '
          f'({len(chunks)}) and 16 kHz ({len(chunks_16k)}) audio; pick a '
          'chunk_secs that yields whole chunks at both rates.')
    if len(chunks) != len(chunks_16k):
      # Resampling rounding can add or remove one trailing (mostly padding)
      # chunk; it is dropped with a warning rather than by zip() silently.
      logging.warning(
          '%s: dropping one trailing chunk (%d chunks at %d Hz vs %d at '
          '16 kHz - resampling rounding at the file end).',
          path, len(chunks), sample_rate, len(chunks_16k))
    for c, c16 in zip(chunks, chunks_16k):
      examples.append({'audio': c, 'audio_16k': c16})

  # Features per chunk.
  processed = []
  for ex in examples:
    if frame_rate:
      if compute_f0:
        ex = add_f0_estimate(ex, frame_rate, center, viterbi, device)
      else:
        n_frames, _ = spectral.get_framed_lengths(
            len(ex['audio_16k']), 1024, CREPE_SAMPLE_RATE // frame_rate,
            'center' if center else 'same')
        ex = dict(ex, f0_hz=np.zeros(n_frames, np.float32),
                  f0_confidence=np.zeros(n_frames, np.float32))
      ex = add_loudness(ex, frame_rate, n_fft=2048, center=center,
                        device=device)
    processed.append(ex)

  # Train/eval split by chunk hash (stable, non-overlapping).
  def chunk_id(ex):
    return int(hashlib.md5(ex['audio'].tobytes()).hexdigest(), 16)

  if eval_split_fraction > 0:
    # Each chunk hashed once, split by sorted position (duplicate hashes
    # would collapse in a set and skew the eval fraction).
    with_ids = sorted(((chunk_id(ex), i, ex)
                       for i, ex in enumerate(processed)),
                      key=lambda t: t[:2])
    n_eval = int(len(with_ids) * eval_split_fraction)
    splits = {
        'train': [ex for _, _, ex in with_ids[n_eval:]],
        'eval': [ex for _, _, ex in with_ids[:n_eval]],
    }
  else:
    splits = {'': processed}

  written = []
  for split_name, split_examples in splits.items():
    # Window into training examples (only when frame features exist:
    # split_example zips audio with the frame-rate features).
    windowed = []
    for ex in split_examples:
      if example_secs and frame_rate:
        windowed.extend(split_example(ex, sample_rate, frame_rate,
                                      example_secs, hop_secs, center))
      else:
        windowed.append(ex)

    shards = num_shards or 1
    suffix = f'-{split_name}' if split_name else ''
    per_shard = int(np.ceil(len(windowed) / shards)) if windowed else 0
    for shard in range(shards):
      shard_examples = windowed[shard * per_shard:(shard + 1) * per_shard]
      path = (f'{output_record_path}{suffix}'
              f'-{shard:05d}-of-{shards:05d}.tfrecord')
      tfrecord.write_examples(
          path, [{k: np.ravel(v) for k, v in ex.items()}
                 for ex in shard_examples])
      written.append(path)
      logging.info('Wrote %d examples to %s', len(shard_examples), path)
  return written


def main(argv=None):
  """The command line of ddsp_prepare_tfrecord, with --device."""
  import argparse  # pylint: disable=g-import-not-at-top
  import glob as globlib  # pylint: disable=g-import-not-at-top

  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--input_audio_filepatterns', required=True,
                      help='Comma-separated globs of audio files')
  parser.add_argument('--output_tfrecord_path', required=True)
  parser.add_argument('--num_shards', type=int, default=None)
  parser.add_argument('--sample_rate', type=int, default=16000)
  parser.add_argument('--frame_rate', type=int, default=250)
  parser.add_argument('--example_secs', type=float, default=4)
  parser.add_argument('--hop_secs', type=float, default=1)
  parser.add_argument('--eval_split_fraction', type=float, default=0.0)
  parser.add_argument('--chunk_secs', type=float, default=20.0)
  parser.add_argument('--center', action='store_true')
  parser.add_argument('--no_viterbi', action='store_true')
  parser.add_argument('--no_f0', action='store_true')
  parser.add_argument('--device', default=None,
                      help="Where CREPE and the loudness run (default: "
                      "cuda; 'cpu' on a machine without a GPU)")
  args = parser.parse_args(argv)

  paths = []
  for pattern in args.input_audio_filepatterns.split(','):
    paths.extend(globlib.glob(pattern))
  if not paths:
    raise FileNotFoundError(
        f'No audio files match {args.input_audio_filepatterns!r}')

  logging.basicConfig(level=logging.INFO)
  return prepare_records(
      paths, args.output_tfrecord_path,
      num_shards=args.num_shards, sample_rate=args.sample_rate,
      frame_rate=args.frame_rate, example_secs=args.example_secs,
      hop_secs=args.hop_secs,
      eval_split_fraction=args.eval_split_fraction,
      chunk_secs=args.chunk_secs, center=args.center,
      viterbi=not args.no_viterbi, compute_f0=not args.no_f0,
      device=args.device)


if __name__ == '__main__':
  main()
