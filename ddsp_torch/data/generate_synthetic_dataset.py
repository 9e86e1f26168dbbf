"""CLI: write TFRecords of synthetic harmonic/noise controls.

Port of ddsp_tpu/data/generate_synthetic_dataset.py, with the same shard
names. Reference behavior:
magenta/ddsp's ddsp/training/data_preparation/ddsp_generate_synthetic_dataset.py
(a Beam pipeline over synthetic_data.generate_notes_v2). Single-process here;
the records feed SyntheticNotesProvider / InverseSynthesis
self-supervision.

Usage:
  python -m ddsp_torch.data.generate_synthetic_dataset \
      --output_tfrecord_path=/data/synth --num_examples=1000 [--device=cpu]
"""

from __future__ import annotations

import argparse
import logging

import numpy as np


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--output_tfrecord_path', required=True)
  parser.add_argument('--num_examples', type=int, default=1000)
  parser.add_argument('--num_shards', type=int, default=1)
  parser.add_argument('--n_timesteps', type=int, default=125)
  parser.add_argument('--n_harmonics', type=int, default=100)
  parser.add_argument('--n_mags', type=int, default=65)
  parser.add_argument('--generator', default='v2', choices=['v1', 'v2'])
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--device', default=None,
                      help="Device of the generator's torch ops (CUDA unless "
                      "'cpu' is given).")
  args = parser.parse_args(argv)

  logging.basicConfig(level=logging.INFO)
  from ddsp_torch.data import synthetic_data, tfrecord

  rng = np.random.RandomState(args.seed)
  gen = (synthetic_data.generate_notes_v2 if args.generator == 'v2'
         else synthetic_data.generate_notes)

  per_shard = -(-args.num_examples // args.num_shards)
  written = 0
  for shard in range(args.num_shards):
    examples = []
    for _ in range(min(per_shard, args.num_examples - written)):
      controls = gen(1, args.n_timesteps, n_harmonics=args.n_harmonics,
                     n_mags=args.n_mags, random_state=rng,
                     device=args.device)
      examples.append({k: np.ravel(v) for k, v in controls.items()})
      written += 1
    path = (f'{args.output_tfrecord_path}'
            f'-{shard:05d}-of-{args.num_shards:05d}.tfrecord')
    tfrecord.write_examples(path, examples)
    logging.info('Wrote %d examples to %s', len(examples), path)


if __name__ == '__main__':
  main()
