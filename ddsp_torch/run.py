"""Command-line entry point: train / eval / sample.

Port of ddsp_tpu/run.py. Reference behavior: magenta/ddsp's
ddsp/training/ddsp_run.py. Flags select the run's topology; the model
architecture comes from a preset name + JSON overrides, written to save_dir
as the operative spec and re-read on eval/sample.

Usage (the card by default; --device cpu runs on the host):
  ddsp-torch-run --mode=train --preset=solo_instrument \
      --save_dir=/tmp/run --data=synthetic --num_steps=1000
  ddsp-torch-run --mode=eval --save_dir=/tmp/run --data=synthetic
  ddsp-torch-run --mode=sample --save_dir=/tmp/run --data=synthetic

`python -m ddsp_torch.run` does the same. `main(argv)` runs in the calling
process and returns the final TrainState (train) or the metrics (eval,
sample).

Across processes (the counterpart of the JAX CLI's --multihost), one
process per card under torchrun (scripts/launch_torchrun.sh):
  torchrun --nproc_per_node 4 -m ddsp_torch.run --multihost --mode=train \
      --save_dir=/tmp/run --batch_size=4 [--time_shards 2]
  torchrun --nproc_per_node 4 -m ddsp_torch.run --multihost --mode=eval \
      --save_dir=/tmp/run --batch_size=4 [--time_shards 2] --run_once
Each process starts torch.distributed from torchrun's environment, takes
cuda:LOCAL_RANK (or the --device it is given), and the ranks form a
(ranks / time_shards x time_shards) mesh. In training each data row reads
--batch_size rows of its own examples a step; in eval and sample every
rank reads the same fixed eval set of min(--batch_size, 4) rows a data
row and keeps its part. Rank 0 writes the spec, the checkpoints, the
summaries and the samples.
"""

from __future__ import annotations

import argparse
import inspect
import json
import logging
import re
from typing import List, Optional

import torch

from ddsp_torch import data as data_lib
from ddsp_torch.parallel import distributed
from ddsp_torch.utils.device import DeviceLike


def build_data_provider(spec: str, n_samples: int, sample_rate: int,
                        frame_rate: int, model_kwargs=None,
                        device: DeviceLike = None,
                        control_frames: Optional[int] = None):
  """Data spec -> DataProvider.

  Specs: 'synthetic[:n]' (sinusoids), 'tfrecord:<pattern>',
  'synthetic_notes[:pattern]' (self-supervised controls, generated on the
  fly on `device` when no pattern is given), 'urmp:<dir>[:instrument]'
  (MIDI-annotated), 'nsynth[:split[:data_dir]]',
  'tfds:<name>[:<version>]:<split>[:data_dir]'.

  synthetic_notes' controls have model_kwargs' 'time_steps' frames, else
  `control_frames` (the model's: InverseSynthesis.n_frames, 250 at 4 s),
  else 125. (The JAX CLI takes 125 where the preset has no time_steps, and
  the inverse_synthesis preset's losses then fail on 125 frames against
  its encoder's 250.)
  """
  model_kwargs = model_kwargs or {}
  kind, _, arg = spec.partition(':')
  if kind == 'synthetic':
    n_examples = int(arg) if arg else 64
    return data_lib.SyntheticSinusoidProvider(
        n_samples=n_samples, sample_rate=sample_rate, frame_rate=frame_rate,
        n_examples=n_examples)
  if kind == 'tfrecord':
    return data_lib.TFRecordProvider(
        arg, example_secs=n_samples / sample_rate,
        sample_rate=sample_rate, frame_rate=frame_rate)
  if kind == 'synthetic_notes':
    return data_lib.SyntheticNotesProvider(
        n_timesteps=model_kwargs.get('time_steps', control_frames or 125),
        n_harmonics=model_kwargs.get('n_harmonics',
                                     model_kwargs.get('n_sinusoids', 100)),
        n_mags=model_kwargs.get('n_noise_magnitudes', 65),
        file_pattern=arg or None,
        sample_rate=sample_rate, device=device)
  if kind == 'urmp':
    base_dir, _, instrument = arg.partition(':')
    return data_lib.UrmpMidi(base_dir,
                             instrument_key=instrument or 'all',
                             sample_rate=sample_rate,
                             frame_rate=frame_rate)
  if kind == 'nsynth':
    # The ICLR2020 NSynth experiment's feed.
    split, _, data_dir = arg.partition(':')
    kwargs = dict(split=split or 'train',
                  sample_rate=sample_rate, frame_rate=frame_rate)
    if data_dir:
      kwargs['data_dir'] = data_dir
    return data_lib.NSynthTfds(**kwargs)
  if kind == 'tfds':
    name, split, data_dir = parse_tfds_spec(arg)
    return data_lib.TfdsProvider(name, split or 'train',
                                 data_dir=data_dir or None,
                                 sample_rate=sample_rate,
                                 frame_rate=frame_rate)
  raise ValueError(
      f'Unknown data spec {spec!r} '
      "(use 'synthetic[:n]', 'tfrecord:<pattern>', "
      "'synthetic_notes[:pattern]', 'urmp:<dir>[:inst]', "
      "'nsynth[:split[:data_dir]]', or 'tfds:<name>:<split>')")


def parse_tfds_spec(arg: str):
  """'<name>[:<version>]:<split>[:data_dir]' -> (name, split, data_dir).

  A version-like segment (e.g. '2.3.0') after the name is folded back into
  the name, so 'nsynth/gansynth_subset.f0_and_loudness:2.3.0:train'
  parses; everything after the split is the data_dir verbatim (it may hold
  colons, as gs://bucket/path does).
  """
  name, _, rest = arg.partition(':')
  head, _, tail = rest.partition(':')
  if re.fullmatch(r'\d+(\.\d+)*', head or ''):
    name, rest = f'{name}:{head}', tail
    head, _, tail = rest.partition(':')
  return name, head, tail


def provider_geometry(preset_name: str, model_kwargs, default_sample_rate,
                      default_frame_rate):
  """(resolved kwargs, n_samples, sample_rate, frame_rate) from the preset's
  own defaults merged with the overrides ('tiny' has n_samples=16000; 'vst'
  gives seconds and frame_rate), so the data matches the model."""
  from ddsp_torch.utils import registry  # pylint: disable=g-import-not-at-top
  preset_fn = registry.get_preset(preset_name)
  preset_defaults = {
      k: p.default for k, p in inspect.signature(preset_fn).parameters.items()
      if p.default is not inspect.Parameter.empty}
  resolved = dict(preset_defaults, **model_kwargs)
  sample_rate = resolved.get('sample_rate', default_sample_rate)
  frame_rate = resolved.get('frame_rate', default_frame_rate)
  if 'n_samples' in resolved:
    n_samples = resolved['n_samples']
  elif 'seconds' in resolved:
    n_samples = int(resolved['seconds'] * sample_rate)
  else:
    n_samples = 64000
  return resolved, n_samples, sample_rate, frame_rate


def visible_devices(device: str, n_devices: int) -> List[torch.device]:
  """The devices a run may use: every visible card for 'cuda' (raises
  without one), the named one for 'cuda:<i>', the host for 'cpu'; at most
  n_devices of them (0: all)."""
  if device == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError('--device cuda (the default) needs a CUDA card, '
                         'and none is available; pass --device cpu.')
    devices = [torch.device('cuda', i)
               for i in range(torch.cuda.device_count())]
  else:
    devices = [torch.device(device)]
  return devices[:n_devices] if n_devices else devices


def main(argv: Optional[List[str]] = None):
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument('--mode', default='train',
                      choices=['train', 'eval', 'sample'])
  parser.add_argument('--preset', default='solo_instrument',
                      help='Model preset name (ddsp_torch.configs)')
  parser.add_argument('--model_kwargs', default='{}',
                      help='JSON kwargs overriding the preset')
  parser.add_argument('--save_dir', required=True)
  parser.add_argument('--restore_dir', default='',
                      help='Defaults to save_dir')
  parser.add_argument('--data', default='synthetic',
                      help="'synthetic[:n]', 'tfrecord:<glob>', ... "
                      '(build_data_provider)')
  parser.add_argument('--batch_size', type=int, default=32)
  parser.add_argument('--num_steps', type=int, default=1000000)
  parser.add_argument('--steps_per_summary', type=int, default=300)
  parser.add_argument('--steps_per_save', type=int, default=300)
  parser.add_argument('--learning_rate', type=float, default=3e-4)
  parser.add_argument('--early_stop_loss_value', type=float, default=None)
  parser.add_argument('--sample_rate', type=int, default=16000)
  parser.add_argument('--frame_rate', type=int, default=250)
  parser.add_argument('--num_eval_batches', type=int, default=4)
  parser.add_argument('--run_once', action='store_true')
  parser.add_argument('--device', default='cuda',
                      help="'cuda' (every visible card; the default), "
                      "'cuda:<i>' or 'cpu'")
  parser.add_argument('--profile_dir', default='',
                      help='Capture a torch.profiler trace to this '
                      'directory')
  parser.add_argument('--multihost', action='store_true',
                      help='One process per card under torchrun: start '
                      "torch.distributed from torchrun's environment and "
                      'train, evaluate or sample on a mesh over the ranks')
  parser.add_argument('--dist_backend', choices=distributed.BACKENDS,
                      default=None,
                      help="--multihost's torch.distributed backend "
                      "(default: 'nccl' on CUDA, 'gloo' on the CPU)")
  parser.add_argument('--n_devices', type=int, default=0,
                      help='Limit device count (0 = all)')
  parser.add_argument('--time_shards', type=int, default=1,
                      help='Shard the audio time axis over this many '
                      'devices (sequence parallelism); the mesh becomes '
                      '(data=n_devices/time_shards, time=time_shards)')
  parser.add_argument('--halo_impl', choices=('xla', 'pallas'),
                      default='xla',
                      help="The JAX package's names for the time-sharded "
                      "neighbour exchange; the port has one (kernel K3 on "
                      'the card) and takes either name')
  args = parser.parse_args(argv)

  logging.basicConfig(
      level=logging.INFO,
      format='%(asctime)s %(name)s %(levelname)s: %(message)s')

  if args.multihost:
    device = rank_device(args.device)
    distributed.init(device=device, backend=args.dist_backend)
    try:
      return _main(args, device)
    finally:
      distributed.shutdown()
  devices = visible_devices(args.device, args.n_devices)
  if len(devices) > 1:
    raise NotImplementedError(
        f'{len(devices)} devices in one process: the port runs one process '
        'per card (--multihost under torchrun, scripts/launch_torchrun.sh); '
        'one process driving several cards is ROADMAP.md queue 1 item 8. '
        'Pass --n_devices 1.')
  return _main(args, devices[0])


def rank_device(device: str) -> torch.device:
  """A rank's device: cuda:LOCAL_RANK for 'cuda' (torchrun's one process
  per card), else the named card or the CPU."""
  if device == 'cuda':
    return torch.device('cuda', distributed.local_rank())
  return torch.device(device)


def _main(args, device: torch.device):
  """The run of main() on this process's device: one device per process,
  alone or as a rank of a process group."""
  n_devices = distributed.world_size()
  if n_devices % args.time_shards:
    raise SystemExit(f'--time_shards {args.time_shards} must divide the '
                     f'device count ({n_devices})')
  # pylint: disable=g-import-not-at-top
  from ddsp_torch import utils
  from ddsp_torch.parallel import create_mesh
  from ddsp_torch.train import Trainer, train

  model_kwargs = json.loads(args.model_kwargs)

  if args.mode == 'train':
    preset_name = args.preset
    model = utils.build_model(args.preset, device=device, seed=0,
                              **model_kwargs)
    if distributed.rank() == 0:
      utils.save_spec(args.save_dir, args.preset, **model_kwargs)
  else:
    # The trained architecture from the operative spec, its preset name
    # included, so the geometry below follows the TRAINED preset.
    restore_dir = args.restore_dir or args.save_dir
    model = utils.model_from_spec(restore_dir, device=device, **model_kwargs)
    spec = utils.load_spec(restore_dir)
    preset_name = spec['preset']
    model_kwargs = dict(spec['kwargs'], **model_kwargs)

  resolved, n_samples, sample_rate, frame_rate = provider_geometry(
      preset_name, model_kwargs, args.sample_rate, args.frame_rate)
  provider = build_data_provider(args.data, n_samples, sample_rate,
                                 frame_rate, resolved, device=device,
                                 control_frames=getattr(model, 'n_frames',
                                                        None))

  mesh = create_mesh(n_data=n_devices // args.time_shards,
                     n_time=args.time_shards, devices=[device])
  trainer = Trainer(model, mesh=mesh, learning_rate=args.learning_rate,
                    halo_impl=args.halo_impl)

  if args.mode == 'train':
    # Each data row's ranks read their own examples (--batch_size a rank).
    shard = (mesh.shard_coords(0)[0], mesh.n_data)
    iterator = provider.get_batch(args.batch_size, shuffle=True, repeats=-1,
                                  shard=shard)
    return train(iterator, trainer,
                 num_steps=args.num_steps,
                 steps_per_summary=args.steps_per_summary,
                 steps_per_save=args.steps_per_save,
                 save_dir=args.save_dir,
                 restore_dir=args.restore_dir or args.save_dir,
                 early_stop_loss_value=args.early_stop_loss_value,
                 profile_dir=args.profile_dir or None)
  from ddsp_torch.eval import eval_util  # pylint: disable=g-import-not-at-top
  return eval_util.evaluate_or_sample(
      provider, trainer,
      save_dir=args.save_dir,
      restore_dir=args.restore_dir or args.save_dir,
      mode=args.mode,
      batch_size=min(args.batch_size, 4) * mesh.n_data,
      num_batches=args.num_eval_batches,
      run_once=args.run_once)


if __name__ == '__main__':
  main()
