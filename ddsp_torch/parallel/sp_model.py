"""Sequence-parallel forward of a full model.

Port of ddsp_tpu/parallel/sp_model.py. `sp_forward_with_losses` runs an
Autoencoder-style model with the audio time axis sharded over the mesh's
'time' axis; the Trainer reaches it when its mesh shards time. The
frame-rate network (preprocessor, encoder, decoder, every processor's
`get_controls`) runs once on the mesh's first device, where the JAX package
runs it replicated with the same values. The audio-rate signal path goes
through the time-sharded kernels of parallel/time_shard.py:

  * Harmonic             -> time_sharded_harmonic_synthesis (phase carry)
  * FilteredNoise        -> FIR design + time_sharded_fft_convolve on the
                            noise, drawn globally from the same generator,
                            in the same order, as the dense path
  * Reverb               -> time_sharded_fft_convolve, delay 0, dry mask
  * FIRFilter            -> FIR design + time_sharded_fft_convolve
  * anything else        -> the processor's own signal on global tensors
  * SpectralLoss (L1)    -> time_sharded_spectral_loss (all six terms)
  * other losses         -> called on the global tensors

As in the JAX package, the sharded loss is float32 whatever the
SpectralLoss's compute_dtype, and only an Autoencoder-style model takes the
sharded forward (`check_sp_model`).

On a mesh over ranks (parallel/mesh.py) each rank runs the frame-rate
network on its data rows' features, replicated over 'time' as the JAX
shard_map does, and synthesizes its own shards only: the audio-rate
signals are process-local ([its rows, its span's samples]), and the target
audio is cut to the rank's span after the preprocessor has read all of it.
FilteredNoise draws the global batch's noise and keeps the rank's rows and
samples, so R ranks draw what one process draws. Where the JAX package
lets GSPMD gather the global arrays, the port gathers them itself:

  * a node without a time-sharded signal (Crop, Mix, TensorToAudio,
    Wavetable, Sinusoidal, ModDelay; Add needs nothing) on a rank that
    shares its data rows gathers its process-local signal inputs over the
    ranks (mesh.gather_rows: the whole signal of each of its rows, one or
    several), runs its own get_controls and render on them, and keeps the
    rank's span of the output, whose length may differ from the input's
    (a Crop);
  * a loss other than an L1 SpectralLoss gathers the target and the
    synthesized audio over every rank, rows and samples
    (mesh.gather_local), and every rank computes the global batch's loss,
    the value one process computes.

A rank that holds whole data rows has every sample of its rows: its nodes
run as in one process on its rows, and only the losses gather.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ddsp_torch.losses.spectral import SpectralLoss
from ddsp_torch.models.autoencoder import Autoencoder
from ddsp_torch.ops import fftconv as fftconv_ops
from ddsp_torch.ops.core import nested_lookup, to_dict, torch_float32
from ddsp_torch.parallel import time_shard
from ddsp_torch.parallel.mesh import (Mesh, gather_local, gather_rows,
                                      local_time, time_span)
from ddsp_torch.proc import dags
from ddsp_torch.proc import effects as effects_lib
from ddsp_torch.proc import processors as processors_lib
from ddsp_torch.proc import synths as synths_lib
from ddsp_torch.proc.dags import loss_module_name

TensorDict = Dict[str, Any]


def has_time_sharding(mesh: Optional[Mesh]) -> bool:
  """True when the mesh actually shards the audio time axis."""
  return mesh is not None and mesh.n_time > 1


def check_sp_model(model) -> None:
  """Raise a ValueError unless the sharded forward takes the model.

  It runs an Autoencoder's encode, decoder, processor group and losses. A
  MidiAutoencoder or an InverseSynthesis model has no `encode` (the JAX
  package's sharded forward fails on it with an AttributeError).
  """
  if not isinstance(model, Autoencoder):
    raise ValueError(
        f'The time-sharded forward takes an Autoencoder (preprocessor, '
        f'encoder, decoder, processor group, losses); got '
        f'{type(model).__name__}. Evaluate or train it on a mesh that does '
        'not shard time.')


def _sp_get_signal(module, controls: TensorDict, mesh: Mesh, halo_impl: str,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
  """A processor's signal with the audio-rate work time-sharded."""
  if isinstance(module, synths_lib.Harmonic):
    return time_shard.time_sharded_harmonic_synthesis(
        mesh, controls['f0_hz'], controls['amplitudes'],
        controls['harmonic_distribution'], n_samples=module.n_samples,
        sample_rate=module.sample_rate,
        amp_resample_method=module.amp_resample_method)

  if isinstance(module, synths_lib.FilteredNoise):
    magnitudes = controls['magnitudes']
    noise = local_time(mesh, module.draw_noise(
        int(magnitudes.shape[0]), magnitudes.device, noise, generator))
    ir = fftconv_ops.frequency_impulse_response(
        magnitudes, window_size=module.window_size)
    return time_shard.time_sharded_fft_convolve(mesh, noise, ir,
                                                halo_impl=halo_impl)

  if isinstance(module, effects_lib.Reverb):
    audio = torch_float32(controls['audio'])
    ir = effects_lib._mask_dry_ir(torch_float32(controls['ir']))  # pylint: disable=protected-access
    wet = time_shard.time_sharded_fft_convolve(mesh, audio, ir,
                                               delay_compensation=0,
                                               halo_impl=halo_impl)
    return (wet + audio) if module.add_dry else wet

  if isinstance(module, effects_lib.FIRFilter):
    ir = fftconv_ops.frequency_impulse_response(
        controls['magnitudes'], window_size=module.window_size)
    return time_shard.time_sharded_fft_convolve(mesh, controls['audio'], ir,
                                                halo_impl=halo_impl)

  # Elementwise routing (Add, Mix, TensorToAudio) is shape-preserving and
  # works on the global tensors as they are; anything else (Wavetable,
  # Sinusoidal, ModDelay) falls back to its dense implementation on the
  # global tensors: the values are the same, only the node is not sharded.
  # Across ranks such a node gathers its inputs first (_sp_render_gathered).
  return module.render(controls, noise=noise, generator=generator)


def _gathers_inputs(module, mesh: Mesh) -> bool:
  """Whether the node needs its data rows' whole signals on this rank: a
  node without a time-sharded signal, other than Add, on a rank that
  shares its rows with other ranks."""
  return (mesh.ranks is not None and mesh.ranks.shares_rows
          and not isinstance(module, (synths_lib.Harmonic,
                                      synths_lib.FilteredNoise,
                                      effects_lib.Reverb,
                                      effects_lib.FIRFilter,
                                      processors_lib.Add)))


def _sp_render_gathered(module, name: str, node_inputs, local_signals,
                        mesh: Mesh, noise: Optional[torch.Tensor] = None,
                        generator: Optional[torch.Generator] = None
                        ) -> TensorDict:
  """A node's outputs on a rank that shares its data rows: its
  process-local signal inputs gathered over the ranks, its own controls
  and signal on its rows' whole signals, the rank's span of the signal
  kept. The signal's length over the time shards must divide, whatever the
  node does to it."""
  gathered = [gather_rows(mesh, x)
              if any(x is s for s in local_signals) else x
              for x in node_inputs]
  controls = module.get_controls(*gathered)
  signal = module.render(controls, noise=noise, generator=generator)
  n_in = [int(x.shape[1]) for x in gathered
          if any(x is s for s in local_signals)]
  n_out = int(signal.shape[1])
  if n_out % mesh.n_time:
    raise ValueError(
        f'The output of node {name!r} ({type(module).__name__}) has '
        f'{n_out} samples (from {n_in}), which do not divide over '
        f'{mesh.n_time} time shards.')
  return dict(signal=signal[:, time_span(mesh, n_out)], controls=controls)


def sp_run_dag(pg, inputs: TensorDict, mesh: Mesh, halo_impl: str = 'xla',
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> TensorDict:
  """ProcessorGroup.run_dag with time-sharded signal generation.

  Mirrors DAGModule.run_dag node for node (the same dispatch, nested keys
  and outputs contract); only processor nodes take the time-sharded path.
  Across ranks every processor's signal is process-local (module
  docstring).
  """
  local_signals = []  # the processors' signals, time-local across ranks
  outputs = dict(inputs)
  outputs['inputs'] = inputs
  module_outputs = {}
  for name, in_keys, out_keys in zip(pg.node_names, pg.node_input_keys,
                                     pg.node_output_keys):
    module = getattr(pg, name)
    node_inputs = [nested_lookup(key, outputs) for key in in_keys]
    if dags.is_processor(module):
      if _gathers_inputs(module, mesh):
        module_outputs = _sp_render_gathered(module, name, node_inputs,
                                             local_signals, mesh, noise,
                                             generator)
      else:
        controls = module.get_controls(*node_inputs)
        signal = _sp_get_signal(module, controls, mesh, halo_impl, noise,
                                generator)
        module_outputs = dict(signal=signal, controls=controls)
      local_signals.append(module_outputs['signal'])
    elif dags.is_loss(module):
      module_outputs = module.get_losses_dict(*node_inputs)
    else:
      module_outputs = module(*node_inputs)
      if not isinstance(module_outputs, dict):
        module_outputs = to_dict(module_outputs, out_keys)
    outputs[name] = module_outputs
  outputs['out'] = module_outputs
  return outputs


def _sp_loss(loss_obj, target_audio: torch.Tensor, audio: torch.Tensor,
             mesh: Mesh, halo_impl: str) -> torch.Tensor:
  """SpectralLoss (L1) through the time-sharded kernels; others on the
  global tensors, gathered from every rank across ranks."""
  if mesh.ranks is not None:
    target_audio = local_time(mesh, target_audio)
  if (isinstance(loss_obj, SpectralLoss)
      and loss_obj.loss_type.upper() == 'L1'):
    return time_shard.time_sharded_spectral_loss(
        mesh, target_audio, audio, fft_sizes=tuple(loss_obj.fft_sizes),
        mag_weight=loss_obj.mag_weight,
        delta_time_weight=loss_obj.delta_time_weight,
        delta_freq_weight=loss_obj.delta_freq_weight,
        cumsum_freq_weight=loss_obj.cumsum_freq_weight,
        logmag_weight=loss_obj.logmag_weight,
        loudness_weight=loss_obj.loudness_weight, halo_impl=halo_impl)
  if mesh.ranks is not None:
    target_audio = gather_local(mesh, target_audio)
    audio = gather_local(mesh, audio)
  return loss_obj(target_audio, audio)


def sp_forward_with_losses(model, features: TensorDict, mesh: Mesh,
                           halo_impl: str = 'xla', training: bool = True,
                           noise: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None
                           ) -> Tuple[TensorDict, TensorDict]:
  """Full-model forward and losses with the audio time axis sharded.

  Takes an Autoencoder-style model (preprocessor, optional encoder,
  decoder, processor_group, losses) and features on the mesh's first
  device; noise/generator feed FilteredNoise as in the dense forward.
  Returns (outputs, losses_dict with 'total_loss'), the contract of
  model(features, return_losses=True). Raises a ValueError for a model that
  is not an Autoencoder (`check_sp_model`).
  """
  check_sp_model(model)
  features = model.encode(features, training=training)
  features = dict(features)
  features.update(model.decoder(features))

  dag_out = sp_run_dag(model.processor_group, features, mesh,
                       halo_impl=halo_impl, noise=noise, generator=generator)
  outputs = dict(dag_out)
  outputs['audio_synth'] = dag_out['out']['signal']

  losses_dict = {}
  for loss_obj in model.losses:
    name = loss_module_name(loss_obj)
    while name in losses_dict:
      name += '_'
    losses_dict[name] = _sp_loss(loss_obj, features['audio'],
                                 outputs['audio_synth'], mesh, halo_impl)
  losses_dict['total_loss'] = torch.sum(torch.stack(
      list(losses_dict.values())))
  return outputs, losses_dict
