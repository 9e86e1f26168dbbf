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
  * anything else        -> the processor's own signal on global tensors
  * SpectralLoss (L1)    -> time_sharded_spectral_loss (all six terms)
  * other losses         -> called on the global tensors

FIRFilter's branch comes with FIRFilter (ROADMAP.md queue 1 item 6). As in
the JAX package, the sharded loss is float32 whatever the SpectralLoss's
compute_dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ddsp_torch.losses.spectral import SpectralLoss
from ddsp_torch.ops import fftconv as fftconv_ops
from ddsp_torch.ops.core import nested_lookup, to_dict, torch_float32
from ddsp_torch.parallel import time_shard
from ddsp_torch.parallel.mesh import Mesh
from ddsp_torch.proc import dags
from ddsp_torch.proc import effects as effects_lib
from ddsp_torch.proc import synths as synths_lib
from ddsp_torch.proc.dags import loss_module_name

TensorDict = Dict[str, Any]


def has_time_sharding(mesh: Optional[Mesh]) -> bool:
  """True when the mesh actually shards the audio time axis."""
  return mesh is not None and mesh.n_time > 1


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
    noise = module.draw_noise(int(magnitudes.shape[0]), magnitudes.device,
                              noise, generator)
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

  # Elementwise routing (Add) works on the global tensors as it is.
  return module.render(controls, noise=noise, generator=generator)


def sp_run_dag(pg, inputs: TensorDict, mesh: Mesh, halo_impl: str = 'xla',
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> TensorDict:
  """ProcessorGroup.run_dag with time-sharded signal generation.

  Mirrors DAGModule.run_dag node for node (the same dispatch, nested keys
  and outputs contract); only processor nodes take the time-sharded path.
  """
  outputs = dict(inputs)
  outputs['inputs'] = inputs
  module_outputs = {}
  for name, in_keys, out_keys in zip(pg.node_names, pg.node_input_keys,
                                     pg.node_output_keys):
    module = getattr(pg, name)
    node_inputs = [nested_lookup(key, outputs) for key in in_keys]
    if dags.is_processor(module):
      controls = module.get_controls(*node_inputs)
      signal = _sp_get_signal(module, controls, mesh, halo_impl, noise,
                              generator)
      module_outputs = dict(signal=signal, controls=controls)
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
  global tensors."""
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
  model(features, return_losses=True).
  """
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
