"""Model export: portable artifacts from a port train directory.

Port of ddsp_tpu/infer/export.py. Reference behavior: magenta/ddsp's
ddsp/training/ddsp_export.py.

  * fmt='params': operative_spec.json (the spec with the inference
    mutations applied) and params.npz, the model's named_parameters() with
    '/' in place of '.': the flat flax tree that the JAX package's
    `unflatten` + `model.apply` and the port's `load_jax_params` both take.
    It holds no optimizer state.
  * fmt='torch_export': the port's compiled format, its counterpart of the
    JAX package's 'stablehlo', 'savedmodel' and 'tflite': one
    torch.export program, <export_dir>/<inference_model>.pt2, for the
    autoencoder or any of the six VST signatures, at the JAX signatures'
    static shapes (ddsp_tpu/infer/export.py:72-136), weights and the noise
    baked in, plus operative_spec.json. The kernels are torch.library ops
    (ddsp_torch::harmonic_fwd, ::gru_fwd, ...), so the program launches
    them itself; `load_program` reads it back.
  * export_impulse_response: the trained reverb's impulse response as a
    16-bit wav.

The JAX package's other formats need converters that are not here (no
jax2tf, no TensorFlow Lite, no onnx): 'stablehlo', 'savedmodel', 'tflite'
and 'tfjs' raise NotImplementedError naming fmt='torch_export'.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.export.passes import move_to_device_pass

import ddsp_torch.kernels  # noqa: F401  registers the ops a program calls
from ddsp_torch.eval.summaries import write_wav
from ddsp_torch.infer import inference as inf
from ddsp_torch.ops.crepe import full_float32
from ddsp_torch.ops.resample import resample
from ddsp_torch.utils import registry
from ddsp_torch.utils.device import DeviceLike, resolve_device

_UNCONVERTED_FORMATS = ('stablehlo', 'savedmodel', 'tflite', 'tfjs')
INFERENCE_MODELS = ('autoencoder', 'vst_extract_features',
                    'vst_predict_controls', 'vst_stateless_predict_controls',
                    'vst_synthesize', 'vst_synthesize_harmonic',
                    'vst_synthesize_noise')
# Presets whose models run from audio, not from (f0, loudness) features:
# AutoencoderInference cannot serve them (the JAX export fails on one).
_VST_PRESETS = ('vst',)
# A .pt2's own record of how it must be called (`load_program`).
PROGRAM_META = 'ddsp_torch.json'


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
  """Inverse of the exporter's flattening ('a/b/c' keys -> nested dict)."""
  tree: Dict[str, Any] = {}
  for key, v in flat.items():
    parts = key.split('/')
    node = tree
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = v
  return tree


def _write_operative_spec(save_dir: str, export_dir: str, model) -> None:
  """Write the MUTATED inference spec next to the artifact.

  A runtime rebuilding the model from this JSON gets the exact
  architecture the exported params belong to (reverb removal and the new
  n_samples/time_steps included), not the train-time one.
  """
  spec = dict(registry.load_spec(save_dir))
  spec['kwargs'] = dict(spec['kwargs'],
                        **getattr(model, 'applied_mutations', {}))
  with open(os.path.join(export_dir, registry.SPEC_FILENAME), 'w') as f:
    json.dump(spec, f, indent=2, sort_keys=True)


class _Signature(torch.nn.Module):
  """One inference signature as a Module for torch.export: forward is
  `call` on the signature's tensors. `modules` are registered so that
  their parameters become the program's; any other tensor `call` reads
  (a noise buffer, CREPE's weights and tables) becomes a constant of it."""

  def __init__(self, call: Callable[..., Any], **modules: torch.nn.Module):
    super().__init__()
    self.call = call
    for name, module in modules.items():
      self.add_module(name, module)

  def forward(self, *args):
    return self.call(*args)


def autoencoder_noise(model: inf.AutoencoderInference
                      ) -> Dict[str, torch.Tensor]:
  """{node name: noise} of each noise processor of the model's group, as
  a request without `noise` draws it (FilteredNoise's rule: a generator on
  the model's device seeded with 0), so a program with this noise renders
  what AutoencoderInference renders."""
  group = model.model.processor_group
  noise = {}
  for name in group.node_names:
    module = getattr(group, name)
    synth = getattr(module, 'ir_synth', module)  # FilteredNoiseReverb's IR
    if hasattr(synth, 'draw_noise'):
      noise[name] = synth.draw_noise(1, model.device)
  return noise


def _signature(save_dir: str, inference_model: str,
               length_seconds: float = 4,
               noise: Optional[Any] = None,
               **kwargs) -> Tuple[Any, _Signature, Dict[str, torch.Tensor]]:
  """(inference object, its Module, ordered {input name: example}).

  The inputs and their static shapes are those of the JAX package's
  `_tf_export_signature` (ddsp_tpu/infer/export.py:72-136). The stateful
  'vst_predict_controls' exports the stateless signature (state in and
  out), as there. `noise` replaces the baked noise: the autoencoder's
  (a tensor [1, n_samples] for each noise processor, or a dict {node
  name: tensor}) or VSTSynthesize's `noise_signal` [1, hop_size].
  **kwargs go to the inference class (device= among them).
  """
  def zeros(*shape):
    return torch.zeros(shape, device=m.device)

  if inference_model == 'autoencoder':
    m = inf.AutoencoderInference(save_dir, length_seconds=length_seconds,
                                 **kwargs)
    if noise is None:
      noise = autoencoder_noise(m)

    def call(f0_hz, loudness_db):
      return m({'f0_hz': f0_hz, 'loudness_db': loudness_db},
               noise=noise)['audio_synth']

    return m, _Signature(call, model=m.model), {
        'f0_hz': zeros(1, m.n_frames, 1),
        'loudness_db': zeros(1, m.n_frames, 1)}

  if inference_model == 'vst_extract_features':
    m = inf.VSTExtractFeatures(save_dir, **kwargs)
    modules = {'preprocessor': m.preprocessor}
    if m.preprocessor.crepe is not None:
      modules['crepe'] = m.preprocessor.crepe.model
    return m, _Signature(m, **modules), {'audio': zeros(m.frame_size)}

  if inference_model in ('vst_predict_controls',
                         'vst_stateless_predict_controls'):
    m = inf.VSTStatelessPredictControls(save_dir, **kwargs)
    return m, _Signature(m, model=m.model), {
        'f0_scaled': zeros(1), 'pw_scaled': zeros(1),
        'state': zeros(m.state_size)}

  synths = {'vst_synthesize': inf.VSTSynthesize,
            'vst_synthesize_harmonic': inf.VSTSynthesizeHarmonic,
            'vst_synthesize_noise': inf.VSTSynthesizeNoise}
  if inference_model not in synths:
    raise ValueError(f'Unknown inference_model {inference_model!r}; one of '
                     f'{INFERENCE_MODELS}.')
  m = synths[inference_model](save_dir, **kwargs)
  if noise is not None:
    m.noise_signal = torch.as_tensor(noise, dtype=torch.float32,
                                     device=m.device)
  controls = {'amps': zeros(1), 'prev_amps': zeros(1),
              'hd': zeros(m.n_harmonics), 'prev_hd': zeros(m.n_harmonics),
              'f0': zeros(1), 'prev_f0': zeros(1)}
  if inference_model == 'vst_synthesize_noise':
    args = {'noise': zeros(m.n_noise)}
  else:
    args = dict(controls, prev_phase=zeros(1))
    if inference_model == 'vst_synthesize':
      args = dict(controls, noise=zeros(m.n_noise), prev_phase=zeros(1))
  return m, _Signature(m), args


def _export_program(save_dir: str, export_dir: str,
                    inference_model: str = 'autoencoder',
                    length_seconds: float = 4,
                    noise: Optional[Any] = None, **kwargs) -> str:
  """Write <export_dir>/<inference_model>.pt2 and operative_spec.json.

  The program is traced on the inference object's device (CUDA unless
  device='cpu' is given) with the kernels as ops, so on the card it
  launches them; `_signature` gives its inputs. A program that runs CREPE
  records that it must be called in full float32 (`load_program` does).
  Returns the program's path.
  """
  kwargs['device'] = resolve_device(kwargs.get('device'))
  m, module, args = _signature(save_dir, inference_model, length_seconds,
                               noise, **kwargs)
  os.makedirs(export_dir, exist_ok=True)
  _write_operative_spec(save_dir, export_dir, m)
  pin = inference_model == 'vst_extract_features' and (
      m.preprocessor.crepe is not None)
  with torch.no_grad(), full_float32() if pin else contextlib.nullcontext():
    program = torch.export.export(module, tuple(args.values()), strict=False)
  meta = {'inference_model': inference_model, 'inputs': list(args),
          'full_float32': pin}
  path = os.path.join(export_dir, f'{inference_model}.pt2')
  torch.export.save(program, path,
                    extra_files={PROGRAM_META: json.dumps(meta)})
  return path


class Program:
  """A loaded program: call it with the signature's tensors, in order.

  Attributes:
    program: The torch.export ExportedProgram.
    module: Its callable module.
    meta: What the exporter recorded: 'inference_model', 'inputs' (the
      input names in order), 'full_float32' (CREPE's convolutions and
      matmuls run in full float32 whatever the process's TF32 settings,
      as the eager class pins them).
  """

  def __init__(self, program, meta: Dict[str, Any]):
    self.program = program
    self.module = program.module()
    self.meta = meta

  @torch.no_grad()
  def __call__(self, *args):
    with full_float32() if self.meta['full_float32'] else (
        contextlib.nullcontext()):
      return self.module(*args)


def load_program(path: str, device: DeviceLike = None) -> Program:
  """Load a fmt='torch_export' program onto `device` (CUDA by default).

  Importing ddsp_torch registers the kernels' ops, which the program calls
  by name; this module imports them, so load a program through here (or
  after `import ddsp_torch.kernels`). A program traced on another device
  is moved to this one; on CUDA its ops launch the kernels, on the CPU
  they run the plain versions.
  """
  device = resolve_device(device)
  extra = {PROGRAM_META: ''}
  program = torch.export.load(path, extra_files=extra)
  program = move_to_device_pass(program, device)
  return Program(program, json.loads(extra[PROGRAM_META]))


def export_model(save_dir: str, export_dir: str,
                 fmt: str = 'params',
                 inference_model: str = 'autoencoder',
                 length_seconds: float = 4,
                 **kwargs) -> str:
  """Export a trained model directory to a deployment artifact.

  Args:
    save_dir: A port train directory (operative_spec.json + ckpt-*.pt), or
      a params-format export.
    export_dir: Output directory.
    fmt: 'params' (npz + spec json) or 'torch_export' (a .pt2 program +
      spec json, `_export_program`).
    inference_model: 'autoencoder' or, for 'torch_export', one of the six
      VST signatures (INFERENCE_MODELS). 'params' exports the autoencoder
      of an autoencoder preset only. A model whose encoder reads audio (the
      ae and inverse_synthesis presets), or a MidiAutoencoder (midiae),
      has no autoencoder artifact: both formats raise
      AutoencoderInference's ValueError.
    length_seconds: Generation length the exported autoencoder is built
      for.
    **kwargs: Overrides for the inference class (e.g. remove_reverb, or
      device='cpu'; CUDA otherwise); for 'torch_export' also `noise`.

  Returns:
    Path of params.npz or of the program.
  """
  if fmt in _UNCONVERTED_FORMATS:
    raise NotImplementedError(
        f"fmt={fmt!r} needs a converter this environment does not have "
        "(jax2tf, TensorFlow Lite, tensorflowjs); the port's compiled "
        "format is fmt='torch_export', a torch.export program.")
  if fmt == 'torch_export':
    return _export_program(save_dir, export_dir, inference_model,
                           length_seconds, **kwargs)
  if fmt != 'params':
    raise ValueError(f'Unknown export format {fmt!r}')
  if inference_model != 'autoencoder':
    raise ValueError(
        f"fmt={fmt!r} supports inference_model='autoencoder' only; VST "
        "signatures export with fmt='torch_export'.")
  preset = registry.load_spec(save_dir)['preset']
  if preset in _VST_PRESETS:
    raise ValueError(
        f"fmt='params' exports an autoencoder, and {save_dir!r} holds the "
        f"{preset!r} preset. The VST classes (VSTStatelessPredictControls, "
        "VSTSynthesize, ...) read its train directory as it is; export "
        "their programs with fmt='torch_export' and a VST inference_model.")

  os.makedirs(export_dir, exist_ok=True)
  model = inf.AutoencoderInference(save_dir, length_seconds=length_seconds,
                                   **kwargs)
  _write_operative_spec(save_dir, export_dir, model)
  path = os.path.join(export_dir, inf.PARAMS_FILENAME)
  np.savez(path, **{name.replace('.', '/'): p.detach().cpu().numpy()
                    for name, p in model.model.named_parameters()})
  return path


def export_impulse_response(save_dir: str, export_dir: str,
                            target_sr: Optional[int] = None,
                            device: DeviceLike = None) -> str:
  """Extract a trained model's reverb impulse response and save it as wav.

  Mirrors reference ddsp_export.py:273 (export_impulse_response): restore
  the autoencoder with its room reverb intact, run one silent forward pass,
  and pull the 'ir' control out of the reverb processor's outputs.

  Args:
    save_dir: A port train directory or a params-format export that keeps
      the reverb.
    export_dir: Output directory for reverb_ir_<sr>_hz.wav.
    target_sr: Optionally also write a linearly-resampled copy at this rate.
    device: Where the forward pass runs (CUDA unless 'cpu' is given).

  Returns:
    Path of the impulse-response wav at the model's native sample rate.
  """
  model = inf.AutoencoderInference(save_dir, length_seconds=1,
                                   remove_reverb=False, device=device)
  sr = model.sample_rate
  outputs = model({
      'f0_hz': np.full((model.n_frames,), 220.0, np.float32),
      'loudness_db': np.full((model.n_frames,), -40.0, np.float32),
  })
  ir = None
  for value in outputs.values():
    if isinstance(value, dict) and 'ir' in value.get('controls', {}):
      ir = value['controls']['ir'][0].detach().cpu()
      break
  if ir is None:
    raise ValueError(f'No reverb processor with an "ir" control found in '
                     f'the model restored from {save_dir!r}')
  print(f'Reverb impulse response is {ir.shape[0] / sr:.3f} seconds long')

  os.makedirs(export_dir, exist_ok=True)
  path = os.path.join(export_dir, f'reverb_ir_{sr}_hz.wav')
  write_wav(path, ir.numpy(), sr)
  if target_sr is not None and target_sr != sr:
    n_target = int(round(ir.shape[0] * target_sr / sr))
    ir_rs = resample(ir[None, :], n_target, method='linear',
                     add_endpoint=False)[0]
    write_wav(os.path.join(export_dir, f'reverb_ir_{target_sr}_hz.wav'),
              ir_rs.numpy(), target_sr)
  return path
