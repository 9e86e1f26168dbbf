"""Model export: a portable artifact from a port train directory.

Port of ddsp_tpu/infer/export.py (:35-69, :186-299). Reference behavior:
magenta/ddsp's ddsp/training/ddsp_export.py.

  * fmt='params': operative_spec.json (the spec with the inference
    mutations applied) and params.npz, the model's named_parameters() with
    '/' in place of '.': the flat flax tree that the JAX package's
    `unflatten` + `model.apply` and the port's `load_jax_params` both take.
    It holds no optimizer state.
  * export_impulse_response: the trained reverb's impulse response as a
    16-bit wav.

The JAX package's compiled formats ('stablehlo', 'savedmodel', 'tflite')
become torch.export artifacts in ROADMAP.md queue 1 item 4 and raise
NotImplementedError here; 'tfjs' raises as it does in the JAX package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from ddsp_torch.eval.summaries import write_wav
from ddsp_torch.infer.inference import PARAMS_FILENAME, AutoencoderInference
from ddsp_torch.ops.resample import resample
from ddsp_torch.utils import registry
from ddsp_torch.utils.device import DeviceLike

_NOT_PORTED_FORMATS = ('stablehlo', 'savedmodel', 'tflite')


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
    fmt: 'params' (npz + spec json).
    inference_model: 'autoencoder' (the only model fmt='params' exports).
    length_seconds: Generation length the exported spec is built for.
    **kwargs: Overrides for AutoencoderInference (e.g. remove_reverb, or
      device='cpu'; CUDA otherwise).

  Returns:
    Path of params.npz.
  """
  if fmt in _NOT_PORTED_FORMATS:
    raise NotImplementedError(
        f"fmt={fmt!r}: the port's compiled artifacts (torch.export in place "
        "of the JAX package's jax.export / jax2tf) are ROADMAP.md queue 1 "
        "item 4; export fmt='params'.")
  if fmt == 'tfjs':
    raise NotImplementedError(
        "'tfjs' export requires the tensorflowjs package, which is not "
        "part of this environment. Export fmt='savedmodel' and convert "
        'with tensorflowjs_converter where it is installed.')
  if fmt != 'params':
    raise ValueError(f'Unknown export format {fmt!r}')
  if inference_model != 'autoencoder':
    raise ValueError(
        f"fmt={fmt!r} supports inference_model='autoencoder' only.")

  os.makedirs(export_dir, exist_ok=True)
  model = AutoencoderInference(save_dir, length_seconds=length_seconds,
                               **kwargs)
  _write_operative_spec(save_dir, export_dir, model)
  path = os.path.join(export_dir, PARAMS_FILENAME)
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
  model = AutoencoderInference(save_dir, length_seconds=1,
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
