"""The serving slice of ddsp_torch against ddsp_tpu, end to end, on the CPU.

The JAX model runs `model.apply(vars, features, training=False)` with no
rngs, so its FilteredNoise draws uniform(PRNGKey(0), (B, n_samples)); the
port is handed that exact noise and the same parameters (load_jax_params).
float32: controls atol 1e-5, audio atol 4e-3. bf16: controls atol 5e-2,
audio relative L2 <= 5e-2 (the JAX side runs its float32 scan GRU off the
TPU, the port follows the Pallas kernel's bf16 numerics).
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.configs import presets as j_presets
from ddsp_torch.infer import AutoencoderInference
from ddsp_torch.ops.core import flatten
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

# Serving forces the chunked angular cumsum (AutoencoderInference), which
# also keeps the float32 phase of both frameworks within the audio tolerance.
CASES = {
    'tiny': ('tiny', dict(use_angular_cumsum=True)),
    'solo_narrow': ('solo_instrument', dict(
        n_samples=16000, time_steps=250, rnn_channels=64, ch=64,
        layers_per_stack=1, use_angular_cumsum=True)),
}


def _features(n_frames, batch=2, seed=0):
  rng = np.random.RandomState(seed)
  t = np.linspace(0, 1, n_frames, dtype=np.float32)[None, :, None]
  f0 = 220.0 * 2.0**(rng.rand(batch, 1, 1) + 0.5 * np.sin(6 * t))
  ld = -60.0 + 40.0 * rng.rand(batch, n_frames, 1)
  return {'f0_hz': f0.astype(np.float32), 'loudness_db': ld.astype(np.float32)}


_JAX_MODELS = {}


def _jax_model_and_params(preset, kwargs, n_frames, seed=0):
  """The JAX model and its parameters, initialised once per arguments and
  copied for each caller. The init is jitted: its parameters equal the
  eager init's bit for bit once the IR below replaces the drawn one (the
  only leaf whose rounding the two differ in)."""
  key = (preset, tuple(sorted(kwargs.items())), n_frames, seed)
  if key not in _JAX_MODELS:
    _JAX_MODELS[key] = _init_jax_model(preset, kwargs, n_frames, seed)
  model, params = _JAX_MODELS[key]
  return model, jax.tree_util.tree_map(np.copy, params)


def _init_jax_model(preset, kwargs, n_frames, seed):
  model = getattr(j_presets, preset)(compute_loudness_fresh=False, **kwargs)
  feats = {k: jnp.asarray(v) for k, v in _features(n_frames).items()}
  variables = jax.jit(lambda f: model.init(
      {'params': jax.random.PRNGKey(seed),
       'noise': jax.random.PRNGKey(seed + 1)}, f, training=False))(feats)
  params = jax.tree_util.tree_map(np.array, variables['params'])
  reverb = params.get('processor_group', {}).get('reverb')
  if reverb is not None:
    # A decaying noise IR, so the reverb is not trivially silent.
    n_ir = reverb['ir'].shape[0]
    rng = np.random.RandomState(seed + 2)
    reverb['ir'] = (0.05 * rng.randn(n_ir) *
                    np.exp(-np.arange(n_ir) / (0.1 * n_ir))).astype(np.float32)
  return model, params


def _jax_apply(model, params, features):
  return model.apply({'params': params},
                     {k: jnp.asarray(v) for k, v in features.items()},
                     training=False)


def _jax_noise(batch, n_samples):
  return np.array(jax.random.uniform(jax.random.PRNGKey(0),
                                     (batch, n_samples), minval=-1.0,
                                     maxval=1.0))


def _compare(out_j, out_t, bf16):
  flat_j = {k: np.asarray(v) for k, v in flatten(out_j).items()}
  flat_t = {k: v.detach().float().numpy() for k, v in flatten(out_t).items()}
  assert sorted(flat_j) == sorted(flat_t)
  for key, a in flat_j.items():
    b = flat_t[key]
    assert b.shape == a.shape, key
    is_audio = 'signal' in key or 'audio' in key
    if is_audio and bf16:
      rel = np.linalg.norm(b - a) / max(np.linalg.norm(a), 1e-12)
      assert rel <= 5e-2, (key, rel)
    else:
      atol = 4e-3 if is_audio else (5e-2 if bf16 else 1e-5)
      np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=key)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_autoencoder_matches_jax(case, dtype):
  preset, kwargs = CASES[case]
  kwargs = dict(kwargs, compute_dtype=dtype)
  n_frames = kwargs.get('time_steps', 250)
  model_j, params = _jax_model_and_params(preset, kwargs, n_frames)
  features = _features(n_frames, seed=1)
  out_j = _jax_apply(model_j, params, features)

  model_t = build_model(preset, device='cpu', compute_loudness_fresh=False,
                        **kwargs)
  load_jax_params(model_t, params)
  n_samples = out_j['audio_synth'].shape[1]
  with torch.no_grad():
    out_t = model_t({k: torch.from_numpy(v) for k, v in features.items()},
                    noise=torch.from_numpy(_jax_noise(2, n_samples)))
  assert np.abs(np.asarray(out_j['reverb']['signal'] -
                           out_j['add']['signal'])).max() > 1e-3
  _compare(out_j, out_t, bf16=dtype == 'bfloat16')


def _write_artifact(path, params):
  """A fmt='params' export: operative_spec.json + flat params.npz."""
  spec = {'preset': 'tiny', 'kwargs': {'compute_dtype': 'float32'}}
  (path / 'operative_spec.json').write_text(json.dumps(spec))
  np.savez(path / 'params.npz',
           **{k: np.asarray(v) for k, v in flatten(params).items()})


@pytest.mark.parametrize('remove_reverb', [False, True])
def test_autoencoder_inference_serves_params_export(tmp_path, remove_reverb):
  _, params = _jax_model_and_params('tiny', dict(compute_dtype='float32'),
                                    250)
  _write_artifact(tmp_path, params)
  port = AutoencoderInference(str(tmp_path), length_seconds=0.5,
                              remove_reverb=remove_reverb, device='cpu')
  assert (port.n_frames, port.n_samples) == (125, 8000)

  model_j = j_presets.tiny(n_samples=8000, time_steps=125,
                           use_angular_cumsum=True,
                           compute_loudness_fresh=False,
                           compute_dtype='float32',
                           reverb=not remove_reverb)
  params_j = dict(params)
  if remove_reverb:
    params_j.pop('processor_group')
  features = {k: v[0, :, 0] for k, v in _features(125, batch=1).items()}
  out_j = _jax_apply(model_j, params_j,
                     {k: v[None, :, None] for k, v in features.items()})
  out_t = port(features, noise=torch.from_numpy(_jax_noise(1, 8000)))
  assert ('reverb' in out_t) == (not remove_reverb)
  np.testing.assert_allclose(out_t['audio_synth'].numpy(),
                             np.asarray(out_j['audio_synth']), atol=4e-3)
  # Without explicit noise FilteredNoise's fixed-seed generator draws it,
  # the same on every call.
  audio = port.get_audio(features)
  assert audio.shape == (1, 8000) and torch.isfinite(audio).all()
  torch.testing.assert_close(audio, port.get_audio(features), rtol=0, atol=0)


def test_load_jax_params_is_strict():
  _, params = _jax_model_and_params('tiny', dict(compute_dtype='float32'),
                                    250)
  flat = flatten(params)
  model = build_model('tiny', device='cpu', compute_loudness_fresh=False)
  load_jax_params(model, flat)  # flat 'a/b/c' keys load like the nested tree
  missing = dict(flat)
  missing.pop('decoder/dense_out/bias')
  with pytest.raises(ValueError, match='missing'):
    load_jax_params(model, missing)
  with pytest.raises(ValueError, match='extra'):
    load_jax_params(model, dict(flat, **{'decoder/extra/kernel': 0.0}))
  bad = dict(flat)
  bad['decoder/rnn/FastGRU_0/bn'] = np.zeros(3, np.float32)
  with pytest.raises(ValueError, match='shape'):
    load_jax_params(model, bad)


def test_port_imports_no_jax():
  code = ('import sys, ddsp_torch, ddsp_torch.infer, ddsp_torch.configs, '
          'ddsp_torch.kernels, ddsp_torch.losses, ddsp_torch.train, '
          'ddsp_torch.data, ddsp_torch.native, ddsp_torch.eval, '
          'ddsp_torch.eval.eval_util, ddsp_torch.eval.postprocessing, '
          'ddsp_torch.data.prepare, ddsp_torch.ops.crepe, ddsp_torch.ops.hmm, '
          'ddsp_torch.utils.audio_io; '
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'flax', 'ddsp_tpu', 'optax', 'orbax', 'h5py')]; "
          'print(bad)')
  out = subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                       capture_output=True, text=True)
  assert out.stdout.strip() == '[]'


def test_port_sources_import_no_jax():
  files = sorted((REPO / 'ddsp_torch').rglob('*.py')) + [REPO /
                                                         'chip_smoke.py']
  forbidden = {'jax', 'flax', 'ddsp_tpu', 'optax', 'orbax'}
  for path in files:
    for node in ast.walk(ast.parse(path.read_text())):
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom):
        names = [node.module or '']
      else:
        continue
      for name in names:
        assert name.split('.')[0] not in forbidden, (path, name)


def test_entry_points_refuse_the_cpu_by_default(tmp_path, monkeypatch):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    build_model('tiny')
  _, params = _jax_model_and_params('tiny', dict(compute_dtype='float32'),
                                    250)
  _write_artifact(tmp_path, params)
  with pytest.raises(RuntimeError, match='CUDA'):
    AutoencoderInference(str(tmp_path))
  assert os.path.exists(tmp_path / 'params.npz')
