"""The port's six VST programs (export_model(fmt='torch_export',
inference_model=...)) against the JAX package's VST classes, on the CPU.

One JAX vst checkpoint (Trainer.init + save, biases moved off zero) at the
narrow sizes of tests/test_torch_vst.py serves the JAX classes (the float32
decoder through a float32 twin of the JAX preset, registered while they are
built), and the same parameters, as a params-format artifact, the port's
exports. Each program is loaded back with `load_program` and held against
the JAX class's call: the controls and the GRU state hop by hop with the
state carried through the program, the synthesis hops with the phase
carried and the JAX class's noise buffer baked in, and CREPE's features
from a program exported before any eager CREPE call in the process (its
decoding constants were once cached as fake tensors by such a trace).

Tolerances are tests/test_torch_vst.py's, for the same reasons.
"""

import collections
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from ddsp_tpu import infer as j_infer
from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.train import Trainer as JTrainer
from ddsp_tpu.utils import registry as j_registry
from ddsp_torch import infer as t_infer
from ddsp_torch.infer import export as t_export
from ddsp_torch.ops import crepe as t_crepe
from ddsp_torch.ops.core import flatten

torch.set_num_threads(1)

SR = 16000
FRAME_RATE = 50
HOP = SR // FRAME_RATE
N_HARMONICS, N_NOISE, STATE = 8, 5, 16
VST_KW = dict(seconds=0.2, frame_rate=FRAME_RATE, n_harmonics=N_HARMONICS,
              n_noise_magnitudes=N_NOISE, rnn_channels=STATE, ch=16,
              reverb=False)
N_HOPS = 6
JAX_F32_PRESET = 'vst_float32_decoder_export'
CONTROLS_ATOL = {'float32': 1e-5, 'bfloat16': 5e-2}
SYNTH_ATOL = 1e-4
POWER_ATOL_DB = 1e-4
F0_CENTS = 1.0
F0_SCALED_ATOL = 1e-6


def _jax_vst_float32(**kwargs):
  model = j_presets.vst(**kwargs)
  return model.clone(decoder=model.decoder.clone(compute_dtype='float32'))


def _perturbed(params, seed=0):
  rng = np.random.RandomState(seed)
  flat = flatten(jax.tree_util.tree_map(np.array, params))
  for key, value in flat.items():
    if key.rsplit('/', 1)[-1] in ('bias', 'bi', 'bn'):
      flat[key] = (value + 0.1 * rng.randn(*value.shape)).astype(np.float32)
  tree = {}
  for key, value in flat.items():
    node = tree
    *parents, leaf = key.split('/')
    for p in parents:
      node = node.setdefault(p, {})
    node[leaf] = value
  return tree


@pytest.fixture(scope='module')
def vst(tmp_path_factory):
  """The JAX classes and the port's artifact directory per decoder dtype."""
  root = tmp_path_factory.mktemp('vst_export')
  n_samples = int(VST_KW['seconds'] * SR)
  rng = np.random.RandomState(0)
  batch = {'audio': (0.1 * rng.randn(2, n_samples)).astype(np.float32),
           'f0_hz': np.full((2, n_samples // HOP + 1), 220.0, np.float32),
           'f0_confidence': np.ones((2, n_samples // HOP + 1), np.float32)}
  trainer = JTrainer(j_presets.vst(**VST_KW))
  state = jax.jit(trainer.init)(batch)
  params = _perturbed(state.params)
  jax_dir = root / 'jax'
  j_registry.save_spec(str(jax_dir), 'vst', **VST_KW)
  trainer.save(state.replace(params=params), str(jax_dir))
  jax_f32_dir = root / 'jax_f32'
  shutil.copytree(jax_dir, jax_f32_dir)
  j_registry.save_spec(str(jax_f32_dir), JAX_F32_PRESET, **VST_KW)
  out = {'jax_dir': str(jax_dir), 'root': root}
  j_registry.register_preset(JAX_F32_PRESET)(_jax_vst_float32)
  try:
    for dtype, jdir in (('bfloat16', jax_dir), ('float32', jax_f32_dir)):
      port_dir = root / f'port_{dtype}'
      port_dir.mkdir()
      (port_dir / 'operative_spec.json').write_text(json.dumps(
          {'preset': 'vst', 'kwargs': dict(VST_KW, compute_dtype=dtype)}))
      np.savez(port_dir / 'params.npz', **flatten(params))
      out[dtype] = {'port_dir': str(port_dir),
                    'jax': j_infer.VSTStatelessPredictControls(str(jdir))}
  finally:
    j_registry._PRESETS.pop(JAX_F32_PRESET)
  return out


def _export(port_dir, export_dir, name, **kwargs):
  path = t_export.export_model(port_dir, str(export_dir), fmt='torch_export',
                               inference_model=name, device='cpu', **kwargs)
  assert path.endswith(f'{name}.pt2')
  return t_export.load_program(path, device='cpu')


def _np(x):
  return x.detach().float().numpy()


def _frame(kind):
  rng = np.random.RandomState(5)
  return {'noise': 0.1 * rng.randn(1024),
          'sine': 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(1024) / SR)
         }[kind].astype(np.float32)


def test_extract_features_program_exported_first(vst, tmp_path):
  """Exported twice before any eager CREPE call in the process, then run:
  the features of the JAX class, and the eager class's bit for bit."""
  port_dir = vst['float32']['port_dir']
  t_crepe._DECODING_CONSTANTS.clear()
  programs = [_export(port_dir, tmp_path / str(i), 'vst_extract_features')
              for i in range(2)]
  assert not t_crepe._DECODING_CONSTANTS  # nothing kept from the traces
  assert programs[0].meta['full_float32']
  eager = t_infer.VSTExtractFeatures(port_dir, device='cpu')
  for kind in ('sine', 'noise'):
    audio = _frame(kind)
    want = j_infer.VSTExtractFeatures(vst['jax_dir'])(audio)
    for program in programs:
      got = program(torch.from_numpy(audio))
      cents = 1200 * np.log2(_np(got[0]).astype(np.float64) /
                             np.asarray(want[0], np.float64))
      assert np.abs(cents).max() <= F0_CENTS, kind
      for g, w, atol in zip(got[1:], want[1:],
                            (F0_SCALED_ATOL, POWER_ATOL_DB, F0_SCALED_ATOL)):
        assert tuple(g.shape) == (1,) == w.shape
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=atol, rtol=0)
      for g, e in zip(got, eager(torch.from_numpy(audio))):
        torch.testing.assert_close(g, e, rtol=0, atol=0)
  assert list(t_crepe._DECODING_CONSTANTS) == [('cents', torch.device('cpu'))]


def test_extract_features_program_pins_float32(vst, tmp_path, monkeypatch):
  """The loaded program runs CREPE with TF32 off, whatever the process set,
  and restores the process's settings after."""
  program = _export(vst['float32']['port_dir'], tmp_path,
                    'vst_extract_features')
  backends = (torch.backends.cudnn, torch.backends.cuda.matmul)
  seen = []
  run = program.module
  monkeypatch.setattr(program, 'module', lambda *a: (
      seen.append([b.allow_tf32 for b in backends]), run(*a))[1])
  for b in backends:
    monkeypatch.setattr(b, 'allow_tf32', True)
  program(torch.from_numpy(_frame('sine')))
  assert seen == [[False, False]]
  assert [b.allow_tf32 for b in backends] == [True, True]


@pytest.mark.parametrize('name', ['vst_stateless_predict_controls',
                                  'vst_predict_controls'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_predict_controls_program_matches_jax(vst, tmp_path, name, dtype):
  """Both names export the stateless signature; the state is carried
  through the program hop by hop, one K2f node in its graph."""
  program = _export(vst[dtype]['port_dir'], tmp_path, name)
  assert program.meta['inputs'] == ['f0_scaled', 'pw_scaled', 'state']
  ops = collections.Counter(str(n.target)
                            for n in program.program.graph.nodes)
  assert ops['ddsp_torch.gru_fwd.default'] == 1
  j_predict = vst[dtype]['jax']
  j_state = j_predict.initial_state()
  t_state = torch.zeros(STATE)
  for i in range(N_HOPS):
    f0 = np.array([0.45 + 0.02 * i], np.float32)
    pw = np.array([0.5 + 0.05 * np.sin(i)], np.float32)
    want = j_predict(f0, pw, j_state)
    got = program(torch.from_numpy(f0), torch.from_numpy(pw), t_state)
    for part, g, w in zip(('amps', 'hd', 'noise', 'state'), got, want):
      assert tuple(g.shape) == w.shape, part
      np.testing.assert_allclose(_np(g), np.asarray(w),
                                 atol=CONTROLS_ATOL[dtype], rtol=0,
                                 err_msg=f'hop {i} {part}')
    j_state, t_state = want[3], got[3]
  # A VST program's spec is the vst spec as trained.
  with open(tmp_path / 'operative_spec.json') as f:
    assert json.load(f) == {'preset': 'vst',
                            'kwargs': dict(VST_KW, compute_dtype=dtype)}


def _controls(i, rng):
  amps = np.array([0.1 + 0.05 * i], np.float32)
  hd = rng.rand(N_HARMONICS).astype(np.float32)
  f0 = np.array([220.0 + 10 * i], np.float32)
  noise = (0.01 * rng.rand(N_NOISE)).astype(np.float32)
  return amps, hd / hd.sum(), f0, noise


@pytest.mark.parametrize('variant', ['vst_synthesize',
                                     'vst_synthesize_harmonic',
                                     'vst_synthesize_noise'])
def test_synthesize_program_matches_jax(vst, tmp_path, variant):
  """The JAX class's noise buffer baked in, the phase carried through the
  program."""
  j_class = {'vst_synthesize': j_infer.VSTSynthesize,
             'vst_synthesize_harmonic': j_infer.VSTSynthesizeHarmonic,
             'vst_synthesize_noise': j_infer.VSTSynthesizeNoise}[variant]
  j_synth = j_class(vst['jax_dir'])
  noise = np.array(jax.random.uniform(jax.random.PRNGKey(0), (1, HOP),
                                      minval=-1.0, maxval=1.0))
  program = _export(vst['float32']['port_dir'], tmp_path, variant,
                    noise=torch.from_numpy(noise))
  rng = np.random.RandomState(4)
  prev = _controls(0, rng)
  j_phase, t_phase = j_synth.initial_phase(), torch.zeros(1)
  for i in range(4):
    cur = _controls(i, rng)
    if variant == 'vst_synthesize_noise':
      want, got = j_synth(cur[3]), program(torch.from_numpy(cur[3]))
    else:
      args = [cur[0], prev[0], cur[1], prev[1], cur[2], prev[2]]
      if variant == 'vst_synthesize':
        args.append(cur[3])
      want, j_phase = j_synth(*args, j_phase)
      got, t_phase = program(*(torch.from_numpy(a) for a in args), t_phase)
      np.testing.assert_allclose(_np(t_phase), np.asarray(j_phase),
                                 atol=SYNTH_ATOL, rtol=0)
    assert tuple(got.shape) == (HOP,) and np.abs(_np(got)).max() > 0
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=SYNTH_ATOL,
                               rtol=0, err_msg=f'hop {i}')
    prev = cur
