"""The port's kernels as torch.library ops, and its autoencoder program
(export_model(fmt='torch_export')), against the JAX package on the CPU.

Ops: torch.library.opcheck of each op (schema, fake implementation,
autograd registration, AOT dispatch) with its CPU implementation; the fake
implementations' shapes and dtypes on meta tensors; HarmonicSynthesis and
GruSequence gradients bit-equal to the plain versions they ran before the
ops existed.

Program: one JAX train directory of the tiny preset (Trainer.init + save,
biases moved off zero) per decoder dtype; the JAX package exports it as
StableHLO (fmt='stablehlo', run through jax.export.deserialize(...).call)
and the port exports the same parameters as a .pt2. The StableHLO program
draws its noise with make_rng('noise') under PRNGKey(0); the test reads
that draw from FilteredNoise.get_signal under flax.linen.intercept_methods
and bakes it into the port's program. The port's program is deterministic
(the same audio on a second call and after save/load, equal to
AutoencoderInference's) and holds one node per kernel, not an unrolled
loop.
"""

import collections
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jax_export

from ddsp_tpu import infer as j_infer
from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.ops.fftconv import frequency_filter as j_frequency_filter
from ddsp_tpu.proc import synths as j_synths
from ddsp_tpu.train import Trainer as JTrainer
from ddsp_tpu.utils import registry as j_registry
from ddsp_torch.infer import AutoencoderInference
from ddsp_torch.infer import export as t_export
from ddsp_torch.kernels import gru as kg
from ddsp_torch.kernels import harmonic as kh
from ddsp_torch.ops.core import flatten

torch.set_num_threads(1)

SR = 16000
N_SAMPLES, N_FRAMES = 3200, 50
LENGTH_SECONDS = N_SAMPLES / SR
# rnn_channels 128: a bf16 decoder streams bf16 through K2's bf16 route
# (FastGRU needs H % 128 == 0 and T >= 8 for it).
KW = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, reverb_length=800,
          rnn_channels=128, ch=32)
DTYPES = ('float32', 'bfloat16')
# float32 audio: the serving slice's tier (tests/test_torch_model.py): the
# same float32 operations, the angular cumsum's float32 phase summed in
# another order (~1e-4 rad over the clip, times the harmonic number).
AUDIO_ATOL_F32 = 4e-3
# bf16 decoders: the port runs K2's bf16 numerics, the StableHLO program the
# JAX package's float32 scan (off the TPU): relative L2 of the audio, the
# serving slice's bf16 tier.
AUDIO_REL_L2_BF16 = 5e-2
# The captured noise's own check: the interceptor's jitted apply against the
# StableHLO program, the same computation compiled twice.
CAPTURE_ATOL = 1e-6
# A graph that unrolled the GRU's loop holds T sigmoid nodes per gate; the
# program has a few hundred nodes in all.
MAX_NODES = 600


def _perturbed(params, seed=0):
  """Every bias leaf moved off zero, so each term of the sums is seen."""
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


def _features(seed=0):
  """One request, [1, n_frames, 1] each."""
  rng = np.random.RandomState(seed)
  t = np.linspace(0, 1, N_FRAMES, dtype=np.float32)
  f0 = 220.0 * 2.0**(0.5 * np.sin(6 * t))
  ld = -50.0 + 30.0 * rng.rand(N_FRAMES)
  return {'f0_hz': f0.astype(np.float32)[None, :, None],
          'loudness_db': ld.astype(np.float32)[None, :, None]}


@pytest.fixture(scope='module', params=DTYPES)
def ae(request, tmp_path_factory):
  """A JAX train directory of tiny and the port's params-format artifact of
  the same parameters, at one decoder dtype."""
  dtype = request.param
  root = tmp_path_factory.mktemp(f'ae_{dtype}')
  kwargs = dict(KW, compute_dtype=dtype)
  rng = np.random.RandomState(1)
  batch = {'audio': (0.1 * rng.randn(2, N_SAMPLES)).astype(np.float32),
           'f0_hz': np.full((2, N_FRAMES), 220.0, np.float32),
           'loudness_db': np.full((2, N_FRAMES), -30.0, np.float32)}
  trainer = JTrainer(j_presets.tiny(**kwargs))
  state = jax.jit(trainer.init)(batch)
  params = _perturbed(state.params)
  jax_dir = root / 'jax'
  j_registry.save_spec(str(jax_dir), 'tiny', **kwargs)
  trainer.save(state.replace(params=params), str(jax_dir))
  port_dir = root / 'port'
  port_dir.mkdir()
  (port_dir / 'operative_spec.json').write_text(json.dumps(
      {'preset': 'tiny', 'kwargs': kwargs}))
  np.savez(port_dir / 'params.npz', **flatten(params))
  return {'dtype': dtype, 'jax_dir': str(jax_dir), 'port_dir': str(port_dir),
          'root': root}


@pytest.fixture(scope='module')
def default_program(ae, tmp_path_factory):
  """ae's program as export_model writes it by default (the reverb
  removed, as AutoencoderInference's default), exported once for the tests
  that only read it."""
  return t_export.export_model(
      ae['port_dir'], str(tmp_path_factory.mktemp(f'program_{ae["dtype"]}')),
      fmt='torch_export', length_seconds=LENGTH_SECONDS, device='cpu')


def _stablehlo_and_noise(ae, features):
  """(audio of the JAX StableHLO artifact, the noise it drew)."""
  path = j_infer.export_model(ae['jax_dir'], str(ae['root'] / 'hlo'),
                              fmt='stablehlo',
                              length_seconds=LENGTH_SECONDS)
  with open(path, 'rb') as f:
    exported = jax_export.deserialize(bytearray(f.read()))
  want = np.asarray(exported.call(
      {k: jnp.asarray(v) for k, v in features.items()}))

  # The artifact's forward is AutoencoderInference's jitted apply with
  # rngs={'noise': PRNGKey(0)}; run it again with get_signal replaced by its
  # own body, which also returns the draw.
  model = j_infer.AutoencoderInference(ae['jax_dir'],
                                       length_seconds=LENGTH_SECONDS)
  drawn = []

  def record_noise(next_fun, args, kwargs, context):
    module = context.module
    if not (isinstance(module, j_synths.FilteredNoise) and
            context.method_name == 'get_signal'):
      return next_fun(*args, **kwargs)
    magnitudes = args[0] if args else kwargs['magnitudes']
    signal = jax.random.uniform(module.make_rng('noise'),
                                (magnitudes.shape[0], module.n_samples),
                                minval=-1.0, maxval=1.0)
    drawn.append(signal)
    return j_frequency_filter(signal, magnitudes,
                              window_size=module.window_size)

  def call(params, features):  # AutoencoderInference's own _call
    with nn.intercept_methods(record_noise):
      out = model.model.apply({'params': params}, features, training=False,
                              rngs={'noise': jax.random.PRNGKey(0)})
    return out['audio_synth'], drawn.pop()

  audio, noise = jax.jit(call)(model.params, features)
  np.testing.assert_allclose(np.asarray(audio), want, atol=CAPTURE_ATOL,
                             rtol=0)
  return want, np.array(noise)


def _ops(program):
  return collections.Counter(str(n.target) for n in program.graph.nodes
                             if n.op == 'call_function')


def test_autoencoder_program_matches_stablehlo(ae, tmp_path):
  features = _features()
  want, noise = _stablehlo_and_noise(ae, features)
  path = t_export.export_model(ae['port_dir'], str(tmp_path),
                               fmt='torch_export',
                               length_seconds=LENGTH_SECONDS, device='cpu',
                               noise=torch.from_numpy(noise))
  assert path.endswith('autoencoder.pt2')
  program = t_export.load_program(path, device='cpu')
  assert program.meta == {'inference_model': 'autoencoder',
                          'inputs': ['f0_hz', 'loudness_db'],
                          'full_float32': False}
  got = program(*(torch.from_numpy(v) for v in features.values()))
  assert tuple(got.shape) == want.shape == (1, N_SAMPLES)
  got = got.numpy()
  if ae['dtype'] == 'float32':
    np.testing.assert_allclose(got, want, atol=AUDIO_ATOL_F32, rtol=0)
  else:
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= AUDIO_REL_L2_BF16, rel
  # The spec beside the program carries the inference mutations.
  with open(tmp_path / 'operative_spec.json') as f:
    spec = json.load(f)
  assert spec['kwargs'] == dict(
      KW, compute_dtype=ae['dtype'], n_samples=N_SAMPLES,
      time_steps=N_FRAMES, use_angular_cumsum=True,
      compute_loudness_fresh=False, reverb=False)


@pytest.mark.parametrize('remove_reverb', [True, False])
def test_autoencoder_program_is_deterministic(ae, default_program, tmp_path,
                                             remove_reverb):
  """The noise is baked in: the same audio on a second call, after save and
  load, and as AutoencoderInference renders it. With the reverb removed
  the program is the default export."""
  path = default_program if remove_reverb else t_export.export_model(
      ae['port_dir'], str(tmp_path), fmt='torch_export',
      length_seconds=LENGTH_SECONDS, device='cpu', remove_reverb=False)
  program = t_export.load_program(path, device='cpu')
  features = {k: torch.from_numpy(v) for k, v in _features(3).items()}
  first = program(*features.values())
  torch.testing.assert_close(program(*features.values()), first, rtol=0,
                             atol=0)
  again = t_export.load_program(path, device='cpu')
  torch.testing.assert_close(again(*features.values()), first, rtol=0,
                             atol=0)
  eager = AutoencoderInference(ae['port_dir'], length_seconds=LENGTH_SECONDS,
                               remove_reverb=remove_reverb, device='cpu')
  torch.testing.assert_close(eager.get_audio(features), first, rtol=0,
                             atol=0)


def test_autoencoder_program_holds_the_ops(default_program):
  program = t_export.load_program(default_program, device='cpu').program
  ops = _ops(program)
  assert ops['ddsp_torch.harmonic_fwd.default'] == 1
  assert ops['ddsp_torch.gru_fwd.default'] == 1
  assert not [k for k in ops if 'ddsp_torch' in k and 'fwd' not in k]
  assert ops['aten.sigmoid.default'] < N_FRAMES
  assert len(program.graph.nodes) <= MAX_NODES


def test_export_runs_on_the_card_by_default(ae, tmp_path):
  with pytest.raises(RuntimeError, match='CUDA'):
    t_export.export_model(ae['port_dir'], str(tmp_path), fmt='torch_export')
  path = t_export.export_model(ae['port_dir'], str(tmp_path),
                               fmt='torch_export',
                               length_seconds=LENGTH_SECONDS, device='cpu')
  with pytest.raises(RuntimeError, match='CUDA'):
    t_export.load_program(path)


# The ops on their own.
def _k1_inputs(batch=2, n_frames=8, hop=16, n_harmonics=5, seed=0):
  gen = torch.Generator().manual_seed(seed)
  n = n_frames * hop
  phase0 = torch.cumsum(0.05 + 0.1 * torch.rand(batch, n, generator=gen), 1)
  f0_env = 300.0 + 3000.0 * torch.rand(batch, n, generator=gen)
  ham = torch.rand(batch, n_frames, n_harmonics, generator=gen)
  g = torch.randn(batch, n, generator=gen)
  return phase0, f0_env, ham, g


def _k2_inputs(dtype, seq_len=6, batch=3, hidden=8, seed=0):
  gen = torch.Generator().manual_seed(seed)
  xp = torch.randn(seq_len, batch, 3 * hidden, generator=gen).to(dtype)
  wh = (0.3 * torch.randn(hidden, 3 * hidden, generator=gen)).to(dtype)
  bn = torch.randn(hidden, generator=gen)
  h0 = torch.randn(batch, hidden, generator=gen)
  g = torch.randn(seq_len, batch, hidden, generator=gen)
  return xp, wh, bn, h0, g


def _op_cases():
  phase0, f0_env, ham, g = _k1_inputs()
  cases = {}
  for method in kh.KERNEL_METHODS:
    cases[f'harmonic_fwd-{method}'] = (kh.harmonic_fwd, (
        phase0, f0_env, ham, 16000.0, method))
    cases[f'harmonic_bwd_taps-{method}'] = (kh.harmonic_bwd_taps, (
        phase0, f0_env, g, ham.shape[1], ham.shape[2], 16000.0, method))
    cases[f'harmonic_bwd_phase-{method}'] = (kh.harmonic_bwd_phase, (
        phase0, f0_env, ham, g, 16000.0, method))
  for dtype in (torch.float32, torch.bfloat16):
    xp, wh, bn, h0, g = _k2_inputs(dtype)
    ys = kg.gru_sequence_plain(xp, wh, bn, h0)
    h_prev = kg.h_prev_stream(h0, ys, dtype)
    name = str(dtype).split('.')[1]
    cases[f'gru_fwd-{name}'] = (kg.gru_fwd, (xp, wh, bn, h0))
    cases[f'gru_bwd-{name}'] = (kg.gru_bwd, (g, xp, h_prev, wh, bn))
  return cases


OP_CASES = _op_cases()


@pytest.mark.parametrize('case', sorted(OP_CASES))
def test_opcheck(case):
  op, args = OP_CASES[case]
  result = torch.library.opcheck(op, args)
  assert set(result.values()) == {'SUCCESS'}, result


def test_fake_shapes_on_meta_tensors():
  """The fake implementations: K1f [B, n_samples], K1t [B, F, H], K1p
  [B, n_samples], K2f [T, B, H] at the unpadded H, K2b as its inputs, all
  float32 but dxp (xp's dtype)."""
  meta = dict(device='meta')
  phase0 = torch.empty(3, 6400, **meta)
  ham = torch.empty(3, 100, 60, **meta)
  assert kh.harmonic_fwd(phase0, phase0, ham, 16000.0, 'window').shape == (
      3, 6400)
  dham = kh.harmonic_bwd_taps(phase0, phase0, phase0, 100, 60, 16000.0,
                              'window')
  assert dham.shape == (3, 100, 60) and dham.dtype == torch.float32
  assert kh.harmonic_bwd_phase(phase0, phase0, ham, phase0, 16000.0,
                               'linear').shape == (3, 6400)
  xp = torch.empty(7, 5, 288, dtype=torch.bfloat16, **meta)
  wh = torch.empty(96, 288, dtype=torch.bfloat16, **meta)
  bn, h0 = torch.empty(96, **meta), torch.empty(5, 96, **meta)
  ys = kg.gru_fwd(xp, wh, bn, h0)
  assert ys.shape == (7, 5, 96) and ys.dtype == torch.float32
  g = torch.empty(7, 5, 96, **meta)
  dxp, dwh, dbn, dh0 = kg.gru_bwd(g, xp, g.bfloat16(), wh, bn)
  assert (dxp.shape, dxp.dtype) == (xp.shape, torch.bfloat16)
  assert [t.shape for t in (dwh, dbn, dh0)] == [(96, 288), (96,), (5, 96)]
  assert {t.dtype for t in (dwh, dbn, dh0)} == {torch.float32}


@pytest.mark.parametrize('method', kh.KERNEL_METHODS)
def test_harmonic_gradients_bit_equal_to_the_plain_versions(method):
  phase0, f0_env, ham, g = _k1_inputs(seed=4)
  phase0.requires_grad_(True)
  ham.requires_grad_(True)
  audio = kh.fused_harmonic_synthesis(phase0, f0_env, ham, 16000, method)
  dphase, dham = torch.autograd.grad(audio, (phase0, ham), g)
  with torch.no_grad():
    args = (phase0.detach(), f0_env)
    assert torch.equal(audio, kh.harmonic_synthesis_plain(
        *args, ham.detach(), 16000, method))
    assert torch.equal(dham, kh.fold_taps(kh.harmonic_bwd_taps_plain(
        *args, g, ham.shape[1], ham.shape[2], 16000, method)))
    assert torch.equal(dphase, kh.harmonic_bwd_phase_plain(
        *args, ham.detach(), g, 16000, method))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_gru_gradients_bit_equal_to_the_plain_versions(dtype):
  xp, wh, bn, h0, g = _k2_inputs(dtype, seed=5)
  wh = wh.float()
  leaves = [t.requires_grad_(True) for t in (xp, wh, bn, h0)]
  ys = kg.gru_sequence(*leaves)
  grads = torch.autograd.grad(ys, leaves, g)
  with torch.no_grad():
    wh_s = wh.detach().to(dtype)
    want_ys = kg.gru_sequence_plain(xp.detach(), wh_s, bn.detach(),
                                    h0.detach())
    assert torch.equal(ys, want_ys)
    want = kg.gru_bwd_plain(g, xp.detach(), kg.h_prev_stream(
        h0.detach(), want_ys, dtype), wh_s, bn.detach())
  for name, got, w in zip(('dxp', 'dwh', 'dbn', 'dh0'), grads, want):
    assert torch.equal(got, w), name
