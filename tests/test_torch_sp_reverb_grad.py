"""The reverb IR's gradient on the sequence-parallel (SP) path against the
dense path, in the port and in the JAX package, on the CPU.

The `tiny` model of tests/test_torch_sp.py at 16384 samples, parameters
from the JAX package's init (load_jax_params), an audible reverb IR drawn
with numpy, a (1 data x 4 time) mesh, halo_impl='pallas':

  (a) one fixed dry signal through the reverb and SpectralLoss with all six
      terms (logmag included), in both frameworks, relative L2 A_RTOL: the
      SP reverb (time_sharded_fft_convolve) pulls a fixed cotangent back to
      the IR as the dense Reverb does, time_sharded_spectral_loss gives
      SpectralLoss's gradient for one and the same audio, and the chain of
      both gives the dense chain's IR gradient. The sharded reverb and loss
      are exact up to float32 summation order.
  (b) the whole step, mag term only: the SP step's IR gradient within
      B_RTOL of the dense step's, in both frameworks. The SP harmonic
      synthesizer sums its phase per shard in float32, which moves the
      audio by ~3e-3 relative; the mag term passes that on in proportion.
  (c) the whole step with the logmag term: the same departure is printed
      for both frameworks side by side (pytest -s); only finiteness is
      asserted. The logmag term's gradient is 1/|X| in near-silent STFT
      bins, which amplifies the phase rounding of (b) into the IR
      gradient; the JAX package shows the same conditioning.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu import losses as j_losses
from ddsp_tpu import proc as j_proc
from ddsp_tpu.configs import presets as j_presets
from ddsp_tpu.parallel import create_mesh as j_create_mesh
from ddsp_tpu.parallel import sp_model as j_sp_model
from ddsp_tpu.parallel import time_shard as j_time_shard
from ddsp_torch import losses as t_losses
from ddsp_torch.parallel import create_mesh, sp_forward_with_losses
from ddsp_torch.parallel import sp_model as t_sp_model
from ddsp_torch.parallel import time_shard as t_time_shard
from ddsp_torch.utils import build_model, load_jax_params

torch.set_num_threads(1)

N_SAMPLES, N_FRAMES, IR_SIZE = 16384, 128, 3000
TINY = dict(n_samples=N_SAMPLES, time_steps=N_FRAMES, n_harmonics=8,
            n_noise_magnitudes=9, reverb_length=IR_SIZE,
            compute_dtype='float32')
SIX_TERMS = dict(mag_weight=1.0, delta_time_weight=1.0,
                 delta_freq_weight=1.0, cumsum_freq_weight=1.0,
                 logmag_weight=1.0, loudness_weight=1.0)
# (a): 'reverb' and 'loss' are two float32 computations of one function
# that sum in another order (per shard, then over shards): measured 2.8e-7
# and 2.4e-8 (port), 3.4e-7 and 2.5e-8 (JAX) on an x86 CPU (torch 2.13).
# 'chain' adds the logmag term's amplification of the wet signal's
# rounding (see `_dry`): measured 7.1e-5 (port) and 4.6e-5 (JAX), held
# with a margin of 7.
A_RTOL = {'reverb': 1e-5, 'loss': 1e-5, 'chain': 5e-4}
# The losses' keys in the losses dict: the mag-only loss, then the
# logmag-only one (both frameworks name repeated losses this way).
LOSS_KEYS = ('spectral_loss', 'spectral_loss_')
# (b): the bound the SP path is held to for the mag-only step (the audio's
# phase rounding passes into it in proportion); measured 6.9e-5 (port) and
# 7.1e-5 (JAX) on an x86 CPU (torch 2.13).
B_RTOL = 1e-2


def _batch():
  rng = np.random.RandomState(0)
  return {
      'audio': (0.1 * rng.randn(2, N_SAMPLES)).astype(np.float32),
      'f0_hz': np.full((2, N_FRAMES, 1), 220.0, np.float32),
  }


def _dry():
  """A tone of 8 harmonics of 220 Hz under a decaying envelope, over a
  noise floor 60 dB below its start (1e-3). Over a floor of 1e-4 the
  64- and 128-point STFTs have bins near 1e-6, where the logmag term's
  1/|X| makes the dense loss's own IR gradient move by 1.0e-2 when its
  input moves by the sharded reverb's rounding (1e-7 relative); the chain
  would then measure that conditioning, not the sharded path."""
  rng = np.random.RandomState(41)
  t = np.arange(N_SAMPLES) / 16000.0
  tone = sum(rng.rand() / h * np.sin(2 * np.pi * 220.0 * h * t + rng.rand())
             for h in range(1, 9))
  tone = tone * np.exp(-3.0 * t)[None] * (0.5 + rng.rand(2, 1))
  return (tone + 1e-3 * rng.randn(2, N_SAMPLES)).astype(np.float32)


def _audible_ir():
  rng = np.random.RandomState(6)
  return (0.02 * rng.randn(IR_SIZE) * np.exp(-np.arange(IR_SIZE) / 500.0)
          ).astype(np.float32)


def _jax_noise():
  """What the JAX processors draw when applied without rngs."""
  return np.array(jax.random.uniform(jax.random.PRNGKey(0), (2, N_SAMPLES),
                                     minval=-1.0, maxval=1.0))


@pytest.fixture(scope='module')
def setup():
  """The JAX tiny model with two losses (mag only, logmag only) and its
  initial parameters (numpy) with the audible IR."""
  split_losses = (
      j_losses.SpectralLoss(compute_dtype='float32', mag_weight=1.0,
                            logmag_weight=0.0),
      j_losses.SpectralLoss(compute_dtype='float32', mag_weight=0.0,
                            logmag_weight=1.0))
  model = j_presets.tiny(**TINY).clone(losses=split_losses)
  variables = jax.jit(lambda b: model.init(
      {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)}, b,
      training=True, return_losses=True))(_batch())
  params = jax.tree_util.tree_map(np.array, variables['params'])
  params['processor_group']['reverb']['ir'] = _audible_ir()
  return model, params


def _rel_l2(a, b):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _port_model(params):
  model = build_model('tiny', device='cpu', **TINY)
  model.losses = torch.nn.ModuleList([
      t_losses.SpectralLoss(compute_dtype='float32', mag_weight=1.0,
                            logmag_weight=0.0),
      t_losses.SpectralLoss(compute_dtype='float32', mag_weight=0.0,
                            logmag_weight=1.0)])
  load_jax_params(model, params)
  return model


@pytest.fixture(scope='module')
def reverb_and_loss(setup):
  """SP against dense, relative L2, {case: {framework: err}}: 'reverb', the
  IR gradient of <wet, cotangent> for a fixed cotangent; 'loss', the
  six-term loss's gradient with respect to one and the same wet signal;
  'chain', the IR gradient through the reverb and the six-term loss."""
  _, params = setup
  ir = params['processor_group']['reverb']['ir']
  target, dry = _batch()['audio'], _dry()
  cot = np.random.RandomState(42).randn(*dry.shape).astype(np.float32)
  errs = {'reverb': {}, 'loss': {}, 'chain': {}}

  mesh = create_mesh(1, 4, devices=['cpu'] * 4)
  reverb = _port_model(params).processor_group.reverb
  six = t_losses.SpectralLoss(compute_dtype='float32', **SIX_TERMS)
  wet, grads = {}, {}
  for sp in (False, True):
    controls = reverb.get_controls(torch.from_numpy(dry))
    if sp:
      wet[sp] = t_sp_model._sp_get_signal(reverb, controls, mesh, 'pallas')  # pylint: disable=protected-access
      loss = t_time_shard.time_sharded_spectral_loss(
          mesh, torch.from_numpy(target), wet[sp], halo_impl='pallas',
          **SIX_TERMS)
    else:
      wet[sp] = reverb.get_signal(**controls)
      loss = six(torch.from_numpy(target), wet[sp])
    grads['reverb', sp] = torch.autograd.grad(
        wet[sp], [reverb.ir], torch.from_numpy(cot), retain_graph=True)[0]
    grads['chain', sp] = torch.autograd.grad(loss, [reverb.ir])[0]
  same = wet[False].detach().requires_grad_()
  grads['loss', False] = torch.autograd.grad(
      six(torch.from_numpy(target), same), [same])[0]
  grads['loss', True] = torch.autograd.grad(
      t_time_shard.time_sharded_spectral_loss(
          mesh, torch.from_numpy(target), same, halo_impl='pallas',
          **SIX_TERMS), [same])[0]
  for case in errs:
    errs[case]['port'] = _rel_l2(grads[case, True].numpy(),
                                 grads[case, False].numpy())

  jmesh = j_create_mesh(n_data=1, n_time=4, devices=jax.devices()[:4])
  j_reverb = j_proc.Reverb(trainable=True, reverb_length=IR_SIZE)
  j_six = j_losses.SpectralLoss(compute_dtype='float32', **SIX_TERMS)

  def wet_and_pullback(ir_, cot_, sp):
    """The wet signal and the IR gradient of <wet, cot_>."""
    def wet_of(x):
      bound = j_reverb.bind({'params': {'ir': x}})
      controls = bound.get_controls(jnp.asarray(dry))
      if sp:
        return j_sp_model._sp_get_signal(bound, controls, jmesh, 'pallas')  # pylint: disable=protected-access
      return bound.get_signal(**controls)
    wet_, vjp = jax.vjp(wet_of, ir_)
    return wet_, vjp(cot_)[0]

  def loss_grad(audio, sp):
    def loss_of(x):
      if sp:
        return j_time_shard.time_sharded_spectral_loss(
            jmesh, jnp.asarray(target), x, halo_impl='pallas', **SIX_TERMS)
      return j_six(jnp.asarray(target), x)
    return jax.grad(loss_of)(audio)

  # Each function is compiled once per path and called on both wets.
  wet_and_pullback = jax.jit(wet_and_pullback, static_argnums=2)
  loss_grad = jax.jit(loss_grad, static_argnums=1)
  j_grads, j_wet = {}, {}
  for sp in (False, True):
    j_wet[sp], j_grads['reverb', sp] = wet_and_pullback(
        jnp.asarray(ir), jnp.asarray(cot), sp)
  for sp in (False, True):
    j_grads['loss', sp] = loss_grad(j_wet[False], sp)
    j_grads['chain', sp] = wet_and_pullback(
        jnp.asarray(ir), loss_grad(j_wet[sp], sp), sp)[1]
  for case in errs:
    errs[case]['jax'] = _rel_l2(j_grads[case, True], j_grads[case, False])
  return errs


@pytest.mark.parametrize('case', ['reverb', 'loss', 'chain'])
def test_sp_reverb_and_six_term_loss_match_the_dense_path(reverb_and_loss,
                                                          case):
  """(a): the sharded reverb (for a fixed cotangent) and the sharded
  six-term loss (for one and the same audio) are each the dense one up to
  float32 summation order; chained on one dry signal, the IR gradient too,
  within CHAIN_RTOL."""
  errs = reverb_and_loss[case]
  print(f'(a) {case}: SP vs dense gradient, relative L2: port '
        f'{errs["port"]:.3e}, JAX {errs["jax"]:.3e}')
  for name, err in errs.items():
    assert err <= A_RTOL[case], name


def _step_ir_grads(model, batch, mesh, noise):
  """{path: [d(mag)/d(ir), d(logmag)/d(ir)]} of the dense and SP steps."""
  out = {}
  for path in ('dense', 'sp'):
    if path == 'dense':
      _, losses = model(batch, training=True, return_losses=True,
                        noise=noise)
    else:
      _, losses = sp_forward_with_losses(model, batch, mesh,
                                         halo_impl='pallas', noise=noise)
    ir = model.processor_group.reverb.ir
    out[path] = [torch.autograd.grad(losses[k], [ir], retain_graph=True)[0]
                 .numpy() for k in LOSS_KEYS]
  return out


@pytest.fixture(scope='module')
def step_grads(setup):
  """The IR gradients of each loss term on the dense and the SP step, port
  and JAX: {framework: {path: [mag, logmag]}}."""
  j_model, params = setup
  batch = _batch()
  model = _port_model(params)
  port = _step_ir_grads(
      model, {k: torch.from_numpy(v) for k, v in batch.items()},
      create_mesh(1, 4, devices=['cpu'] * 4), torch.from_numpy(_jax_noise()))

  jmesh = j_create_mesh(n_data=1, n_time=4, devices=jax.devices()[:4])

  def losses_of(p, sp):
    if sp:
      _, losses = j_model.apply({'params': p}, batch, mesh=jmesh,
                                halo_impl='pallas',
                                method=j_sp_model.sp_forward_with_losses)
    else:
      _, losses = j_model.apply({'params': p}, batch, training=True,
                                return_losses=True)
    return jnp.stack([losses[k] for k in LOSS_KEYS])

  def ir_jacobians(p):
    return [jax.jacrev(losses_of)(p, sp)['processor_group']['reverb']['ir']
            for sp in (False, True)]

  dense, sp = jax.jit(ir_jacobians)(jax.tree_util.tree_map(jnp.asarray,
                                                           params))
  return {'port': port,
          'jax': {'dense': list(np.asarray(dense)),
                  'sp': list(np.asarray(sp))}}


def test_sp_step_ir_gradient_mag_term(step_grads):
  """(b): with the mag term only, the SP step's IR gradient is the dense
  step's up to the phase rounding of the sharded synthesizer."""
  errs = {name: _rel_l2(g['sp'][0], g['dense'][0])
          for name, g in step_grads.items()}
  print(f'(b) mag term: SP vs dense step IR gradient, relative L2: port '
        f'{errs["port"]:.3e}, JAX {errs["jax"]:.3e}')
  for name, err in errs.items():
    assert err <= B_RTOL, name


def test_sp_step_ir_gradient_with_logmag_is_phase_conditioned(step_grads):
  """(c): with the logmag term on, the departure is printed for both
  frameworks; it is the reference's own conditioning, not asserted."""
  lines = []
  for name, g in step_grads.items():
    full = {path: g[path][0] + g[path][1] for path in ('dense', 'sp')}
    assert all(np.isfinite(v).all() for v in full.values()), name
    lines.append(
        f'{name}: IR gradient norm dense {np.linalg.norm(full["dense"]):.4f}'
        f' SP {np.linalg.norm(full["sp"]):.4f}, relative L2 '
        f'{_rel_l2(full["sp"], full["dense"]):.3e} (logmag term alone '
        f'{_rel_l2(g["sp"][1], g["dense"][1]):.3e})')
  print('(c) mag + logmag, SP vs dense step: ' + '; '.join(lines))
