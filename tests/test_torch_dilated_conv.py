"""ddsp_torch.nn.dilated_conv against ddsp_tpu.nn.dilated_conv, on the CPU.

DilatedConvStack at ch 8 with the JAX parameters (and batch_stats) loaded
by load_jax_params: plain (layer, instance and no norm), conditional (FiLM,
and shift only), a negative dilation base, spectral_norm (eval, and
training with the power iteration's u and sigma written back), and the
resampling layers (strided conv down, flax's unflipped ConvTranspose up,
strides 2 and 4, on odd lengths, before or after the convolutions);
values, and gradients of a weighted sum with respect to the input, z and
every parameter. Then polyphase_resample both ways with pad and trim, and
the kernels' initializers against flax's (glorot_uniform, orthogonal).

Tolerances: float32 convolutions (XLA against oneDNN; the stack pins its
convs to full float32, no TF32 on the CPU either): outputs rtol 1e-5 with
atol 1e-5 (outputs are O(1); the residual sums of 2-3 layers round
apart by a few ulps), gradients relative L2 1e-5 (each parameter's
against the larger of its norm and 1e-2 of the whole gradient's: a conv
bias ahead of a norm has a gradient of 0 plus rounding); reshapes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddsp_tpu.nn import dilated_conv as j_dc
from ddsp_torch.nn import dilated_conv as t_dc
from ddsp_torch.nn.resnet import init_kernel_
from ddsp_torch.ops.core import flatten
from ddsp_torch.utils import load_jax_params

torch.set_num_threads(1)

CH, IN_CH, Z_CH, BATCH = 8, 3, 5, 2
RTOL = ATOL = 1e-5
GRAD_RTOL = 1e-5

CASES = {
    'layer': dict(norm_type='layer'),
    'instance': dict(norm_type='instance', kernel_size=5),
    'no_norm': dict(norm_type=None),
    'negative_dilation': dict(norm_type='layer', dilation=-2),
    'conditional': dict(norm_type='layer', conditional=True),
    'conditional_shift_only': dict(norm_type='instance', conditional=True,
                                   shift_only=True),
    'spectral_norm': dict(norm_type='layer', spectral_norm=True),
    'ortho_init': dict(norm_type='layer', ortho_init=True),
    'down2': dict(norm_type='layer', resample_type='downsample',
                  resample_stride=2),
    'down4_before': dict(norm_type='layer', resample_type='downsample',
                         resample_stride=4, resample_after_convolve=False),
    'up2': dict(norm_type='layer', resample_type='upsample',
                resample_stride=2),
    'up4_before': dict(norm_type='layer', resample_type='upsample',
                       resample_stride=4, resample_after_convolve=False),
    'up2_spectral_norm': dict(norm_type='layer', resample_type='upsample',
                              resample_stride=2, spectral_norm=True),
}


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
  return torch.from_numpy(np.array(x))


def _rel_l2(got, want):
  got, want = _np(got), _np(want)
  return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _stacks(kw, time, stacks=1):
  """(JAX stack, its variables, port stack with them, x, z)."""
  rng = np.random.RandomState(sum(map(ord, str(sorted(kw.items())))) % 1000)
  x = rng.randn(BATCH, time, IN_CH).astype(np.float32)
  conditional = kw.get('conditional', False)
  z = rng.randn(BATCH, time, Z_CH).astype(np.float32) if conditional else None
  j_mod = j_dc.DilatedConvStack(ch=CH, layers_per_stack=3, stacks=stacks,
                                **kw)
  args = (jnp.asarray(x),) + ((jnp.asarray(z),) if conditional else ())
  variables = j_mod.init({'params': jax.random.PRNGKey(0)}, *args)
  # Non-trivial normalization scales and shifts (their init is 1 and 0).
  params = {k: v + 0.1 * rng.randn(*v.shape).astype(np.float32)
            for k, v in flatten(variables['params']).items()}
  variables = dict(variables, params=params)
  t_mod = t_dc.DilatedConvStack(IN_CH, ch=CH, layers_per_stack=3,
                                stacks=stacks, z_ch=Z_CH if conditional else
                                None, **kw)
  load_jax_params(t_mod, params, **{k: v for k, v in variables.items()
                                    if k != 'params'})
  return j_mod, variables, t_mod, x, z


def _unflatten(flat):
  out = {}
  for k, v in flat.items():
    node = out
    parts = k.split('/')
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = v
  return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_stack_matches_jax(case):
  kw = CASES[case]
  j_mod, variables, t_mod, x, z = _stacks(kw, time=37)
  jvars = dict(variables, params=_unflatten(variables['params']))
  conditional = z is not None
  y_j = j_mod.apply(jvars, jnp.asarray(x),
                    *((jnp.asarray(z),) if conditional else ()))
  x_t = _t(x).requires_grad_()
  z_t = _t(z).requires_grad_() if conditional else None
  y_t = t_mod(x_t, z_t)
  assert y_t.shape == y_j.shape
  np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=RTOL, atol=ATOL)

  w = np.random.RandomState(7).randn(*y_j.shape).astype(np.float32)

  def objective(params, xv, zv):
    out = j_mod.apply(dict(jvars, params=params), xv,
                      *((zv,) if conditional else ()))
    return jnp.sum(out * w)

  grads_j = jax.grad(objective, argnums=(0, 1, 2))(
      jvars['params'], jnp.asarray(x),
      jnp.asarray(z) if conditional else None)
  named = list(t_mod.named_parameters())
  inputs = [x_t] + ([z_t] if conditional else [])
  grads_t = torch.autograd.grad((y_t * _t(w)).sum(),
                                inputs + [p for _, p in named])
  assert _rel_l2(grads_t[0], grads_j[1]) <= GRAD_RTOL
  if conditional:
    assert _rel_l2(grads_t[1], grads_j[2]) <= GRAD_RTOL
  flat_j = flatten(grads_j[0])
  # A conv bias ahead of an instance or layer norm has an analytic gradient
  # of 0 (rounding noise in both packages): each leaf is held relative to
  # the larger of its norm and 1e-2 of all the parameters' gradient norm.
  floor = 1e-2 * np.sqrt(sum(np.sum(_np(g)**2) for g in flat_j.values()))
  for (name, _), g in zip(named, grads_t[len(inputs):]):
    want = _np(flat_j[name.replace('.', '/')])
    err = np.linalg.norm(_np(g) - want)
    assert err <= GRAD_RTOL * max(np.linalg.norm(want), floor), name


@pytest.mark.parametrize('case', ['spectral_norm', 'up2_spectral_norm'])
def test_spectral_norm_training_updates_stats(case):
  """In training both packages write the power iteration's u and sigma
  back (flax's mutable batch_stats); in eval neither does."""
  j_mod, variables, t_mod, x, _ = _stacks(CASES[case], time=21, stacks=1)
  jvars = dict(variables, params=_unflatten(variables['params']))
  y_j, updates = j_mod.apply(jvars, jnp.asarray(x), training=True,
                             mutable=['batch_stats'])
  before = {k: v.clone() for k, v in t_mod.state_dict().items()}
  y_eval = t_mod(_t(x), training=False)
  for k, v in t_mod.state_dict().items():
    assert torch.equal(v, before[k]), k
  y_t = t_mod(_t(x), training=True)
  np.testing.assert_allclose(_np(y_t), _np(y_j), rtol=RTOL, atol=ATOL)
  np.testing.assert_allclose(_np(y_eval), _np(y_j), rtol=RTOL, atol=ATOL)
  want = flatten(updates['batch_stats'])
  got = {k.replace('.', '/'): v for k, v in t_mod.named_buffers()}
  assert len(want) == len(got) > 0
  for key, value in want.items():
    module, _, leaf = key.partition('/')
    buf = getattr(t_mod, module).jax_collection_items()[leaf]
    np.testing.assert_allclose(_np(buf), _np(value), rtol=RTOL, atol=1e-6)
    assert not np.allclose(_np(buf), _np(flatten(
        variables['batch_stats'])[key])) or leaf.endswith('sigma')


@pytest.mark.parametrize('init', ['glorot_uniform', 'orthogonal'])
def test_kernel_init_family(init):
  """The port's draw of a (k, 1, in, out) kernel has flax's distribution:
  the same bound or variance, orthonormal columns for 'orthogonal' (the
  parity tests load the JAX parameters, so they cannot see the init)."""
  shape = (3, 1, 128, 128)
  j_init = getattr(jax.nn.initializers, init)()
  k_j = np.asarray(j_init(jax.random.PRNGKey(0), shape, jnp.float32))
  k_t = torch.empty(shape)
  init_kernel_(k_t, init, torch.Generator().manual_seed(0))
  k_t = k_t.numpy()
  # 49152 draws: the standard deviations agree within 2 %.
  assert abs(k_t.std() / k_j.std() - 1) < 0.02
  if init == 'orthogonal':
    for k in (k_t, k_j):
      m = k.reshape(-1, shape[-1])
      np.testing.assert_allclose(m.T @ m, np.eye(shape[-1]), atol=1e-4)
  else:
    limit = np.sqrt(6.0 / (3 * 128 + 3 * 128))
    for k in (k_t, k_j):
      assert limit * 0.99 <= np.abs(k).max() <= limit


def test_stack_names_follow_flax():
  """The port's parameter and buffer tree is the JAX one, name for name;
  load_jax_params is strict over batch_stats as over the parameters: a
  missing collection, a missing key or an extra key raises."""
  _, variables, t_mod, _, _ = _stacks(CASES['up2_spectral_norm'], time=9,
                                      stacks=2)
  assert {n.replace('.', '/') for n, _ in t_mod.named_parameters()} == set(
      variables['params'])
  with pytest.raises(ValueError, match='batch_stats.*missing'):
    load_jax_params(t_mod, variables['params'])
  stats = flatten(variables['batch_stats'])
  extra = dict(stats, **{'SpectralNorm_0/Conv_9/kernel/u': np.ones((1, CH))})
  with pytest.raises(ValueError, match='batch_stats.*extra'):
    load_jax_params(t_mod, variables['params'], batch_stats=extra)
  del stats['SpectralNorm_1/Conv_1/kernel/sigma']
  with pytest.raises(ValueError, match='batch_stats.*missing.*sigma'):
    load_jax_params(t_mod, variables['params'], batch_stats=stats)
