"""Kernel K3 of ddsp_torch (the neighbour halo shift) against ddsp_tpu.

The port's shift, through `HaloShift` on CPU shards (its plain version),
against the JAX package's `neighbor_shift(impl='pallas')`, which runs the
Pallas kernel in interpret mode on a pure 'time' mesh of the 8 simulated CPU
devices (as tests/test_pallas_halo.py runs it) and its ppermute fallback on
a ('data', 'time') mesh. A shift is a copy, so values and gradients are held
exactly. Also: the mesh's rules, the layouts K3 is handed, and the errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from ddsp_tpu.parallel import create_mesh as j_create_mesh
from ddsp_tpu.parallel import pallas_halo
from ddsp_torch.kernels import halo as kh
from ddsp_torch.parallel import create_mesh, halo
from ddsp_torch.parallel import mesh as mesh_lib
from ddsp_torch.train import Trainer
from ddsp_torch.utils import build_model

torch.set_num_threads(1)


def _jax_shift(jmesh, spec, direction, x):
  return jax.jit(jax.shard_map(
      functools.partial(pallas_halo.neighbor_shift, direction=direction,
                        impl='pallas'), mesh=jmesh, in_specs=spec,
      out_specs=spec, check_vma=False))(x)


def _port_shift(mesh, direction, x):
  shards = mesh_lib.split_time(mesh, x)
  out = halo.neighbor_shift(shards, mesh, direction, impl='pallas')
  return mesh_lib.concat_time(mesh, out, x.shape[0])


def _time_meshes(n_time):
  jmesh = JaxMesh(np.asarray(jax.devices()[:n_time]), ('time',))
  return jmesh, create_mesh(1, n_time, devices=['cpu'] * n_time)


@pytest.mark.parametrize('n_time', [2, 4, 8])
@pytest.mark.parametrize('direction', [+1, -1])
def test_shift_values_match_jax_pallas(n_time, direction):
  x = np.random.RandomState(0).randn(2, 16 * n_time).astype(np.float32)
  jmesh, mesh = _time_meshes(n_time)
  want = np.asarray(_jax_shift(jmesh, P(None, 'time'), direction, x))
  got = _port_shift(mesh, direction, torch.from_numpy(x)).numpy()
  np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('n_time', [2, 4, 8])
@pytest.mark.parametrize('direction', [+1, -1])
def test_shift_gradients_match_jax_pallas(n_time, direction):
  rng = np.random.RandomState(1)
  x = rng.randn(1, 8 * n_time).astype(np.float32)
  w = rng.randn(1, 8 * n_time).astype(np.float32)
  jmesh, mesh = _time_meshes(n_time)
  want = jax.grad(lambda a: jnp.sum(
      _jax_shift(jmesh, P(None, 'time'), direction, a) * w))(x)
  xt = torch.from_numpy(x).requires_grad_()
  (got,) = torch.autograd.grad(
      torch.sum(_port_shift(mesh, direction, xt) * torch.from_numpy(w)), xt)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boundary_shards_receive_zeros_and_cpu_launches_nothing():
  mesh = create_mesh(1, 4, devices=['cpu'] * 4)
  kh.reset_launches()
  x = torch.ones((1, 32))
  right = _port_shift(mesh, +1, x)
  left = _port_shift(mesh, -1, x)
  assert torch.equal(right[:, :8], torch.zeros(1, 8))
  assert torch.equal(right[:, 8:], torch.ones(1, 24))
  assert torch.equal(left[:, -8:], torch.zeros(1, 8))
  assert torch.equal(left[:, :-8], torch.ones(1, 24))
  # The plain version is no launch.
  assert kh.launches == {'shift': 0, 'remote_shift': 0}


@pytest.mark.parametrize('direction', [+1, -1])
def test_shift_stays_in_its_data_row(direction):
  """(2 data x 2 time): distinct rows catch a halo that leaks between data
  rows; the JAX side is its pallas impl's fallback on a two-axis mesh."""
  x = np.random.RandomState(2).randn(4, 32).astype(np.float32)
  jmesh = j_create_mesh(n_data=2, n_time=2, devices=jax.devices()[:4])
  want = np.asarray(_jax_shift(jmesh, P('data', 'time'), direction, x))
  mesh = create_mesh(2, 2, devices=['cpu'] * 4)
  got = _port_shift(mesh, direction, torch.from_numpy(x)).numpy()
  np.testing.assert_array_equal(got, want)


def test_main_path_blocks_reach_the_kernel_in_place():
  """The [rows, cols, row stride] K3 is handed for the main path's blocks:
  the reverb carry, the STFT halo (a strided view, read in place) and a
  boundary frame (a slot of [batch, n_slots, bins])."""
  carry = torch.zeros(16, 64000)
  audio = torch.zeros(16, 16000)
  mags = torch.zeros(16, 32, 1025)
  assert kh._rows_view(carry) == (16, 64000, 64000)
  assert kh._rows_view(audio[:, :2047]) == (16, 2047, 16000)
  assert kh._rows_view(mags[:, 31:32]) == (16, 1025, 32 * 1025)
  assert kh._rows_view(carry.t()) is None  # copied before the launch
  mesh = create_mesh(1, 4, devices=['cpu'] * 4)
  views = [torch.randn(2, 3000)[:, :2047] for _ in range(4)]
  out = halo.shift_left(views, mesh)
  for i in range(3):
    assert out[i].is_contiguous() and torch.equal(out[i], views[i + 1])
  assert torch.equal(out[3], torch.zeros(2, 2047))


def test_unknown_halo_impl_raises():
  mesh = create_mesh(1, 2, devices=['cpu'] * 2)
  with pytest.raises(ValueError, match='halo_impl'):
    halo.neighbor_shift([torch.zeros(1, 4)] * 2, mesh, +1, impl='nccl')
  with pytest.raises(ValueError, match='halo_impl'):
    Trainer(build_model('tiny', device='cpu'), mesh=mesh, halo_impl='nccl')


def test_cpu_and_cuda_shards_in_one_shift_raise(monkeypatch):
  mesh = create_mesh(1, 4, devices=['cpu'] * 4)
  shards = [torch.zeros(2, 8) for _ in range(4)]
  odd = shards[2]
  monkeypatch.setattr(kh, '_device_type',
                      lambda x: 'cuda' if x is odd else x.device.type)
  with pytest.raises(ValueError, match='all on the CPU or all on CUDA'):
    halo.shift_right(shards, mesh)


def test_mesh_rules(monkeypatch):
  with pytest.raises(NotImplementedError, match='ROADMAP.md queue 1 item 8'):
    create_mesh(1, 2, devices=['cuda:0', 'cuda:1'])
  with pytest.raises(ValueError, match='CPU shards or CUDA shards'):
    create_mesh(1, 2, devices=['cpu', 'cuda:0'])
  with pytest.raises(ValueError, match='needs 8 devices'):
    create_mesh(2, 4, devices=['cpu'] * 4)
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='CUDA'):
    create_mesh(1, 4)
  mesh = create_mesh(2, 2, devices=['cpu'] * 4)
  assert mesh.shape == {'data': 2, 'time': 2} and mesh.coords(3) == (1, 1)
  # A batch that does not divide over 'data' is replicated on every row.
  x = torch.arange(3 * 8.0).reshape(3, 8)
  shards = mesh_lib.split_time(mesh, x)
  assert torch.equal(shards[2], x[:, :4]) and torch.equal(shards[3], x[:, 4:])
  assert torch.equal(mesh_lib.concat_time(mesh, shards, 3), x)
  y = torch.arange(4 * 8.0).reshape(4, 8)
  shards = mesh_lib.split_time(mesh, y)
  assert torch.equal(shards[3], y[2:, 4:])
  assert torch.equal(mesh_lib.concat_time(mesh, shards, 4), y)
