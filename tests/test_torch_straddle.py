"""A mesh over ranks whose runs straddle data rows, without a process group.

Rank r of an (n_data x n_time) mesh over R ranks holds the run of shards
[r * per_rank, (r + 1) * per_rank) of the row-major order: the tail of one
row, whole rows, the head of a later row. Here every rank of a layout is
built in one process (distributed.Ranks with no process group) and checked
against the one-process mesh of the same shape: the run's rows, span and
neighbours, the process-local placement (shard_batch, split_time,
concat_time, assemble), K3's edge and its plain shift on a run that starts
inside a row. The layouts whose runs do not straddle keep today's
rectangles, checked slice for slice. The spawned ranks of
tests/test_torch_distributed.py hold the straddled steps against the JAX
package.
"""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from ddsp_torch.kernels import halo as kh
from ddsp_torch.parallel import distributed
from ddsp_torch.parallel import mesh as mesh_lib
from ddsp_torch.parallel.mesh import Mesh

# (n_data, n_time, ranks): every rank but the first and last straddles in
# the last three; (5 x 3) over 3 has a tail, a whole row and a head.
STRADDLED = ((3, 2, 2), (2, 3, 3), (3, 4, 4), (5, 3, 3))
# Today's layouts: a run within one row, or whole rows.
TODAY = ((1, 4, 4), (2, 2, 4), (4, 2, 2), (1, 4, 2))
ROWS_PER_DATA_ROW, T_LOCAL = 2, 3


def _mesh(layout, rank):
  n_data, n_time, n_ranks = layout
  ranks = distributed.Ranks(rank, n_ranks, n_data, n_time)
  return Mesh(['cpu'] * ranks.per_rank, n_data, n_time, ranks)


def _global(layout, seed=0):
  n_data, n_time, _ = layout
  return torch.from_numpy(np.random.RandomState(seed).randn(
      n_data * ROWS_PER_DATA_ROW, n_time * T_LOCAL).astype(np.float32))


def _block(x, d, t):
  """Shard (d, t)'s block of a global [batch, samples] tensor."""
  return x[d * ROWS_PER_DATA_ROW:(d + 1) * ROWS_PER_DATA_ROW,
           t * T_LOCAL:(t + 1) * T_LOCAL]


@pytest.mark.parametrize('layout', STRADDLED)
def test_runs_rows_spans_and_neighbours(layout):
  """Each rank's run, rows, span and neighbours from the shards it holds;
  the runs tile the mesh in rank order."""
  n_data, n_time, n_ranks = layout
  per_rank = n_data * n_time // n_ranks
  seen = []
  for r in range(n_ranks):
    mesh = _mesh(layout, r)
    run, ranks = mesh.run, mesh.ranks
    shards = [run.coords(j) for j in range(run.count)]
    seen += shards
    assert mesh.first_shard == run.first == r * per_rank
    assert list(run.rows) == sorted({d for d, _ in shards})
    times = {t for _, t in shards}
    assert run.span == ((min(times), max(times) + 1) if len(run.rows) == 1
                        else (0, n_time))
    assert ranks.shares_rows and not run.whole_rows
    (d0, t0), (d1, t1) = shards[0], shards[-1]
    assert ranks.neighbours == (r - 1 if t0 > 0 else None,
                                r + 1 if t1 < n_time - 1 else None)
    for j, (d, t) in enumerate(shards):
      assert run.index(d, t) == j
  assert seen == [divmod(i, n_time) for i in range(n_data * n_time)]
  assert any(len(_mesh(layout, r).run.rows) > 1 for r in range(n_ranks))


@pytest.mark.parametrize('layout', STRADDLED)
def test_placement_is_the_one_process_meshs(layout):
  """shard_batch, split_time and concat_time of each rank against the
  shards of the one-process mesh, and assemble of every rank's shards
  back to the global tensor: inverses of each other."""
  n_data, n_time, n_ranks = layout
  x = _global(layout)
  batch, n = x.shape
  every = []
  for r in range(n_ranks):
    mesh = _mesh(layout, r)
    run = mesh.run
    part = mesh_lib.shard_batch(mesh, {'audio': x.numpy(),
                                       'f0': x[:, :2].numpy()}, n_samples=n)
    rows = mesh_lib.local_rows(mesh, batch)
    span = mesh_lib.time_span(mesh, n)
    np.testing.assert_array_equal(part['audio'], x[rows, span].numpy())
    np.testing.assert_array_equal(part['f0'], x[rows, :2].numpy())
    assert mesh_lib.global_rows(mesh, rows.stop - rows.start) == (batch,
                                                                   rows)
    local = torch.from_numpy(part['audio'])
    shards = mesh_lib.split_time(mesh, local)
    for j, shard in enumerate(shards):
      assert torch.equal(shard, _block(x, *run.coords(j)))
    frames = torch.from_numpy(part['f0'])
    for j, shard in enumerate(mesh_lib.split_batch(mesh, frames)):
      d = run.coords(j)[0]
      assert torch.equal(shard, x[d * ROWS_PER_DATA_ROW:
                                  (d + 1) * ROWS_PER_DATA_ROW, :2])
    joined = mesh_lib.concat_time(mesh, shards, batch)
    want = torch.zeros_like(local)
    lo = run.span[0]
    for j in range(run.count):
      d, t = run.coords(j)
      i = d - run.rows[0]
      want[i * ROWS_PER_DATA_ROW:(i + 1) * ROWS_PER_DATA_ROW,
           (t - lo) * T_LOCAL:(t - lo + 1) * T_LOCAL] = _block(x, d, t)
    assert torch.equal(joined, want)
    assert torch.equal(mesh_lib.split_time(mesh, joined)[0], shards[0])
    every += shards
  assert torch.equal(distributed.assemble(every, n_data, n_time), x)
  first = [every[d * n_time][:, :1] for d in range(n_data)]
  assert torch.equal(distributed.assemble(
      [every[i][:, :1] for i in range(len(every))], n_data, n_time,
      time_local=False), torch.cat(first))


def _one_process_shift(layout, shards, direction):
  n_data, n_time, _ = layout
  return kh.halo_shift_plain(shards, Mesh(['cpu'] * (n_data * n_time),
                                          n_data, n_time).run, direction)


@pytest.mark.parametrize('layout', STRADDLED)
def test_edges_of_every_rank(layout):
  """A rank's remote part of each shift: its run's last shard goes to the
  rank holding the next time shard of its row, its first receives from the
  rank holding the previous one; none at a row's end."""
  n_data, n_time, n_ranks = layout
  per_rank = n_data * n_time // n_ranks
  holder = lambda i: i // per_rank
  for r in range(n_ranks):
    mesh = _mesh(layout, r)
    first, last = r * per_rank, (r + 1) * per_rank - 1
    across = lambda i, step: (holder(i + step) if 0 <= i % n_time + step <
                              n_time else None)
    edge = kh._edge(mesh, +1)  # pylint: disable=protected-access
    assert (edge.send, edge.to, edge.recv, edge.frm, edge.direction) == (
        per_rank - 1, across(last, +1), 0, across(first, -1), 1)
    edge = kh._edge(mesh, -1)  # pylint: disable=protected-access
    assert (edge.send, edge.to, edge.recv, edge.frm, edge.direction) == (
        0, across(first, -1), per_rank - 1, across(last, +1), -1)


@pytest.mark.parametrize('layout', STRADDLED)
def test_plain_shift_of_a_run_is_the_one_process_shift(layout):
  """K3's plain version on each rank's run (which starts inside a row)
  with its edge filled from the neighbour's shard, as the remote copy does,
  against the same shift of the one-process mesh, both directions."""
  n_data, n_time, n_ranks = layout
  x = _global(layout, seed=1)
  blocks = [_block(x, d, t) for d in range(n_data) for t in range(n_time)]
  for direction in (+1, -1):
    want = _one_process_shift(layout, blocks, direction)
    for r in range(n_ranks):
      mesh = _mesh(layout, r)
      run = mesh.run
      mine = blocks[run.first:run.first + run.count]
      got = kh.halo_shift_plain(mine, run, direction)
      edge = kh._edge(mesh, direction)  # pylint: disable=protected-access
      for j in range(run.count):
        if j == edge.recv:
          assert not got[j].any()  # the remote copy's to fill
          if edge.frm is not None:
            got[j] = blocks[run.first + j - direction]
        assert torch.equal(got[j], want[run.first + j]), (r, j, direction)


def test_a_mesh_that_does_not_divide_over_the_ranks_raises(monkeypatch):
  monkeypatch.setattr(distributed, 'world_size', lambda: 4)
  monkeypatch.setattr(distributed, 'rank', lambda: 1)
  with pytest.raises(ValueError, match='does not divide over 4 ranks'):
    distributed.mesh_ranks(3, 2)
  ranks = distributed.mesh_ranks(3, 4)
  assert (ranks.rank, ranks.per_rank, ranks.run.first) == (1, 3, 3)
  with pytest.raises(ValueError, match='over the ranks of a'):
    Mesh(['cpu'] * 3, 4, 3, ranks)


@pytest.mark.parametrize('layout', TODAY)
def test_todays_layouts_keep_their_rectangles(layout):
  """A run within one row (its own time shards) or of whole rows (every
  sample): the process-local tensor is the rank's rectangle of the global
  one, split and joined slice for slice, and a run within a row has its
  neighbours on both sides of its ends."""
  n_data, n_time, n_ranks = layout
  per_rank = n_data * n_time // n_ranks
  x = _global(layout)
  batch, n = x.shape
  for r in range(n_ranks):
    mesh = _mesh(layout, r)
    run = mesh.run
    if per_rank % n_time == 0:
      d0, n_rows, t0, n_t = r * per_rank // n_time, per_rank // n_time, 0, \
          n_time
    else:
      (d0, t0), n_rows, n_t = run.coords(0), 1, per_rank
    rows = slice(d0 * ROWS_PER_DATA_ROW, (d0 + n_rows) * ROWS_PER_DATA_ROW)
    span = slice(t0 * T_LOCAL, (t0 + n_t) * T_LOCAL)
    assert mesh_lib.local_rows(mesh, batch) == rows
    assert mesh_lib.time_span(mesh, n) == span
    assert mesh_lib.global_rows(mesh, rows.stop - rows.start) == (batch,
                                                                   rows)
    assert mesh.ranks.shares_rows == (per_rank % n_time != 0)
    local = x[rows, span]
    shards = mesh_lib.split_time(mesh, local)
    assert [run.coords(j) for j in range(per_rank)] == [
        (d0 + j // n_t, t0 + j % n_t) for j in range(per_rank)]
    for j, shard in enumerate(shards):
      d, t = run.coords(j)
      assert torch.equal(shard, _block(x, d, t))
    assert torch.equal(mesh_lib.concat_time(mesh, shards, batch), local)
    if mesh.ranks.shares_rows:
      assert mesh.ranks.neighbours == (r - 1 if t0 > 0 else None,
                                       r + 1 if t0 + n_t < n_time else None)


def test_halo_entries_bind_with_their_declared_arguments():
  """kernels/halo.py's ctypes signatures against csrc/halo.cu's C entries,
  argument by argument (the library builds only on the card, where a
  signature one argument short crashes the process): pointers, 64-bit
  integers, ints and unsigned ints in the declared order."""
  source = (pathlib.Path(kh.__file__).parents[1] / 'csrc' /
            'halo.cu').read_text()
  entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', source))
  assert sorted(entries) == sorted(kh._SIGNATURES)  # pylint: disable=protected-access
  pointers = (ctypes.c_void_p, ctypes.c_char_p,
              ctypes.POINTER(ctypes.c_void_p),
              ctypes.POINTER(ctypes.c_longlong))
  for name, params in entries.items():
    declared = [' '.join(p.split()[:-1]) for p in params.split(',')]
    bound = kh._SIGNATURES[name]  # pylint: disable=protected-access
    assert len(bound) == len(declared), name
    for c_type, arg in zip(declared, bound):
      if '*' in c_type:
        assert arg in pointers, (name, c_type, arg)
      else:
        assert arg == {'int': ctypes.c_int, 'long long': ctypes.c_longlong,
                       'unsigned': ctypes.c_uint}[c_type], (name, c_type)
