"""K3's remote copy between ranks: the wrapper's bookkeeping on the CPU.

The kernels run only on the card (chip_smoke.py phase 6m (a) holds them
against `remote_shift_plain`, times them and drills their faults). Here a
stub stands in for the built library, as the other K3 tests stub
`_device_type`: it takes the launch's arguments and hands out a fault block
in host memory, which the tests write as the kernels would. The JAX
package has no counterpart of this bookkeeping (its remote copies are
Pallas DMAs between chips), so nothing here imports it.
"""

import collections
import contextlib
import ctypes
import types

import pytest
import torch

from ddsp_torch.kernels import halo as kh
from ddsp_torch.parallel import distributed

MESH = '(1 x 4) mesh'
OWN, LEFT, RIGHT = 0x10000, 0x20000, 0x30000


class _StubLib:
  """csrc/halo.cu's C entries that the remote copy's wrapper calls."""

  def __init__(self):
    self.fault = kh.FaultBlock()
    self.remote = []

  def ddsp_halo_fault_block(self, ptr_ref):
    ptr_ref._obj.value = ctypes.addressof(self.fault)  # pylint: disable=protected-access
    return 0

  def ddsp_halo_remote(self, *args):
    self.remote.append(args)
    return 0

  def ddsp_halo_slot_close(self, ptr):
    del ptr
    return 0

  ddsp_halo_slot_free = ddsp_halo_slot_close


class _Event:

  def __init__(self, done):
    self.done = done

  def query(self):
    return self.done


@pytest.fixture
def lib(monkeypatch):
  """A fresh remote-copy state with the stub library, a CPU 'stream' and
  events that have completed (a test sets `events_done` to False)."""
  stub = _StubLib()
  stub.events_done = True
  stub.stream = types.SimpleNamespace(cuda_stream=1234)
  for name, value in (('_SLOTS', {}), ('_CALLS', {}),
                      ('_PENDING', collections.OrderedDict()), ('_TAG', 0),
                      ('_FAULT', None), ('_FAULTS_REPORTED', 0)):
    monkeypatch.setattr(kh, name, value)
  monkeypatch.setattr(kh._build, 'load', lambda name, signatures: stub)  # pylint: disable=protected-access
  monkeypatch.setattr(kh, '_device', lambda device: contextlib.nullcontext())
  monkeypatch.setattr(kh, '_current_stream', lambda device: stub.stream)
  monkeypatch.setattr(kh, '_record_event',
                      lambda stream: _Event(stub.events_done))
  return stub


def _mesh(rank):
  return types.SimpleNamespace(ranks=distributed.Ranks(rank, 4, 1, 4))


def _launch(rank=1, direction=+1, block=None):
  """A remote copy of a [2, 2047] halo block on `rank` of a (1 x 4) mesh
  over four ranks."""
  block = torch.zeros(2, 2047) if block is None else block
  nbytes = block.numel() * 4
  if (MESH, nbytes) not in kh._SLOTS:  # pylint: disable=protected-access
    kh._SLOTS[(MESH, nbytes)] = kh._Slot(OWN, {rank - 1: LEFT, rank + 1: RIGHT})  # pylint: disable=protected-access
  mesh = _mesh(rank)
  return kh._launch_remote(block, mesh, kh._edge(mesh, direction))  # pylint: disable=protected-access


def _write_fault(fault, code, tag, call, use, seen):
  """The kernels' order: the fields, then the code."""
  fault.tag, fault.call, fault.use, fault.seen = tag, call, use, seen
  fault.code = code


@pytest.mark.parametrize('code', sorted(kh.REMOTE_ERRORS))
def test_a_fault_word_raises_at_the_next_check(lib, code):
  _launch()
  _launch(direction=-1)
  _write_fault(lib.fault, code, tag=2, call=2, use=2,
               seen=(2 << 32) | (7 << 1) | 1)
  with pytest.raises(RuntimeError) as err:
    distributed.check()
  message = str(err.value)
  for part in ('call 2 of the (1 x 4) mesh', 'use 2 of its 16376-byte slot',
               'rank 1', kh.REMOTE_ERRORS[code]):
    assert part in message
  if code != 1:
    assert 'use 2, call 7, direction +1' in message
  # Reported once: the code is cleared and later faults claim the block
  # with the next count.
  assert lib.fault.code == 0
  distributed.check()
  _launch()
  assert lib.remote[-1][14] == 1  # fault_gen


def test_a_fault_raises_at_the_next_launch_without_waiting(lib):
  _launch()
  _write_fault(lib.fault, 3, tag=1, call=1, use=1, seen=0)
  lib.events_done = False  # a wait would not end
  with pytest.raises(RuntimeError, match='call 1 of the'):
    _launch()
  assert len(lib.remote) == 1


def test_a_zero_word_raises_nothing(lib):
  for direction in (+1, -1, +1):
    _launch(direction=direction)
  assert list(kh._PENDING) == [1, 2, 3]  # pylint: disable=protected-access
  distributed.check()
  assert not kh._PENDING  # pylint: disable=protected-access


def test_launches_whose_copy_out_ran_are_dropped_without_waiting(lib):
  for _ in range(3):
    _launch()
  lib.fault.copied = 2
  _launch()
  assert list(kh._PENDING) == [3, 4]  # pylint: disable=protected-access


@pytest.mark.parametrize('pushed,want', [(1, 1), (2, 2)])
def test_a_passed_deadline_raises_naming_the_last_call(lib, monkeypatch,
                                                       pushed, want):
  """Launch 2 waits (its push, or its copy-out after the push); launch 3
  is the last call launched."""
  monkeypatch.setattr(kh, 'REMOTE_TIMEOUT_S', 0.05)
  for _ in range(3):
    _launch()
  lib.fault.pushed, lib.fault.copied = pushed, 1
  lib.events_done = False
  with pytest.raises(RuntimeError) as err:
    kh.check()
  message = str(err.value)
  assert message.startswith('K3 remote copy (call 2 of the (1 x 4) mesh, '
                            'use 2 of its 16376-byte slot, rank 1) '
                            f'{kh.REMOTE_ERRORS[want]} within 0.05 s')
  assert 'the last call launched: K3 remote copy (call 3 of the' in message


def test_a_stream_stalled_after_its_copies_raises(lib, monkeypatch):
  """The copies pass their waits during the wait, but the stream does not
  finish: the error still names the last call launched."""
  monkeypatch.setattr(kh, 'REMOTE_TIMEOUT_S', 0.02)
  _launch()

  class _Passing(_Event):

    def query(self):
      lib.fault.pushed = lib.fault.copied = 1
      return False

  monkeypatch.setattr(kh, '_record_event', lambda stream: _Passing(False))
  with pytest.raises(RuntimeError, match='did not finish within 0.02 s; the '
                     r'last call launched: K3 remote copy \(call 1 of the'):
    kh.check()


def test_launch_remote_enqueues_without_synchronising(lib, monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError('the launch path synchronised')

  monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
  monkeypatch.setattr(torch.cuda.Stream, 'synchronize', refuse)
  monkeypatch.setattr(torch.cuda.Event, 'synchronize', refuse)
  monkeypatch.setattr(kh, '_record_event', refuse)
  monkeypatch.setattr(kh, 'check', refuse)
  kh.reset_launches()
  block = torch.zeros(2, 120000)
  out = _launch(rank=1, direction=+1, block=block)
  assert out.shape == block.shape and kh.launches['remote_shift'] == 1
  (args,) = lib.remote
  assert args[0] == block.data_ptr() and args[1] == 120000
  assert args[2:6] == (LEFT, RIGHT, out.data_ptr(), OWN)
  # has_src, direction, rows, cols, bytes, use, call, tag, fault_gen,
  # stream
  assert args[6:] == (1, 1, 2, 120000, 4, 1, 1, 1, 0, 1234)
  # The last rank of a +1 shift receives from its left and sends nothing.
  _launch(rank=3, direction=+1, block=block)
  assert lib.remote[-1][0] is None and lib.remote[-1][6] == 1


def test_the_first_rank_of_a_plus_one_shift_receives_zeros(lib):
  _launch(rank=0, direction=+1)
  args = lib.remote[-1]
  assert args[0] is not None and args[6] == 0 and args[7] == 1


def test_loopback_uses_the_own_slot_on_both_sides(lib):
  kh._SLOTS[(kh.LOOPBACK, 16376)] = kh._Slot(OWN, {})  # pylint: disable=protected-access
  kh.loopback_shift(torch.zeros(2, 2047))
  args = lib.remote[-1]
  assert args[2:4] == (OWN, OWN) and args[5] == OWN and args[6] == 1


def test_release_waits_with_check_and_frees_the_slots(lib, monkeypatch):
  def refuse(*args, **kwargs):
    raise AssertionError('synchronised')

  monkeypatch.setattr(torch.cuda, 'synchronize', refuse)
  _launch()
  kh.release_remote_slots()
  assert not kh._SLOTS and not kh._PENDING  # pylint: disable=protected-access


def _stall(lib, monkeypatch):
  """A launch whose stream never finishes, and a short deadline."""
  monkeypatch.setattr(kh, 'REMOTE_TIMEOUT_S', 0.02)
  _launch()
  lib.events_done = False


@pytest.mark.parametrize('stalled', [False, True])
def test_a_save_checks_before_it_waits_for_the_device(lib, monkeypatch,
                                                      tmp_path, stalled):
  """Trainer.save copies to the host (and, across ranks, meets a barrier):
  a stalled remote copy raises there, naming the call, and writes
  nothing."""
  from ddsp_torch.train.trainer import Trainer  # pylint: disable=g-import-not-at-top
  if stalled:
    _stall(lib, monkeypatch)
  else:
    _launch()
  trainer = types.SimpleNamespace(
      _ranks=None, model=torch.nn.Linear(2, 1), checkpoints_to_keep=1,
      checkpoint_path=Trainer.checkpoint_path,
      checkpoint_steps=Trainer.checkpoint_steps)
  state = types.SimpleNamespace(step=3, opt_state={})
  if stalled:
    with pytest.raises(RuntimeError, match='last call launched: K3 remote '
                       r'copy \(call 1 of the'):
      Trainer.save(trainer, state, str(tmp_path))
    assert not list(tmp_path.iterdir())
  else:
    Trainer.save(trainer, state, str(tmp_path))
    assert Trainer.checkpoint_steps(str(tmp_path)) == [3]
    assert not kh._PENDING  # pylint: disable=protected-access


def test_a_host_staged_collective_checks_first(lib, monkeypatch):
  """gloo moves a CUDA tensor through a host copy, which waits for the
  device: a stalled remote copy raises before it."""
  def copy():
    raise AssertionError('copied to the host before the check')

  _stall(lib, monkeypatch)
  monkeypatch.setattr(distributed.dist, 'get_backend', lambda group: 'gloo')
  with pytest.raises(RuntimeError, match='did not'):
    distributed.staged(types.SimpleNamespace(is_cuda=True, cpu=copy))
