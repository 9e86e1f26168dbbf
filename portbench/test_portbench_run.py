"""Whole runs of each cell on the CPU at a tiny size: the result line has
exactly the contract's keys, the program agrees with the reference, and
with the timed path broken underneath `correct` comes out false.

The CPU takes the kernels' plain versions, so these runs hold the
harness's control flow and the reference's equations, not the card's
numbers; the limits are the cells' own."""

import io
import json
import time
from contextlib import redirect_stdout

import pytest
import torch

from portbench import run
from portbench.harness import cells, runtime
from portbench.harness.faults import FAULTS

CPU = torch.device('cpu')
KEYS = {'correct', 'attempted', 'failed', 'metrics', 'device', 'checks'}


def tiny(name):
  """The cell at a size the CPU runs in seconds (every width cut)."""
  cell = cells.load(name)
  if cell.config['name'] == 'inverse_synthesis':
    cell.config['model'].update(n_samples=16384, n_sinusoids=10,
                                freq_depth=8, n_harmonics=10,
                                n_noise_magnitudes=9)
  else:
    cell.config['model'].update(
        n_samples=16000, time_steps=250, n_harmonics=20,
        n_noise_magnitudes=33, reverb_length=8000, rnn_channels=128, ch=64,
        layers_per_stack=1)
  for offset in cell.config.get('weight_offsets', ()):
    offset['start'] = -33
  cell.traffic.update({
      'tones': dict(batch=2, seconds=1, pool=3),
      'long_tones': dict(seconds=1.024),
      'synthetic_notes': dict(batch=2, frames=64, n_sinusoids=10, n_mags=9),
      'melodies': dict(lengths_s=[1, 2], block=[2, 1], pool_per_length=2,
                       check_sample=2),
  }[cell.traffic['kind']])
  return cell


def execute(name, seed=2**31 + 11):
  torch.manual_seed(0)
  return run.execute(tiny(name), seed, 0.5, False, CPU,
                     t_start=time.time())


CELLS = [w['name'] for w in cells.benchmark()['workloads']]


@pytest.mark.parametrize('name', CELLS)
def test_result_line_has_the_contracts_keys(name):
  result = execute(name)
  out = io.StringIO()
  with redirect_stdout(out):
    runtime.print_result(result)
  line = json.loads(out.getvalue().strip().splitlines()[-1])
  assert set(line) == KEYS and list(line)[-1] == 'checks'
  cell = cells.load(name)
  assert set(line['metrics']) == {m['name'] for m in cell.end_to_end}
  assert line['attempted'] > 0 and line['failed'] == 0
  assert set(line['checks']) == set(cell.limits)
  for v in line['metrics'].values():
    assert set(v) == {'value', 'unit'}


@pytest.mark.parametrize('name', CELLS)
def test_program_agrees_with_reference(name):
  result = execute(name)
  assert result['correct'], result['checks']


@pytest.mark.parametrize('name,fault', [
    ('solo.train', 'unchanged'), ('solo.train', 'half_batch'),
    ('invsyn.train', 'unchanged'), ('invsyn.train', 'half_batch'),
    ('solo.render', 'altered_audio'),
    ('solo.long_train', 'sp_unchanged'), ('solo.long_train', 'sp_half_batch'),
    ('solo.long_train', 'no_exchange')])
def test_broken_timed_path_is_not_correct(name, fault):
  with FAULTS[fault]():
    result = execute(name)
  assert not result['correct'], result['checks']


def test_no_card_no_result(monkeypatch, capsys):
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  assert run.main(['--workload', 'solo.train', '--seed', '1',
                   '--seconds', '1']) != 0
  assert capsys.readouterr().out == ''
