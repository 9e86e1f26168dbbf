"""On the card, at each cell's own size: the control (the reference in
float8 in the program's place) and the planted faults come out as not
correct on three seeds. Run there with `pytest portbench/ -m card`."""

import pytest

from portbench.harness import cells, check
from portbench.harness.faults import FAULTS

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
CASES = [('solo.train', 'control'), ('solo.train', 'half_batch'),
         ('invsyn.train', 'control'), ('invsyn.train', 'half_batch'),
         ('solo.render', 'control'), ('solo.render', 'altered_audio'),
         ('solo.long_train', 'control'), ('solo.long_train', 'sp_half_batch'),
         ('solo.long_train', 'no_exchange')]


def reading(name, seed, device, kind):
  cell = cells.load(name)
  runner = cells.driver(cell.driver).Run(cell, seed, device)
  runner.setup()
  runner.window(1.0)
  runner.release()
  return cell, runner.readings(kind)


@pytest.mark.card
@pytest.mark.parametrize('name,kind', CASES)
@pytest.mark.parametrize('seed', SEEDS)
def test_control_and_faults_fail_the_limits(card, name, kind, seed):
  if kind == 'control':
    cell, values = reading(name, seed, card, 'control')
  else:
    with FAULTS[kind]():
      cell, values = reading(name, seed, card, 'program')
  assert not check.verdict(values, cell.limits), values
