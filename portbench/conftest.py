"""pytest settings of the benchmark's own tests (`pytest portbench/`).

Tests that need an NVIDIA GPU carry the `card` marker and take the
`card` fixture, which skips them where torch sees no CUDA device; the
decision is made when the test runs, never when its module is imported.
"""

import pytest


def pytest_configure(config):
  config.addinivalue_line(
      'markers', 'card: needs an NVIDIA GPU (skipped without one)')


@pytest.fixture
def card():
  import torch  # pylint: disable=g-import-not-at-top
  if not torch.cuda.is_available():
    pytest.skip('no CUDA device: this test runs on the card')
  return torch.device('cuda', 0)
