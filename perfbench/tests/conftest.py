"""The benchmark's own tests (run them with ``python -m pytest
perfbench/tests``; the repository's ``tests/`` suite does not collect
them). Tests that need a CUDA card carry the ``card`` marker and decide
inside a fixture whether there is one."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'card: needs a CUDA card; skips on a host without one')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (run on the chip: python -m pytest '
                    'perfbench/tests -m card)')
    return torch.device('cuda')
