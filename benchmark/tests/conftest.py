"""Tests of the benchmark harness (``python -m pytest benchmark/tests``).

Tests that need an NVIDIA card carry the ``card`` marker and skip here,
deciding inside the ``card`` fixture.
"""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs an NVIDIA card')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card (run on the card machine)')
    return torch.device('cuda', 0)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
