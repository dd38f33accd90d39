"""Tests of the benchmark itself; they run on the CPU at toy sizes.

Tests that need the CUDA card carry the ``card`` marker and skip here: the
``card`` fixture decides, inside the test, whether a card is present.  On
the card machine: ``python3 -m pytest portbench/tests -m card``.
"""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
