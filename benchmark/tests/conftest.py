"""Tests of the benchmark itself (``python -m pytest benchmark/tests``), apart
from the repository's ``tests/``: the reference and the counts against the
port on the CPU, the harness's arithmetic, and the comparison's control and
faults. A test marked ``card`` needs an NVIDIA card and skips without one,
deciding inside the test."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the comparison at the cell's own size runs there")
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
