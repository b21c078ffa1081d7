"""The benchmark's own tests: the harness's files, readers, reference and
faults on the CPU at small sizes; tests marked ``card`` need a CUDA device
and skip without one (``python -m pytest -o addopts="" bench_port/tests -m
card`` on the card's machine)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
