"""Fixtures of the benchmark's own tests (run with
``python -m pytest bench/tests``; the repository's suite does not collect
them). Tests that need a CUDA card take the ``card`` fixture, which skips
them elsewhere; the decision is made when the test runs."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
