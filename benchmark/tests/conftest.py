"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
repository root. Tests marked ``card`` need a CUDA device and skip without
one (they decide inside the test, never at import)."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test measures on the card")
    return "cuda"
