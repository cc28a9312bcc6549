"""The benchmark's own tests: the yardstick on the CPU at small sizes, and
card tests marked `cuda`, which decide in a fixture whether there is a
card.

    python -m pytest -p no:cacheprovider benchmark/tests
    python -m pytest -p no:cacheprovider -m cuda benchmark/tests   (on the card)
"""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skipped without CUDA")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda:0")
