"""The benchmark's own tests: the harness on the CPU at tiny sizes, and
the tests marked `card`, which need a CUDA card and skip here.

    python -m pytest benchmark/tests -q               # CPU
    python -m pytest benchmark/tests -q -m card       # on the card

Whether a card is there is decided inside the `card` fixture, never at
import time, so every worker collects the same tests.
"""

from __future__ import annotations

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import bench_helpers  # noqa: E402,F401  (the benchmark's paths)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the chip)")
    return torch.device("cuda:0")
