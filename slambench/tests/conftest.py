"""Shared set-up of the benchmark's own tests (CPU, small sizes).

Run from the repository root:

    python -m pytest slambench/tests -o addopts="" -p no:cacheprovider

Tests that need the card carry the `gpu` marker and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
