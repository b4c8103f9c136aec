"""The benchmark's own tests (run them from the checkout's root:
`python -m pytest -q benchmark/tests`).  Tests that need the card carry
the `cuda` marker and take the `cuda_device` fixture, which skips without
one; whether there is a card is decided there, never at import."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return "cuda"
