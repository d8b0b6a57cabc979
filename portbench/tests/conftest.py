"""The benchmark's tests: on the CPU at small sizes, through the kernels'
plain versions.  Tests that need a CUDA card carry the repository's
``cuda`` marker and take the ``cuda_card`` fixture, which decides at run
time (never at import) and skips without a card."""

import os
import sys

import pytest

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if CHECKOUT not in sys.path:
    sys.path.insert(0, CHECKOUT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device and nvcc (the port's kernels); skips without them"
    )


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the benchmark measures the port's kernels on the card")
