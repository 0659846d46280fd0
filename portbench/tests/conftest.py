"""The benchmark's own tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need an NVIDIA card and skip elsewhere (decided inside the
``cuda_device`` fixture, never while a module is imported)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (CUDA); skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip (see portbench/README.md)")
    return "cuda"


@pytest.fixture
def root():
    return ROOT
