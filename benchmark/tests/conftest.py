"""CPU tests of the benchmark; the tests marked `cuda` need the card and
skip elsewhere (decided in the `card` fixture, never at import)."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips elsewhere")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny(tmp_path):
    """A temporary benchmark directory with every configuration and mix
    shrunk to CPU size (`tiny.py`)."""
    from benchmark.tests.tiny import tiny_bench

    return tiny_bench(tmp_path)
