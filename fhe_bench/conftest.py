"""pytest settings for the benchmark's own tests (``pytest fhe_bench``)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (skipped without one)")


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while a
    module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda:0")
