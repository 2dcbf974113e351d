"""pytest settings of the benchmark's own tests: the ``gpu`` marker, and the
fixture that decides at run time whether a CUDA card is present."""

from __future__ import annotations

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark runs only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs beside other test workers: two threads a test."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 2))
    yield
    torch.set_num_threads(before)
