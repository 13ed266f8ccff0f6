"""The benchmark's own tests run on the CPU at the port's reduced sizes;
those marked ``gpu`` need a CUDA card and skip without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs on a CUDA card; skips where torch sees no CUDA device")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda", 0)
