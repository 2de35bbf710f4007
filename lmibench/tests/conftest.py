"""The benchmark's own tests: ``pytest lmibench/tests``. Tests that need
the card carry the ``cuda`` marker and decide in a fixture, never while a
module is imported, whether to skip."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false here)")
    return torch.device("cuda")
