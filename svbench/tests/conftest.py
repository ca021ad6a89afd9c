"""The benchmark's own tests. Tests that need the card carry the ``card``
marker and decide inside the ``card`` fixture, never at import."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (runs on the chip machine: "
        "python -m pytest svbench/tests -m card)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    return torch.device("cuda")
