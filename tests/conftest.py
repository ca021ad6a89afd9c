"""The port's tests that need the card carry the ``card`` marker and
decide inside the ``card`` fixture, never at import, as the benchmark's
tests do (``svbench/tests/conftest.py``). Run them on the chip machine:
``PYTHONPATH=src python -m pytest tests -m card``."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card(chips=n): needs an NVIDIA card, or n of them "
        "(runs on the chip machine: python -m pytest tests -m card)")


@pytest.fixture
def card(request):
    """The card; a test marked ``card(chips=n)`` needs ``n`` of them."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; this machine has none")
    need = max((m.kwargs.get("chips", 1)
                for m in request.node.iter_markers("card")), default=1)
    have = torch.cuda.device_count()
    if have < need:
        pytest.skip(f"needs {need} cards; this machine has {have}")
    return torch.device("cuda")
