"""The benchmark's tests. Tests that need a CUDA card carry the `card`
marker and take the `card` fixture, which skips them where torch finds no
card (decided when the test runs, never at import)."""
import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; torch finds none")
    return torch.device("cuda")
