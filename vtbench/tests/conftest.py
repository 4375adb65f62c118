import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is there (decided here, when the
    test runs, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.cuda.device_count()
