import pytest


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none (decided here,
    at run time, never while a module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: it runs a cell at its own size")
