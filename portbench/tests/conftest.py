import pytest


@pytest.fixture
def cuda_device():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
