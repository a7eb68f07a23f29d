"""Settings of the port's tests: the marker of tests that need the card."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU and nvcc (the port's kernels); skips without one")


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none. Decided at run
    time, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card (python3 chip_smoke.py there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)
