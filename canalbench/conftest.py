import os
import sys

import pytest

# the port lives under src/ (the benchmark puts it on the path itself)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skips on hosts without CUDA")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The harness's CPU runs are thousands of small tensor ops: one
    thread each keeps them quick beside the other test workers."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
