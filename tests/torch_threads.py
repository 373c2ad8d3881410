"""A fixture for port tests that step small batches for many steps on
the CPU: torch runs them on one intra-op thread (their tensors are too
small to split, and the thread pool's spin-waits cost several times the
work and load the other test workers), and the pool's size is restored
after the test."""
import pytest
import torch


@pytest.fixture
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
