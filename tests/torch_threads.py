"""The port's CPU tests run torch on one intra-op thread: their tensors
(at most a few envs) are too small to split, and the thread pool's
spin-waits cost several times the work and load the other test workers
and the JAX compiles beside them. Each tests/test_torch_*.py file that
runs torch on the CPU takes it for the whole module, its module-scoped
fixtures included:

    from torch_threads import one_torch_thread  # noqa: F401 (a fixture)

    pytestmark = pytest.mark.usefixtures("one_torch_thread")

The pool's size is restored after the module."""
import pytest
import torch


@pytest.fixture(scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
