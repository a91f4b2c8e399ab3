"""Shared fixture for the PyTorch port's tests: one intra-op CPU thread.

The port's CPU tests run tiny tensors; with PyTorch's default thread pool
(one thread per core) the pool's start-up and contention across the
parallel test workers costs far more than the arithmetic. Import
``one_cpu_thread`` into a test module to apply it there.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
