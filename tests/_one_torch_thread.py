"""One torch thread for each of the port's CPU test modules.

The suite runs in several pytest workers at once, and torch's default of
one intra-op thread a core in each of them oversubscribes the host: its
threads spin against one another and against the reference's tests that
run beside them.  A port test module imports :func:`one_torch_thread`, an
autouse fixture, so its tests run torch on one thread; the thread count
changes no input, size or tolerance.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
