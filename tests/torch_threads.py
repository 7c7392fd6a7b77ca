"""One PyTorch intra-op thread while a port test module runs.

The test files run in several processes at once on one machine (pytest-
xdist, a file to a process), and PyTorch gives each process a thread
pool as wide as the machine: the pools then oversubscribe the cores, and
a test of many small operations on tensors a few thousand long, which is
most of the port's CPU tests, waits on threads that other processes hold.
On an 8-core machine with six processes the port's test files took 689 s
together this way and 79 s with one thread each (the same 622 passes).
A test module imports :func:`one_torch_thread`; it sets one thread for the
module and gives back the old count after it."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
