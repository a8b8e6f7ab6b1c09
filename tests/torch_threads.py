"""One intra-op thread for the PyTorch port's CPU tests.

The suite runs in several worker processes at once (pytest-xdist), and
PyTorch's CPU kernels and MKL start an OpenMP thread per core in each of
them.  With six workers on a machine of a few cores the threads
oversubscribe it, and the small tensor operations of these tests wait on
threads that spin: a test runs several times slower than alone, and slows
the JAX tests beside it.  Every CPU test module of the port imports
``one_torch_thread``, an autouse fixture that runs the module's tests
with one intra-op thread and restores the count after them.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
