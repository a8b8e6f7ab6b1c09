"""One intra-op thread for the PyTorch port's CPU tests.

The suite runs in several worker processes at once (pytest-xdist), and
PyTorch's CPU kernels and MKL start an OpenMP thread per core in each of
them.  With six workers on a machine of a few cores the threads
oversubscribe it, and the small tensor operations of these tests wait on
threads that spin: a test runs several times slower than alone, and slows
the JAX tests beside it.  Every CPU test module of the port imports
``one_torch_thread``, an autouse fixture that runs the module's tests
with one intra-op thread and restores the count after them.

The same fixture drops JAX's compiled programs before and after the
module (``jax.clear_caches``, where JAX is already imported).  Each
compiled CPU program keeps memory mappings, and a worker process holds at
most ``vm.max_map_count`` (65,530) of them: ``tests/test_diff.py`` alone
leaves ~50,000, and a worker that ran it and a few more JAX tests
segfaulted in the XLA compiler at the next compile (at
``tests/test_row_sharded.py::test_row_sharded_with_polish`` in one
process after ``test_torch_ops.py``, ``test_diff.py``,
``test_torch_continuation.py``, ``test_torch_cuda_sparse.py``,
``test_torch_padding.py``, ``test_torch_qps.py`` and ``test_utils.py``:
61,067 mappings before it).
"""

import sys

import pytest
import torch


def _drop_jax_programs():
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    _drop_jax_programs()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _drop_jax_programs()
