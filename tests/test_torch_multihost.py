"""The PyTorch port's multi-process runtime (``parallel.multihost``)
against the JAX package's two-process run (tests/multihost_worker.py):
two gloo processes on the CPU join through ``initialize()`` from the
environment ``torchrun`` sets, form ``global_mesh``, assemble a batch
from each process's own problems with ``distribute_batch`` and solve it
with plain ``solve_batch``.  The JAX package solves the same global
batch here; the same statuses and iterations, x within 1e-8.
"""

import numpy as np
import pytest
import torch.distributed as dist

import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.parallel import solve_batch as j_solve_batch

from qpdo_tpu_torch.parallel import multihost
from torch_dist import Ranks
from torch_dist_cases import multihost_local
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def ranks():
    return Ranks("multihost", 2, timeout=900, init=False)


def _global_batch():
    parts = [multihost_local(r) for r in range(2)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_distributed_batch_matches_jax(ranks):
    d = _global_batch()
    ref = j_solve_batch(qt.Problem(**{k: jnp.asarray(v)
                                      for k, v in d.items()}),
                        qt.Settings(max_iter=300))
    values = ranks.result()
    for v in values:
        np.testing.assert_array_equal(v["status"],
                                      np.asarray(ref.info.status_val))
        np.testing.assert_array_equal(v["iterations"],
                                      np.asarray(ref.info.iterations))
        np.testing.assert_allclose(v["x"], np.asarray(ref.x), atol=1e-8)
    assert (values[0]["status"] == qt.SOLVED).all()


def test_each_process_holds_its_own_problems(ranks):
    """distribute_batch keeps each rank's batch as its block, and each
    rank reads its own statuses (JAX's addressable_shards)."""
    for r, v in enumerate(ranks.result()):
        np.testing.assert_array_equal(v["local_q"], multihost_local(r)["q"])
        assert v["local_status"].shape == (4,)
        assert (v["local_status"] == qt.SOLVED).all()


def test_initialize_alone_is_a_no_op(monkeypatch):
    """Without arguments and without the environment of torchrun, one
    process: nothing is initialized."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not dist.is_initialized()


def test_initialize_wants_all_three_arguments():
    with pytest.raises(ValueError, match="together"):
        multihost.initialize(coordinator_address="127.0.0.1:1")

