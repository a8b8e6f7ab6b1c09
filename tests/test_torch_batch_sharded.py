"""The batch-sharded solve of the PyTorch port (``parallel.batch``: a
batch split over the ranks of a gloo group on the CPU) against the JAX
package's ``solve_batch_sharded`` on a mesh of as many virtual CPU
devices, and against the port's own unsharded solve.

Four worker processes (``tests/torch_dist_cases.batch_sharded``, joined
through ``multihost.initialize``'s explicit form) run every case once,
over ranks 0-1 and over all four; the JAX side runs here meanwhile.
Float64: the same statuses and iteration counts as JAX, x within 1e-8.
The bench configuration (float32 warmup, mixed GEMMs, straggler
compaction per rank decided from the global active count) is held to
the port's unsharded solve bit for bit: no problem's result depends on
how the batch is split.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import qpdo_tpu as qt
from qpdo_tpu.parallel import solve_batch_sharded as j_solve_batch_sharded

import torch_parity_data as data
from torch_dist import Ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

X_TOL = 1e-8


@pytest.fixture(scope="module")
def ranks():
    return Ranks("batch_sharded", 4, timeout=900, init=False)


@pytest.fixture(scope="module")
def jax_cold():
    d = data.family(8, 16, 12, 2)
    problems = qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})
    out = {}
    for ndev in (2, 4):
        mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("batch",))
        out[ndev] = (mesh, problems,
                     j_solve_batch_sharded(problems, mesh,
                                           qt.Settings(max_iter=300)))
    return out


def _hold(ours, ref):
    np.testing.assert_array_equal(ours["status"],
                                  np.asarray(ref.info.status_val))
    assert (ours["status"] == qt.SOLVED).all()
    np.testing.assert_array_equal(ours["iterations"],
                                  np.asarray(ref.info.iterations))
    np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=X_TOL)


@pytest.mark.parametrize("ndev", [2, 4])
def test_cold_matches_jax(ranks, jax_cold, ndev):
    _hold(ranks.result()[0][f"cold_r{ndev}"], jax_cold[ndev][2])


@pytest.mark.parametrize("ndev", [2, 4])
def test_warm_start_matches_jax(ranks, jax_cold, ndev):
    """x0 and y0 (0.9 times the cold solution) split like the problems."""
    mesh, problems, cold = jax_cold[ndev]
    ref = j_solve_batch_sharded(problems, mesh, qt.Settings(max_iter=300),
                                x0=0.9 * cold.x, y0=0.9 * cold.y)
    _hold(ranks.result()[0][f"warm_r{ndev}"], ref)


def test_each_rank_holds_its_block(ranks):
    """The result's local block on rank r is rows [2r, 2r+2) of the
    batch of 8 over 4 ranks."""
    values = ranks.result()
    x = values[0]["cold_r4"]["x"]
    for r, v in enumerate(values):
        np.testing.assert_array_equal(v["local_r4"], x[2 * r:2 * r + 2])


@pytest.mark.parametrize("mode", ["bench", "bench_plain"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_split_does_not_change_a_problem(ranks, mode, ndev):
    """The bench configuration over 2 and 4 ranks, compacted and not, is
    the unsharded solve bit for bit (x, iterations, objective)."""
    ours = ranks.result()[0]
    ref = ours[f"{mode}_ref"]
    assert (ref["status"] == qt.SOLVED).all()
    for field in ("x", "status", "iterations", "objective"):
        np.testing.assert_array_equal(ours[f"{mode}_r{ndev}"][field],
                                      ref[field])
