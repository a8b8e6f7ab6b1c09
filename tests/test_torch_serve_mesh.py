"""The PyTorch port's services over a mesh, against the JAX package's:
``SolverService(mesh=)`` (every rank of a gloo group on the CPU constructs
it; rank 0 queues, batches, pads each group to a multiple of the mesh
and broadcasts it; every rank solves its block; rank 0 gathers) against
JAX's service on a mesh of 8 virtual CPU devices and the direct solves
(tests/test_serve.py:227-256); and the sparse fleets over a mesh,
``solve_sparse_batch(mesh=)`` and ``solve_sparse_heterogeneous(mesh=)``,
against JAX's (tests/test_sparse.py:508-534).  Two worker processes
(``tests/torch_dist_cases.serve_mesh``) run every case once."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import qpdo_tpu as qt
from qpdo_tpu.serve import SolverService as JaxService

import torch_parity_data as data
from torch_dist import Ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from utils import kkt_residuals, random_qp


@pytest.fixture(scope="module")
def ranks():
    return Ranks("serve_mesh", 2, timeout=900)


def _mesh(ndev):
    return Mesh(np.asarray(jax.devices("cpu")[:ndev]), ("batch",))


def test_service_over_a_mesh_matches_jax(ranks):
    """Five requests (a padded group of 6 over 2 ranks): each SOLVED,
    within the oracle, x within 1e-8 of JAX's service (8 devices) and of
    a direct solve."""
    svc = JaxService(max_batch=16, max_wait_ms=50, mesh=_mesh(8))
    try:
        probs = [random_qp(24, 18, seed=seed) for seed in range(5)]
        futs = [svc.submit(qt.make_problem(*p)) for p in probs]
        ref = [f.result(180) for f in futs]
    finally:
        svc.shutdown()
    served = ranks.result()[0]["served"]
    for p, (x, y, status), r in zip(probs, served, ref):
        assert status == int(r.info.status_val) == qt.SOLVED
        rp, rd = kkt_residuals(*p, x, y)
        assert rp <= 1e-6 and rd <= 1e-6
        np.testing.assert_allclose(x, np.asarray(r.x), atol=1e-8)
        direct = qt.solve(qt.make_problem(*p), qt.Settings())
        np.testing.assert_allclose(x, np.asarray(direct.x), atol=1e-8)


def test_service_counts_and_refuses_submit_off_rank_0(ranks):
    values = ranks.result()
    stats = values[0]["stats"]
    assert stats["completed"] == 5 and stats["failed"] == 0
    assert values[1]["refused"] is True


def test_sparse_fleet_over_a_mesh_matches_jax(ranks):
    fleet = data.sparse_fleet()
    ref = qt.solve_sparse_batch(fleet, mesh=_mesh(2))
    for v in ranks.result():
        ours = v["fleet"]
        np.testing.assert_array_equal(ours["status"],
                                      np.asarray(ref.info.status_val))
        assert (ours["status"] == qt.SOLVED).all()
        np.testing.assert_array_equal(ours["iterations"],
                                      np.asarray(ref.info.iterations))
        np.testing.assert_allclose(ours["x"], np.asarray(ref.x), atol=1e-9)
        np.testing.assert_allclose(ours["y"], np.asarray(ref.y), atol=1e-9)


def test_sparse_fleet_split_changes_nothing(ranks):
    """Each rank solved its half; the whole equals the unsharded fleet."""
    values = ranks.result()
    ours, ref = values[0]["fleet"], values[0]["fleet_ref"]
    for field in ("x", "y", "status", "iterations"):
        np.testing.assert_array_equal(ours[field], ref[field])
    for r, v in enumerate(values):
        np.testing.assert_array_equal(v["fleet_local"], ref["x"][4 * r:4 * r + 4])


def test_heterogeneous_fleet_over_a_mesh_matches_jax(ranks):
    mixed = data.mixed_fleet()
    ref = qt.solve_sparse_heterogeneous(mixed, mesh=_mesh(2))
    ours = ranks.result()[0]["mixed"]
    assert len(ours) == len(ref) == 4
    for (x, status, iters), r in zip(ours, ref):
        assert status == int(r.info.status_val) == qt.SOLVED
        assert iters == int(r.info.iterations)
        np.testing.assert_allclose(x, np.asarray(r.x), atol=1e-8)
