"""The row-sharded solve of the PyTorch port (``parallel.row_sharded``:
one QP's constraint rows split over the ranks of a gloo group on the CPU)
against the JAX package's ``solve_row_sharded`` on a mesh of as many
virtual CPU devices, on the cases of tests/test_row_sharded.py.

Four worker processes (``tests/torch_dist_cases.row_sharded``) run every
case once, over ranks 0-1 and over all four; the JAX side runs here
meanwhile.  Both solves are float64 with the bisection linesearch: the
same status and iteration count, x and y[:m] within 1e-9.  The padded
tail of y is exactly 0, and the replicated x is bit for bit the same on
every rank.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import qpdo_tpu as qt
from qpdo_tpu.parallel import row_sharded as jrow
from qpdo_tpu.parallel import solve_row_sharded as j_solve_row_sharded

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.parallel import row_sharded
from torch_dist import Ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)
from utils import kkt_residuals, random_qp

TOL = 1e-9


@pytest.fixture(scope="module")
def ranks():
    return Ranks("row_sharded", 4, timeout=900)


def _jax(n, m, seed, ndev, settings=None, **kw):
    p = qt.make_problem(*random_qp(n, m, seed=seed))
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("rows",))
    res, m_orig = j_solve_row_sharded(p, settings, mesh=mesh, **kw)
    return res, m_orig


def _hold(ours, ref, m):
    assert int(ours["status"][0]) == int(ref.info.status_val) == qt.SOLVED
    assert int(ours["iterations"][0]) == int(ref.info.iterations)
    np.testing.assert_allclose(ours["x"][0], np.asarray(ref.x), atol=TOL)
    np.testing.assert_allclose(ours["y"][0, :m], np.asarray(ref.y)[:m],
                               atol=TOL)


@pytest.mark.parametrize("ndev", [2, 4])
def test_matches_jax_row_sharded(ranks, ndev):
    """n=60, m=400 (test_row_sharded.py:test_matches_unsharded) over 2
    and over 4 ranks, against JAX over 2 and 4 devices."""
    bisect = qt.Settings(linesearch="bisect")
    ref, m = _jax(60, 400, 0, ndev, bisect)
    _hold(ranks.result()[0][f"m400_r{ndev}"], ref, m)


def test_padding_is_inert(ranks):
    """m=101 over the 4 ranks of the default group (no mesh given): 3
    inert rows; the padded tail of y is exactly 0 and the solution is
    JAX's (whose mesh pads the same way)."""
    ref, m = _jax(30, 101, 4, 4)
    ours = ranks.result()[0]["m101_r4"]
    assert ours["m"] == m == 101
    assert ours["y"].shape == (1, 104)
    _hold(ours, ref, m)
    np.testing.assert_array_equal(ours["y_tail"], 0.0)


def test_replicated_x_is_bit_identical_on_every_rank(ranks):
    values = ranks.result()
    for case in values[0]:
        xs = [v[case]["x_rank"] for v in values if case in v]
        assert len(xs) in (2, 4)
        for x in xs[1:]:
            np.testing.assert_array_equal(x, xs[0])


def test_warm_start_matches_jax(ranks):
    """A warm start from the cold solution (test_row_sharded.py:
    test_warm_start_row_sharded): fewer iterations, and JAX's result."""
    cold, m = _jax(40, 160, 7, 2)
    warm, _ = _jax(40, 160, 7, 2, x0=cold.x, y0=np.asarray(cold.y)[:m])
    ours = ranks.result()[0]
    _hold(ours["cold_r2"], cold, m)
    _hold(ours["warm_r2"], warm, m)
    assert ours["warm_r2"]["iterations"][0] < ours["cold_r2"]["iterations"][0]


def test_polish_matches_jax(ranks):
    """polish=True (test_row_sharded.py:test_row_sharded_with_polish): the
    polish gathers the rows; the oracle holds and JAX's result too."""
    rng = np.random.default_rng(4)
    n, m = 24, 32
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.1 * np.eye(n)
    q, A = rng.standard_normal(n), rng.standard_normal((m, n))
    l, u = -np.ones(m), np.ones(m)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("rows",))
    ref, _ = j_solve_row_sharded(qt.make_problem(Q, q, A, l, u),
                                 qt.Settings(polish=True), mesh=mesh)
    ours = ranks.result()[0]["polish_r2"]
    _hold(ours, ref, m)
    rp, rd = kkt_residuals(Q, q, A, l, u, ours["x"][0], ours["y"][0, :m])
    assert rp < 1e-6 and rd < 1e-6


def test_other_newton_routes_match_the_unsharded_port(ranks):
    """The Newton routes besides the default chol, over 2 ranks, against
    the port's unsharded solve (n=20, m=64): "inv", "cg", the fused
    right-hand side and the incremental KKT cache (its rows picked over
    the whole problem) in float64, the same iterations and x within 1e-8;
    the bench configuration (float32 warmup with the ns inverse, mixed
    GEMMs with hard rows picked over the whole problem) and
    ``pallas_kkt`` (a float32 factor of K formed on the local rows and
    all-reduced, where the unsharded solve on the CPU takes the fused
    kernel's plain version), whose float32 factors round apart: within
    2 iterations, both within the oracle at 1e-6."""
    from torch_dist_cases import ROW_VARIANTS

    Q, q, A, l, u = random_qp(20, 64, seed=5)
    ours = ranks.result()[0]
    for name in ROW_VARIANTS:
        got, ref = ours[name], ours[name]["ref"]
        assert got["status"][0] == ref["status"][0] == qt.SOLVED, name
        if name in ("bench", "pallas_kkt"):
            assert abs(int(got["iterations"][0])
                       - int(ref["iterations"][0])) <= 2, name
            rp, rd = kkt_residuals(Q, q, A, l, u, got["x"][0],
                                   got["y"][0, :64])
            assert rp <= 1e-6 and rd <= 1e-6, name
        else:
            assert got["iterations"][0] == ref["iterations"][0], name
            np.testing.assert_allclose(got["x"], ref["x"], atol=1e-8,
                                       err_msg=name)


def test_pad_rows_matches_jax():
    Q, q, A, l, u = random_qp(5, 7, seed=1)
    ours = row_sharded.pad_rows(pt.make_problem(Q, q, A, l, u,
                                                device="cpu"), 4)
    ref = jrow.pad_rows(qt.make_problem(Q, q, A, l, u), 4)
    for a, b in zip(ours[:5], ref[:5]):
        np.testing.assert_array_equal(a[0].numpy(), np.asarray(b))
    y = row_sharded.pad_rows_vec(torch.arange(3.0)[None], 6)
    np.testing.assert_array_equal(y.numpy(), [[0, 1, 2, 0, 0, 0]])


def test_host_driven_loop(ranks):
    """``verbose`` and ``max_time`` (which the JAX package's row-sharded
    path ignores) run the host-driven loop on every rank: the printed
    solve takes the unsharded solve's iterations (the "ref" of the
    default route), and a limit already past stops every rank at once
    with MAX_TIME_REACHED."""
    ours = ranks.result()
    ref = ours[0]["fused_rhs"]["ref"]
    plain = pt.solve(pt.make_problem(*random_qp(20, 64, seed=5),
                                     device="cpu"),
                     pt.Settings(linesearch="bisect"))
    got = ours[0]["verbose"]
    assert got["status"][0] == qt.SOLVED
    assert got["iterations"][0] == int(plain.info.iterations[0])
    np.testing.assert_allclose(got["x"][0], plain.x[0].numpy(), atol=1e-8)
    for v in ours[:2]:
        assert v["max_time"]["status"][0] == qt.MAX_TIME_REACHED
    assert ref["status"][0] == qt.SOLVED
