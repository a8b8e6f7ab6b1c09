"""The PyTorch port's entry points (``make_problem``, ``solve``, ``QPDO``)
against the JAX package, on the CPU.  Validation is held in
tests/test_torch_validate.py, warm starts in tests/test_torch_warm.py.

The port is batch-first: one problem is a batch of one, so its results
carry a leading axis of length 1 that the JAX package's do not.  Pure
float64 solves must give the JAX package's status and iteration count,
with x and y within 1e-8.  Every entry point that makes tensors puts them on the GPU
unless told otherwise, so each call here passes ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _qp(n=30, m=45, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.1 * np.eye(n)
    return (Q, rng.standard_normal(n), rng.standard_normal((m, n)),
            -rng.random(m), rng.random(m))


# ---------------------------------------------------------------------------
# make_problem, devices
# ---------------------------------------------------------------------------

def test_make_problem_matches_jax_and_is_a_batch_of_one():
    Q, q, A, l, u = _qp(6, 9)
    l[2], u[4] = -np.inf, np.inf
    l[5], u[5] = -1e30, 1e30
    tp = pt.make_problem(Q, q, A, l, u, c=1.5, device="cpu")
    jp = qt.make_problem(Q, q, A, l, u, c=1.5)
    assert tp.Q.shape == (1, 6, 6) and tp.A.shape == (1, 9, 6)
    assert tp.l.shape == (1, 9) and tp.c.shape == (1,)
    assert (tp.n, tp.m) == (6, 9) and tp.Q.dtype == torch.float64
    for name in pt.Problem._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy()[0],
                                      np.asarray(getattr(jp, name)), name)
    assert tp.l[0, 2] == -pt.QPDO_INFTY and tp.u[0, 5] == pt.QPDO_INFTY


def test_make_problem_gives_an_unconstrained_qp_one_free_row():
    Q, q, _, _, _ = _qp(5, 1)
    tp = pt.make_problem(Q, q, np.zeros((0, 5)), [], [], device="cpu")
    jp = qt.make_problem(Q, q, np.zeros((0, 5)), [], [])
    assert tp.A.shape == (1, 1, 5) and not tp.A.any()
    assert tp.l.tolist() == [[-pt.QPDO_INFTY]] == [np.asarray(jp.l).tolist()]
    assert tp.u.tolist() == [[pt.QPDO_INFTY]]
    res = pt.solve(tp)
    jres = qt.solve(jp)
    assert res.info.status == ["solved"]
    np.testing.assert_allclose(res.x.numpy()[0], np.asarray(jres.x), atol=1e-8)


def test_make_problem_dtype_and_lists():
    tp = pt.make_problem([[2, 0], [0, 1]], [1, 1], [[1, 1]], [0], [1],
                         dtype=torch.float32, device="cpu")
    assert tp.Q.dtype == tp.l.dtype == torch.float32
    tp = pt.make_problem([[2, 0], [0, 1]], [1, 1], [[1, 1]], [0], [1],
                         device="cpu")
    assert tp.Q.is_floating_point()
    with pytest.raises(ValueError, match="Q must be"):
        pt.make_problem(np.zeros((2, 3, 3)), [0] * 3, np.zeros((1, 3)), [0],
                        [1], device="cpu")


def test_no_entry_point_lands_on_the_cpu_unasked():
    """Without a device argument the tensors go to the GPU: where there is
    none the call fails, it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    Q, q, A, l, u = _qp(4, 6)
    with pytest.raises((AssertionError, RuntimeError)):
        pt.make_problem(Q, q, A, l, u)
    with pytest.raises((AssertionError, RuntimeError)):
        pt.QPDO().setup(Q, q, A, l, u)
    jp = qt.make_problem(Q, q, A, l, u)
    for fn, arg in ((convert.tensor, Q), (convert.problem, jp)):
        with pytest.raises(TypeError, match="device"):
            fn(arg)


def _same_as_jax(tr, jr, atol=1e-8):
    """Batched port result against a batched JAX result."""
    np.testing.assert_array_equal(tr.info.status_val.numpy(),
                                  np.asarray(jr.info.status_val))
    np.testing.assert_array_equal(tr.info.iterations.numpy(),
                                  np.asarray(jr.info.iterations))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tr.y.numpy(), np.asarray(jr.y), rtol=0,
                               atol=atol)


def test_solve_with_warm_start_matches_jax():
    Q, q, A, l, u = _qp(seed=46)
    jp = qt.make_problem(Q, q, A, l, u)
    tp = pt.make_problem(Q, q, A, l, u, device="cpu")
    jr = qt.solve(jp)
    tr = pt.solve(tp)
    assert tr.x.shape == (1, 30) and tr.y.shape == (1, 45)
    _same_as_jax(tr, jax.tree.map(lambda a: a[None], jr))
    x0 = np.asarray(jr.x) + 1e-3
    jw = qt.solve(jp, x0=jnp.asarray(x0))
    tw = pt.solve(tp, x0=x0)                       # an array-like, unbatched
    _same_as_jax(tw, jax.tree.map(lambda a: a[None], jw))


# ---------------------------------------------------------------------------
# the stateful class
# ---------------------------------------------------------------------------

def _same_step(tres, jres):
    _same_as_jax(tres, jax.tree.map(lambda a: a[None], jres))
    assert tres.info.status == [jres.info.status]


def test_qpdo_sequence_matches_jax():
    """setup, solve, warm_start, update_q, update_bounds, update_settings
    with more Ruiz passes, solve: pure float64, every solve with the JAX
    package's status and iteration count, x and y within 1e-8."""
    Q, q, A, l, u = _qp(seed=47)
    rng = np.random.default_rng(48)
    base = dict(scaling=4)
    js, ts = qt.QPDO(), pt.QPDO()
    js.setup(Q, q, A, l, u, qt.Settings(**base))
    ts.setup(Q, q, A, l, u, pt.Settings(**base), device="cpu")
    jr, tr = js.solve(), ts.solve()
    _same_step(tr, jr)
    assert float(tr.info.run_time) >= float(tr.info.solve_time) > 0

    # the MPC step: warm start from the solution, new cost, new bounds
    q2 = q + 0.05 * rng.standard_normal(q.shape)
    l2, u2 = l - 0.1, u + 0.05
    u2[3] = np.inf
    js.warm_start(jr.x, jr.y)
    ts.warm_start(tr.x, tr.y)
    js.update_q(q2)
    ts.update_q(q2)
    js.update_bounds(l2, u2)
    ts.update_bounds(l2, u2)
    for name in ("Q", "q", "l", "u"):
        np.testing.assert_allclose(getattr(ts._sp.data, name).numpy()[0],
                                   np.asarray(getattr(js._sp.data, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    np.testing.assert_allclose(ts._sp.scaling.c.numpy()[0],
                               np.asarray(js._sp.scaling.c), rtol=1e-12)
    assert ts._sp.u_finite[0, 3] == 0
    jr2, tr2 = js.solve(), ts.solve()
    _same_step(tr2, jr2)
    assert int(tr2.info.iterations) < int(tr.info.iterations)

    # more Ruiz passes on the already scaled data, then a cold solve (the
    # warm start was consumed)
    js.update_settings(qt.Settings(scaling=10))
    ts.update_settings(pt.Settings(scaling=10))
    for name in ("D", "E"):
        np.testing.assert_allclose(getattr(ts._sp.scaling, name).numpy()[0],
                                   np.asarray(getattr(js._sp.scaling, name)),
                                   rtol=1e-12, atol=0, err_msg=name)
    jr3, tr3 = js.solve(), ts.solve()
    _same_step(tr3, jr3)

    # partial warm starts and a one-sided bound update
    js.warm_start(x=jr3.x)
    ts.warm_start(x=tr3.x)
    js.update_bounds(u=u2 + 0.1)
    ts.update_bounds(u=u2 + 0.1)
    _same_step(ts.solve(), js.solve())


def test_qpdo_without_cost_scaling_and_with_kkt_ruiz():
    Q, q, A, l, u = _qp(12, 18, seed=49)
    js, ts = qt.QPDO(), pt.QPDO()
    js.setup(Q, q, A, l, u, qt.Settings(scaling=0))
    ts.setup(Q, q, A, l, u, pt.Settings(scaling=0), device="cpu")
    js.update_q(2.0 * q)
    ts.update_q(2.0 * q)
    np.testing.assert_array_equal(ts._sp.norm_q.numpy()[0],
                                  np.asarray(js._sp.norm_q))
    _same_step(ts.solve(), js.solve())
    js.update_settings(qt.Settings(scaling=3, ruiz_kkt=True))
    ts.update_settings(pt.Settings(scaling=3, ruiz_kkt=True))
    _same_step(ts.solve(), js.solve())


def test_qpdo_guards():
    Q, q, A, l, u = _qp(4, 6)
    s = pt.QPDO()
    assert s.default_settings() == pt.Settings()
    assert s.constant("QPDO_INFTY") == pt.QPDO_INFTY
    assert s.constant("QPDO_SOLVED") == pt.SOLVED
    assert np.isnan(s.constant("QPDO_NAN"))
    with pytest.raises(ValueError, match="not recognized"):
        s.constant("QPDO_NOPE")
    for call in (s.solve, lambda: s.update_q(q), lambda: s.update_bounds(l),
                 lambda: s.warm_start(q),
                 lambda: s.update_settings(pt.Settings())):
        with pytest.raises(RuntimeError, match="setup"):
            call()
    s.setup(Q, q, A, l, u, device="cpu")
    with pytest.raises(ValueError, match="Decreasing"):
        s.update_settings(pt.Settings(scaling=2))
    with pytest.raises(ValueError, match="greater than upper"):
        s.update_bounds(l=u + 1.0)
    nan_u = u.copy()
    nan_u[1] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        s.update_bounds(u=nan_u)
    with pytest.raises(ValueError, match="max_iter"):
        s.update_settings(pt.Settings(max_iter=0))
    assert s.solve().info.status == ["solved"]
    s.delete()
    with pytest.raises(RuntimeError, match="setup"):
        s.solve()
