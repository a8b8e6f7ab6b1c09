"""Warm starts of the PyTorch port against the JAX package, on the CPU:
a warm-started ``init_state`` agrees to 1e-12 relative (``warm_mu_adapt``
on and off), and warm-started ``solve_batch`` calls (plain and compacted)
give the JAX package's statuses and iteration counts, x and y within 1e-8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.parallel.batch import solve_batch as j_solve_batch
from qpdo_tpu.solver import core as jcore
from qpdo_tpu.solver.scaling import scale_problem as j_scale

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.solver import core as tcore
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _batch(B, n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


@pytest.mark.parametrize("adapt", [True, False])
@pytest.mark.parametrize("warm", ["x", "y", "xy"])
def test_warm_started_init_state_matches_jax(warm, adapt):
    B, n, m = 4, 20, 30
    d = _batch(B, n, m, seed=41)
    rng = np.random.default_rng(42)
    # the solution, off by nothing, a little, and a lot: the warm points'
    # own residuals, and with them the penalty scale, span its clip range
    sol = pt.solve_batch(pt.Problem(**{k: torch.from_numpy(v)
                                       for k, v in d.items()}))
    off = np.array([0.0, 1e-3, 0.1, 10.0])[:, None]
    x0 = sol.x.numpy() + off * rng.standard_normal((B, n))
    y0 = sol.y.numpy() + off * rng.standard_normal((B, m))
    x0 = x0 if "x" in warm else None
    y0 = y0 if "y" in warm else None
    settings = qt.Settings(kkt_solver="ns", warm_mu_adapt=adapt)
    # jitted: one compiled program each, not one per primitive
    jsp = jax.jit(jax.vmap(lambda p: j_scale(p, 10)))(
        qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()}))
    js = jax.jit(jax.vmap(
        lambda sp, xw, yw: jcore.init_state(sp, settings, xw, yw,
                                            x0 is not None, y0 is not None),
        in_axes=(0, None if x0 is None else 0, None if y0 is None else 0)))(
            jsp, None if x0 is None else jnp.asarray(x0),
            None if y0 is None else jnp.asarray(y0))
    ts = tcore.init_state(convert.scaled_problem(jsp, "cpu"),
                          convert.settings(settings),
                          None if x0 is None else torch.from_numpy(x0),
                          None if y0 is None else torch.from_numpy(y0))
    for name in pt.types.SolverState._fields:
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            # the ns inverse of a K whose penalties the good warm points
            # shrank amplifies roundoff by cond(K)
            tol = 1e-9 if name == "kkt_cache" else 1e-12
            scale = max(np.abs(b).max(), 1e-300)
            assert np.abs(a - b).max() <= tol * scale, name
    if adapt:
        # the better warm points start from smaller penalties
        plain = tcore.init_state(
            convert.scaled_problem(jsp, "cpu"),
            convert.settings(settings.replace(warm_mu_adapt=False)),
            None if x0 is None else torch.from_numpy(x0),
            None if y0 is None else torch.from_numpy(y0))
        assert torch.all(ts.mu <= plain.mu)
        if warm == "xy":
            assert torch.all(ts.mu[0] < plain.mu[0])
            assert torch.equal(ts.mu[3], plain.mu[3])


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


@pytest.mark.parametrize("compact", [False, True])
def test_warm_started_solve_batch_matches_jax(compact):
    d = _batch(5, 24, 36, seed=43)
    settings = qt.Settings()
    jp = qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})
    tp = pt.Problem(**{k: torch.from_numpy(v) for k, v in d.items()})
    jcold = j_solve_batch(jp, settings, compact=compact)
    tcold = pt.solve_batch(tp, convert.settings(settings), compact=compact)
    _same_as_jax(tcold, jcold)
    # the MPC re-solve: a perturbed q from the previous solution
    rng = np.random.default_rng(44)
    q2 = d["q"] + 0.05 * rng.standard_normal(d["q"].shape)
    jwarm = j_solve_batch(jp._replace(q=jnp.asarray(q2)), settings,
                          x0=jcold.x, y0=jcold.y, compact=compact)
    twarm = pt.solve_batch(tp._replace(q=torch.from_numpy(q2)),
                           convert.settings(settings), x0=tcold.x, y0=tcold.y,
                           compact=compact)
    _same_as_jax(twarm, jwarm)
    assert np.all(np.asarray(jwarm.info.status_val) == qt.SOLVED)
    assert twarm.info.iterations.sum() < tcold.info.iterations.sum()


def test_warm_started_hybrid_solve_casts_the_points_to_float32():
    """The float32 warmup phase takes x0/y0 cast to float32
    (core.py:774-787 of the JAX package)."""
    d = _batch(3, 20, 30, seed=45)
    settings = pt.Settings(hybrid_warmup=True, kkt_dtype="float32",
                           mu_min=1e-7, refine_steps=2)
    tp = pt.Problem(**{k: torch.from_numpy(v) for k, v in d.items()})
    cold = pt.solve_batch(tp, settings)
    for compact in (False, True):
        warm = pt.solve_batch(tp, settings, x0=cold.x, y0=cold.y,
                              compact=compact)
        assert torch.all(warm.info.status_val == pt.SOLVED)
        assert warm.x.dtype == torch.float64
        assert torch.all(warm.info.iterations <= cold.info.iterations)
        np.testing.assert_allclose(warm.x.numpy(), cold.x.numpy(), atol=1e-5)
