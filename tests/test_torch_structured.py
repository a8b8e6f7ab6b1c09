"""The PyTorch port's block-angular (scenario-structured) solver
(``qpdo_tpu_torch.solver.structured``, ``operators.BlockAngularOperator``)
against the JAX package's on the CPU, float64, on the problems of
tests/test_structured.py (``_random_bap``).

* ``scale_block_angular``: D, E, the cost scalar and every scaled array
  within 1e-12 relative of JAX's, flattened as the port holds them.
* One Newton solve (the arrow Schur solve) from the same state within
  1e-10 relative of JAX's, and of numpy's dense solve of the assembled K.
* Whole solves (plain, with Ruiz scaling on badly scaled data, at the
  library defaults): JAX's status and iterations, x and y within 1e-8;
  and the port's dense ``solve`` of ``to_dense_problem``: the same
  status and iterations, x within 1e-8.
* A warm start from the cold solution: JAX's iterations, no more than
  cold.
* A primal infeasible problem: JAX's status and certificate within 1e-8.
* The result shapes (batch-first, x as (x0, xs)); without a card the
  default device raises.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.solver import structured as jstructured

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.solver import structured as tstructured

from test_structured import SETTINGS, _random_bap
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TSETTINGS = convert.settings(SETTINGS)
SCALED = qt.Settings(scaling=10, eps_prim_inf=0.0, eps_dual_inf=0.0,
                     max_iter=500)


def _port(p):
    """A JAX BlockAngularProblem as the port's, of numpy copies."""
    return tstructured.BlockAngularProblem(*(np.array(a) for a in p))


def _badly_scaled(seed=21):
    p = _random_bap(seed=seed)
    return p._replace(T=p.T * 1e3, W=p.W * 1e3, l=p.l * 1e3, u=p.u * 1e3)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def test_scaling_matches_jax():
    p = _badly_scaled()
    jop = jstructured.scale_block_angular(p, 10)
    top = tstructured.scale_block_angular(_port(p), 10, device="cpu")
    flat = lambda *parts: np.concatenate([np.asarray(a).ravel()
                                          for a in parts])
    pairs = [(top.D, flat(*jop.D)), (top.Dinv, flat(*jop.Dinv)),
             (top.E, flat(jop.E)), (top.cost, np.asarray(jop.cost)[None]),
             (top.q, flat(*jop.q)), (top.l, flat(jop.l)),
             (top.u, flat(jop.u))]
    pairs += [(getattr(top, k)[0], getattr(jop, k))
              for k in ("Q0", "Qs", "T", "W")]
    for got, ref in pairs:
        assert _rel(got, ref) <= 1e-12


def test_newton_solve_matches_jax_and_the_dense_solve():
    p = _random_bap(S=3, ms=7, n0=4, ns=5, seed=30)
    jop = jstructured.scale_block_angular(p, 10)
    top = tstructured.scale_block_angular(_port(p), 10, device="cpu")
    S, ms, n0, ns = 3, 7, 4, 5
    rng = np.random.default_rng(2)
    active = (rng.random((S, ms)) < 0.5) * 1.0
    mu = 10.0 ** rng.uniform(-4, 0, (S, ms))
    sigma = 1e-3
    r0, rs = rng.standard_normal(n0), rng.standard_normal((S, ns))
    settings = qt.Settings()
    ref = jop.newton_solve(jnp.asarray(active), jnp.asarray(mu),
                           jnp.asarray(sigma),
                           (jnp.asarray(r0), jnp.asarray(rs)), settings)
    ref = np.concatenate([np.asarray(ref[0]), np.asarray(ref[1]).ravel()])
    t = lambda a: torch.from_numpy(np.asarray(a, np.float64).reshape(1, -1))
    rhs = np.concatenate([r0, rs.ravel()])
    got = top.newton_solve(t(active), t(mu), t(sigma).reshape(1), t(rhs),
                           convert.settings(settings))[0].numpy()
    assert _rel(got, ref) <= 1e-10
    # the dense K of the scaled problem: Q + sigma I + A' diag(w) A
    dense = tstructured.to_dense_problem(
        tstructured.BlockAngularProblem(
            top.Q0[0], top.Qs[0], top.q[0, :n0], top.q[0, n0:].reshape(S, ns),
            top.T[0], top.W[0], top.l[0].reshape(S, ms),
            top.u[0].reshape(S, ms), top.c[0]), device="cpu")
    A = dense.A[0].numpy()
    K = (dense.Q[0].numpy() + sigma * np.eye(n0 + S * ns)
         + A.T @ ((active / mu).ravel()[:, None] * A))
    assert _rel(got, np.linalg.solve(K, rhs)) <= 1e-10


@pytest.mark.parametrize("case", ["plain", "scaled", "defaults"])
def test_whole_solve_matches_jax_and_the_dense_solve(case):
    p, settings = {"plain": (_random_bap(), SETTINGS),
                   "scaled": (_badly_scaled(), SCALED),
                   "defaults": (_random_bap(seed=5), qt.Settings())}[case]
    jr = jstructured.solve_block_angular_result(p, settings)
    tp, ts = _port(p), convert.settings(settings)
    tr = tstructured.solve_block_angular_result(tp, ts, device="cpu")
    S, ms, n0, ns = p.shapes
    assert tr.x[0].shape == (1, n0) and tr.x[1].shape == (1, S, ns)
    assert tr.y.shape == (1, S, ms)
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    for a, b in ((tr.x[0], jr.x[0]), (tr.x[1], jr.x[1]), (tr.y, jr.y)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)
    dense = pt.solve(tstructured.to_dense_problem(tp, device="cpu"), ts)
    assert dense.info.status == tr.info.status
    assert int(dense.info.iterations[0]) == int(tr.info.iterations[0])
    x = torch.cat([tr.x[0], tr.x[1].flatten(1)], dim=1)
    np.testing.assert_allclose(x.numpy(), dense.x.numpy(), rtol=0,
                               atol=1e-8)


def test_warm_start_matches_jax():
    p = _random_bap(seed=5)
    x0, xs, y, info = jstructured.solve_block_angular(p, SETTINGS)
    jw = jstructured.solve_block_angular(p, SETTINGS, warm=(x0, xs, y))
    tp = _port(p)
    cold = tstructured.solve_block_angular(tp, TSETTINGS, device="cpu")
    warm = tstructured.solve_block_angular(tp, TSETTINGS, warm=cold[:3],
                                           device="cpu")
    assert warm[3].status == ["solved"]
    assert int(warm[3].iterations[0]) == int(jw[3].iterations)
    assert int(warm[3].iterations[0]) <= int(cold[3].iterations[0])
    np.testing.assert_allclose(warm[1][0].numpy(), np.asarray(jw[1]),
                               rtol=0, atol=1e-8)


def test_primal_infeasible_certificate_matches_jax():
    S, ms, n0, ns = 2, 4, 3, 3
    rng = np.random.default_rng(0)
    T1 = rng.standard_normal((ms // 2, n0))
    W1 = rng.standard_normal((ms // 2, ns))
    T = np.broadcast_to(np.vstack([T1, T1]), (S, ms, n0))
    W = np.broadcast_to(np.vstack([W1, W1]), (S, ms, ns))
    l = np.concatenate([np.full(ms // 2, -np.inf), np.ones(ms // 2)])
    u = np.concatenate([np.zeros(ms // 2), np.full(ms // 2, np.inf)])
    arrays = (np.eye(n0), np.broadcast_to(np.eye(ns), (S, ns, ns)),
              np.zeros(n0), np.zeros((S, ns)), T, W,
              np.broadcast_to(l, (S, ms)), np.broadcast_to(u, (S, ms)),
              np.asarray(0.0))
    settings = qt.Settings(max_iter=200)
    jr = jstructured.solve_block_angular_result(
        jstructured.BlockAngularProblem(*map(jnp.asarray, arrays)), settings)
    tr = tstructured.solve_block_angular_result(
        tstructured.BlockAngularProblem(*(np.array(a) for a in arrays)),
        convert.settings(settings), device="cpu")
    assert int(tr.info.status_val[0]) == int(jr.info.status_val)
    assert int(jr.info.status_val) == qt.PRIMAL_INFEASIBLE
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    np.testing.assert_allclose(tr.prim_inf_cert[0].numpy(),
                               np.asarray(jr.prim_inf_cert), rtol=0,
                               atol=1e-8)
    assert torch.isnan(tr.x[0]).all() and torch.isnan(tr.dual_inf_cert[1]).all()


def test_the_card_is_the_default():
    p = _port(_random_bap())
    assert tstructured.scale_block_angular(p, 0, device="cpu").device.type \
        == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tstructured.solve_block_angular(p, TSETTINGS)
