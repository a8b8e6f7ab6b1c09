"""The banded direct route of the PyTorch port's ``SparseOperator`` (the
block-tridiagonal scan factorization) against the JAX package on the CPU,
float64.

* ``_banded_solve`` with PCG refinement (``banded_pcg_refine=32``, the
  default) and with monotone Richardson sweeps (0) within 1e-10 relative
  of the JAX package's, and of numpy's dense solve of the same K.
* The state-dtype escalation of JAX's
  ``test_banded_escalation_beyond_f32_breakdown`` (``kkt_dtype="float32"``,
  every row at w = 1e9, sigma 1e-7): the float32 block Cholesky breaks
  down and the escalated direction has a relative residual below 1e-5, as
  in the JAX package; without the escalation both packages return the
  zero direction of the NaN guard.
* Whole banded solves (defaults, Richardson, a warm start, a primal
  infeasible problem with its certificate): the JAX package's status and
  iteration count, x and y (or the certificate) within 1e-8.
* ``banded_algo="cr"`` (block cyclic reduction) solves as the scan does
  (status, iterations, x within 1e-8), ``"auto"`` is the scan on a CPU
  tensor, and a sparse solve without ``device=`` runs on the card or
  raises.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.solver import sparse as jsparse

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.solver import sparse as tsparse
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _liswet(n, seed=0):
    """The banded LISWET-style problem of tests/test_sparse.py:268."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    q = -(np.sin(4 * np.pi * t) + 0.1 * rng.standard_normal(n))
    Q = sps.eye(n, format="csr") * (1.0 + 1e-3)
    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.array([0, 1, 2])[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    return Q, q, A, np.zeros(m), np.full(m, np.inf)


def _t(v):
    return torch.from_numpy(np.array(v)).reshape(1, -1)


def _both(data):
    jop = jsparse.setup_sparse(*data)
    top = tsparse.setup_sparse(*data, device="cpu")
    assert top.bd_shape == jop.bd_tmpl.shape and top.bd_shape[1] == 8
    return jop, top


def _dense_K(top, w, sigma):
    n, m = top.n, top.m
    Q = sps.coo_matrix((top.q_data[0].numpy(), top.q_idx.numpy().T),
                       shape=(n, n)).toarray()
    A = sps.coo_matrix((top.a_data[0].numpy(), top.a_idx.numpy().T),
                       shape=(m, n)).toarray()
    return Q + sigma * np.eye(n) + A.T @ (w[:, None] * A)


@pytest.mark.parametrize("refine", [32, 0], ids=["pcg", "richardson"])
def test_banded_solve_matches_jax_and_the_dense_solve(refine):
    jop, top = _both(_liswet(44, seed=3))
    rng = np.random.default_rng(1)
    m, n = top.m, top.n
    mu = 10.0 ** rng.uniform(-6, 0, m)
    w = (rng.random(m) < 0.6) / mu
    sigma, rhs = 1e-4, rng.standard_normal(n)
    settings = qt.Settings(banded_pcg_refine=refine)
    ref = np.asarray(jax.jit(lambda op, *a: op._banded_solve(*a, settings))(
        jop, jnp.asarray(w), jnp.asarray(sigma), jnp.asarray(rhs)))
    got = top._banded_solve(_t(w), _t(sigma).reshape(1), _t(rhs),
                            convert.settings(settings))[0].numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(got, np.linalg.solve(_dense_K(top, w, sigma),
                                                    rhs),
                               rtol=0, atol=1e-9 * scale)


def test_state_dtype_escalation_beyond_the_float32_breakdown():
    jop, top = _both(_liswet(40, seed=7))
    m, n = top.m, top.n
    w, sigma = np.full(m, 1e9), 1e-7
    rhs = np.random.default_rng(3).standard_normal(n)
    s = qt.Settings(kkt_dtype="float32")
    for settings in (s, s.replace(banded_escalate_rtol=0.0)):
        ref = np.asarray(jop._banded_solve(jnp.asarray(w), jnp.asarray(sigma),
                                           jnp.asarray(rhs), settings))
        got = top._banded_solve(_t(w), _t(sigma).reshape(1), _t(rhs),
                                convert.settings(settings))[0].numpy()
        if settings.banded_escalate_rtol == 0:
            assert np.all(ref == 0) and np.all(got == 0)
            continue
        K = _dense_K(top, w, sigma)
        rel = np.linalg.norm(rhs - K @ got) / np.linalg.norm(rhs)
        assert np.any(got != 0) and rel < 1e-5
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("kw", [dict(), dict(banded_pcg_refine=0)],
                         ids=["defaults", "richardson"])
def test_whole_banded_solves_match_jax(kw):
    data = _liswet(60, seed=5)
    settings = qt.Settings(**kw)
    jr = qt.solve_sparse(*data, settings=settings)
    tr = pt.solve_sparse(*data, settings=convert.settings(settings),
                         device="cpu")
    assert tsparse.setup_sparse(*data, device="cpu").newton_exact(
        convert.settings(settings))
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    for a, b in ((tr.x, jr.x), (tr.y, jr.y)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


def test_warm_started_banded_solve_matches_jax():
    Q, q, A, l, u = _liswet(60, seed=5)
    cold = qt.solve_sparse(Q, q, A, l, u)
    q2 = q + 1e-3 * np.random.default_rng(1).standard_normal(q.shape[0])
    x0, y0 = np.asarray(cold.x), np.asarray(cold.y)
    jr = qt.solve_sparse(Q, q2, A, l, u, x0=x0, y0=y0)
    tr = pt.solve_sparse(Q, q2, A, l, u, x0=x0, y0=y0, device="cpu")
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    np.testing.assert_allclose(tr.x[0].numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)


def test_primal_infeasible_banded_problem_and_its_certificate():
    """x_i - x_{i+1} >= 1 and <= -1 on the first pair, a box on every
    variable: banded (b = 8 < n = 24) and primal infeasible."""
    n = 24
    D = sps.csr_matrix(([1.0, -1.0, 1.0, -1.0], ([0, 0, 1, 1], [0, 1, 0, 1])),
                       shape=(2, n))
    A = sps.vstack([D, sps.eye(n)]).tocsr()
    l = np.concatenate([[1.0, -np.inf], -5.0 * np.ones(n)])
    u = np.concatenate([[np.inf, -1.0], 5.0 * np.ones(n)])
    data = (sps.eye(n, format="csr"), np.zeros(n), A, l, u)
    jr = qt.solve_sparse(*data)
    tr = pt.solve_sparse(*data, device="cpu")
    assert tsparse.setup_sparse(*data, device="cpu").bd_shape is not None
    assert int(jr.info.status_val) == qt.PRIMAL_INFEASIBLE
    assert int(tr.info.status_val[0]) == qt.PRIMAL_INFEASIBLE
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    dy = tr.prim_inf_cert[0].numpy()
    np.testing.assert_allclose(dy, np.asarray(jr.prim_inf_cert), rtol=0,
                               atol=1e-8)
    assert np.isnan(tr.x).all()
    # Farkas: A'dy ~ 0 and u'[dy]_+ + l'[dy]_- < 0 on finite bounds
    assert np.abs(A.T @ dy).max() <= 1e-4 * np.abs(dy).max()
    fin = lambda b: np.where(np.isfinite(b), b, 0.0)
    assert fin(u) @ np.maximum(dy, 0) + fin(l) @ np.minimum(dy, 0) < 0


def test_cyclic_reduction_waits_and_the_card_is_the_default():
    data = _liswet(40)
    cr = pt.solve_sparse(*data, settings=pt.Settings(banded_algo="cr"),
                         device="cpu")
    # "auto" is the scan on a CPU tensor, as "scan" is
    a = pt.solve_sparse(*data, settings=pt.Settings(banded_algo="auto"),
                        device="cpu")
    b = pt.solve_sparse(*data, settings=pt.Settings(banded_algo="scan"),
                        device="cpu")
    assert torch.equal(a.x, b.x)
    assert cr.info.status == b.info.status == ["solved"]
    assert int(cr.info.iterations[0]) == int(b.info.iterations[0])
    np.testing.assert_allclose(cr.x.numpy(), b.x.numpy(), rtol=0, atol=1e-8)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pt.solve_sparse(*data)
