"""The CG route of the PyTorch port's ``SparseOperator`` against the JAX
package on the CPU, float64.

* One ``newton_solve`` from a fixed state (penalties in [1e-3, 1], half
  the rows active, sigma 1e-4) with the block-Jacobi preconditioner and
  its coarse level, block-Jacobi alone, Jacobi, and ``cg_dtype="float32"``
  (mixed-precision ``pcg_refined``): within 1e-10 relative of the JAX
  package's direction.  CG runs there to a relative residual of 1e-13, so
  the system, not the iteration's rounding, fixes the direction.
* Whole solves at the defaults on a dense pattern and a random sparse
  one, and with ``newton_direct=False`` on a banded one: the JAX package's
  status and iteration count, x and y within 1e-8.  With ``cg_dtype``
  float32 the inner CG runs in float32 to a loose tolerance and its
  iterate moves with rounding (on random_qp(40, 30) the two packages'
  counts differ by one), so that solve is held to the JAX package's own
  acceptance instead: SOLVED, the oracle at 1e-6, x within 1e-5 of JAX's.
* ``verbose`` and ``max_time`` go through the host-driven loop.
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

from utils import kkt_residuals, random_qp
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


def _random_sparse(n=48, m=36, seed=11):
    rng = np.random.default_rng(seed)
    B = sps.random(n, n, density=0.08, random_state=seed, format="csr")
    Q = (B.T @ B + 0.3 * sps.eye(n)).tocsr()
    A = sps.random(m, n, density=0.12, random_state=seed + 1, format="csr")
    A = (A + sps.csr_matrix((rng.standard_normal(m),
                             (np.arange(m), rng.integers(0, n, m))),
                            shape=(m, n))).tocsr()
    return Q, rng.standard_normal(n), A, -rng.random(m), rng.random(m)


@pytest.fixture(scope="module")
def pair():
    """One random sparse problem set up by both packages (precond_block 16,
    so that block-Jacobi has three blocks and a coarse level)."""
    Q, q, A, l, u = _random_sparse()
    jop = jsparse.setup_sparse(Q, q, A, l, u, precond_block=16)
    top = tsparse.setup_sparse(Q, q, A, l, u, precond_block=16, device="cpu")
    rng = np.random.default_rng(3)
    m, n = A.shape
    state = dict(active=(rng.random(m) < 0.5).astype(float),
                 mu=10.0 ** rng.uniform(-3, 0, m), sigma=np.array(1e-4),
                 rhs=rng.standard_normal(n),
                 dx_prev=0.1 * rng.standard_normal(n))
    assert top.pjA is not None and top.pcA is not None
    return jop, top, state


@pytest.mark.parametrize("kw", [
    dict(), dict(precond_two_level=False), dict(precond="jacobi"),
    dict(cg_dtype="float32", cg_refine_rounds=12),
], ids=["two_level", "block_jacobi", "jacobi", "cg_float32"])
def test_newton_solve_matches_jax(pair, kw):
    jop, top, st = pair
    settings = qt.Settings(cg_tol=1e-13, cg_max_iter=400, precond_block=16,
                           **kw)
    j = jax.jit(lambda op, a, mu, s, r, d: op.newton_solve(
        a, mu, s, r, settings, dx_prev=d))
    ref = np.asarray(j(jop, *(jnp.asarray(st[k]) for k in
                              ("active", "mu", "sigma", "rhs", "dx_prev"))))
    t = lambda v: torch.from_numpy(np.array(v)).reshape(1, -1)
    got = top.newton_solve(t(st["active"]), t(st["mu"]),
                           t(st["sigma"]).reshape(1), t(st["rhs"]),
                           convert.settings(settings),
                           dx_prev=t(st["dx_prev"]))
    assert got.shape == (1, top.n) and torch.isfinite(got).all()
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def _dense_pattern(n=40, m=30):
    Q, q, A, l, u = random_qp(n, m, seed=0)
    return sps.csr_matrix(Q), q, sps.csr_matrix(A), l, u


@pytest.mark.parametrize("make,kw", [
    (_dense_pattern, {}), (_random_sparse, {}),
    (lambda: _liswet(60, 5), dict(newton_direct=False)),
], ids=["dense_pattern", "random_sparse", "banded_by_cg"])
def test_whole_solves_match_jax(make, kw):
    data = make()
    settings = qt.Settings(**kw)
    jr = qt.solve_sparse(*data, settings=settings)
    tr = pt.solve_sparse(*data, settings=convert.settings(settings),
                         device="cpu")
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    np.testing.assert_allclose(tr.x[0].numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.y[0].numpy(), np.asarray(jr.y), rtol=0,
                               atol=1e-8)
    if kw:
        op = tsparse.setup_sparse(*data, device="cpu")
        assert op.bd_shape is not None
        assert not op.newton_exact(convert.settings(settings))


def test_mixed_precision_cg_solve_meets_the_jax_acceptance():
    Q, q, A, l, u = _dense_pattern(24, 18)
    settings = qt.Settings(cg_dtype="float32")
    jr = qt.solve_sparse(Q, q, A, l, u, settings=settings)
    tr = pt.solve_sparse(Q, q, A, l, u, settings=convert.settings(settings),
                         device="cpu")
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    rp, rd = kkt_residuals(Q.toarray(), q, A.toarray(), l, u,
                           tr.x[0].numpy(), tr.y[0].numpy())
    assert rp <= 1e-6 and rd <= 1e-6
    np.testing.assert_allclose(tr.x[0].numpy(), np.asarray(jr.x), atol=1e-5)


def test_verbose_and_max_time_take_the_host_driven_loop(capsys):
    Q, q, A, l, u = _dense_pattern()
    plain = pt.solve_sparse(Q, q, A, l, u, device="cpu")
    loud = pt.solve_sparse(Q, q, A, l, u, settings=pt.Settings(verbose=True),
                           device="cpu")
    out = capsys.readouterr().out
    assert "iter" in out.lower() and "CPU" in out
    assert int(loud.info.iterations[0]) == int(plain.info.iterations[0])
    assert torch.equal(loud.x, plain.x)
    capped = pt.solve_sparse(Q, q, A, l, u, device="cpu",
                             settings=pt.Settings(eps_abs=1e-14,
                                                  max_time=1e-9))
    assert int(capped.info.status_val[0]) == pt.MAX_TIME_REACHED
