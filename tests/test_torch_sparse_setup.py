"""The PyTorch port's sparse setup (``solver/sparse.py``), the
``SparseOperator`` matvecs and ``ops/linalg.cholesky_solve`` against the
JAX package on the CPU, float64.

* ``setup_sparse``: D, E, the cost scalar, the scaled q, l, u, the triplet
  data and diag(Q) within 1e-12 relative of the JAX package's, for A-only
  Ruiz, ``ruiz_kkt`` and no scaling; a batch of one pattern
  (``setup_sparse_batch``) equals its problems set up one by one.
* The block-Jacobi, coarse-grid and banded index maps equal the JAX
  package's element for element (the banded block geometry (nb, b) is the
  shape of the JAX package's template array), and the pair cap turns them
  off on a dense row as in the JAX package.
* The matvecs within 1e-12 of scipy's on the scaled data.
* The triplet helpers (``_as_triplets``, ``union_triplets`` with
  duplicates, ``pad_sparse_problem``) give the JAX package's arrays.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from qpdo_tpu.ops import linalg as jlinalg
from qpdo_tpu.solver import sparse as jsparse

from qpdo_tpu_torch.ops import linalg as tlinalg
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


def _random_sparse(n=50, m=40, seed=1):
    rng = np.random.default_rng(seed)
    B = sps.random(n, n, density=0.08, random_state=seed, format="csr")
    Q = (B.T @ B + 0.2 * sps.eye(n)).tocsr()
    A = sps.random(m, n, density=0.15, random_state=seed + 1, format="csr")
    A.data[:] = 10.0 ** rng.uniform(-2, 2, A.nnz) * rng.standard_normal(A.nnz)
    l = np.where(rng.random(m) < 0.2, -np.inf, -rng.random(m))
    return Q, 5 * rng.standard_normal(n), A, l, rng.random(m) + 0.1


FLOAT_FIELDS = ("q_data", "a_data", "diagQ", "q", "l", "u", "D", "Dinv",
                "E", "Einv", "cost", "cinv", "l_finite", "u_finite")


def _close(got, ref, rtol=1e-12):
    ref = np.asarray(ref)
    scale = max(1.0, np.abs(ref).max()) if ref.size else 1.0
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rtol * scale)


@pytest.mark.parametrize("kw", [dict(), dict(ruiz_kkt=True),
                                dict(scaling_iters=0)],
                         ids=["ruiz", "ruiz_kkt", "unscaled"])
def test_setup_sparse_matches_jax(kw):
    Q, q, A, l, u = _random_sparse()
    jop = jsparse.setup_sparse(Q, q, A, l, u, 0.5, **kw)
    top = tsparse.setup_sparse(Q, q, A, l, u, 0.5, device="cpu", **kw)
    assert top.batch == 1 and top.dtype == torch.float64
    for f in FLOAT_FIELDS:
        _close(getattr(top, f)[0], getattr(jop, f))
    assert float(top.c[0]) == float(jop.c)
    np.testing.assert_array_equal(top.q_idx.numpy(), np.asarray(jop.q_idx))
    np.testing.assert_array_equal(top.a_idx.numpy(), np.asarray(jop.a_idx))


def _maps_equal(got, ref):
    if ref is None:
        assert got is None
        return
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_preconditioner_and_banded_maps_match_jax():
    for data, block in ((_random_sparse(), 16), (_random_sparse(60, 45, 7), 8),
                        (_liswet(40), 8)):
        Q, q, A, l, u = data
        jop = jsparse.setup_sparse(Q, q, A, l, u, precond_block=block)
        top = tsparse.setup_sparse(Q, q, A, l, u, precond_block=block,
                                   device="cpu")
        for f in ("pjA", "pjQ", "pcA", "pcQ", "bdA", "bdAsub", "bdQ",
                  "bdQsub"):
            _maps_equal(getattr(top, f), getattr(jop, f))
        np.testing.assert_array_equal(top.pc_counts.numpy(),
                                      np.asarray(jop.pc_counts))
        if jop.bd_tmpl is None:
            assert top.bd_shape is None
        else:
            assert top.bd_shape == jop.bd_tmpl.shape
    # the LISWET pattern is banded, the random ones are not
    assert tsparse.setup_sparse(*_liswet(40), device="cpu").bd_shape == (5, 8)
    # a dense row exceeds the pair cap of the coarse and banded maps (the
    # block-Jacobi pairs stay within their blocks)
    Q, q, A, l, u = _liswet(200)
    A = sps.vstack([A, sps.csr_matrix(np.ones((1, 200)))]).tocsr()
    l, u = np.append(l, -1.0), np.append(u, 1.0)
    jop = jsparse.setup_sparse(Q, q, A, l, u, precond_block=64)
    top = tsparse.setup_sparse(Q, q, A, l, u, precond_block=64, device="cpu")
    _maps_equal(top.pjA, jop.pjA)
    assert jop.pcA is None and top.pcA is None and top.pc_counts is None
    assert top.bd_shape is None and jop.bd_tmpl is None


def test_matvecs_match_scipy():
    Q, q, A, l, u = _random_sparse()
    op = tsparse.setup_sparse(Q, q, A, l, u, device="cpu")
    n, m = op.n, op.m
    Qs = sps.coo_matrix((op.q_data[0].numpy(), op.q_idx.numpy().T),
                        shape=(n, n))
    As = sps.coo_matrix((op.a_data[0].numpy(), op.a_idx.numpy().T),
                        shape=(m, n))
    rng = np.random.default_rng(5)
    x, xb = rng.standard_normal((2, n))
    y, yb = rng.standard_normal((2, m))
    t = lambda v: torch.from_numpy(v)[None]
    _close(op.Qmv(t(x))[0], Qs @ x)
    _close(op.Amv(t(x))[0], As @ x)
    _close(op.Atmv(t(y))[0], As.T @ y)
    for pair, M, a, b in ((op.Qmv2, Qs, x, xb), (op.Amv2, As, x, xb),
                          (op.Atmv2, As.T, y, yb)):
        va, vb = pair(t(a), t(b))
        _close(va[0], M @ a)
        _close(vb[0], M @ b)
    active = (rng.random(m) < 0.5).astype(float)
    mu = 10.0 ** rng.uniform(-3, 0, m)
    K = (Qs + As.T @ sps.diags(active / mu) @ As).toarray() + 0.3 * np.eye(n)
    d = op.diag_K(t(active), t(mu), torch.tensor([0.3], dtype=torch.float64),
                  True)
    _close(d[0], np.diag(K))
    # a reduced-precision product comes back in the state dtype
    lo = op.Amv(t(x), dtype="float32")
    assert lo.dtype == torch.float64
    np.testing.assert_allclose(lo[0].numpy(), As @ x, rtol=1e-5, atol=1e-5)


def test_a_batch_of_one_pattern_equals_its_problems_set_up_alone():
    Q, q, A, l, u = _random_sparse()
    rng = np.random.default_rng(9)
    probs = []
    for _ in range(3):
        Qb, Ab = Q.copy(), A.copy()
        Qb.data = Qb.data * (1 + rng.random())
        Ab.data = Ab.data * (1 + 0.5 * rng.standard_normal(Ab.nnz))
        probs.append((Qb, rng.standard_normal(q.shape[0]), Ab, l, u))
    st = lambda xs: torch.from_numpy(np.stack(xs))
    trips = [(tsparse._as_triplets(p[0], None), tsparse._as_triplets(p[2],
                                                                     None))
             for p in probs]
    op = tsparse.setup_sparse_batch(
        st([t[0][0] for t in trips]), trips[0][0][1],
        st([t[1][0] for t in trips]), trips[0][1][1], st([p[1] for p in probs]),
        st([p[3] for p in probs]), st([p[4] for p in probs]),
        torch.zeros(3, dtype=torch.float64), A.shape[0])
    for k, p in enumerate(probs):
        one = tsparse.setup_sparse(*p, device="cpu")
        for f in FLOAT_FIELDS:
            assert torch.equal(getattr(op, f)[k], getattr(one, f)[0]), f
        for f in ("pjA", "bdA"):
            _maps_equal(getattr(op, f), getattr(one, f))


def test_triplet_helpers_match_jax():
    Q, q, A, l, u = _random_sparse(20, 15, 3)
    dense = A.toarray()
    for M in (A, dense, torch.from_numpy(dense)):
        d, i, s = tsparse._as_triplets(M, None)
        jd, ji, js = jsparse._as_triplets(A, jnp.float64)
        np.testing.assert_array_equal(d, np.asarray(jd))
        np.testing.assert_array_equal(i, np.asarray(ji))
        assert tuple(s) == tuple(js)
    dup = (np.array([1.0, 2.0, 5.0]), np.array([[0, 0], [0, 0], [1, 1]]),
           (2, 2))
    other = sps.csr_matrix(np.array([[0.0, 7.0], [0.0, 0.0]]))
    for mats in ([dup, other], [A, sps.random(15, 20, density=0.3,
                                              random_state=8, format="csr")]):
        td, ti, ts = tsparse.union_triplets(mats, torch.float64)
        jd, ji, js = jsparse.union_triplets(mats, jnp.float64)
        np.testing.assert_array_equal(ti, np.asarray(ji))
        for a, b in zip(td, jd):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert tuple(ts) == tuple(js)
    got = tsparse.pad_sparse_problem((Q, q, A, l, u), 26, 19, torch.float64)
    ref = jsparse.pad_sparse_problem((Q, q, A, l, u), 26, 19, jnp.float64)
    for g, r in ((got[0][0], ref[0][0]), (got[0][1], ref[0][1]),
                 (got[1], ref[1]), (got[2][0], ref[2][0]),
                 (got[2][1], ref[2][1]), (got[3], ref[3]), (got[4], ref[4])):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert got[0][2] == ref[0][2] and got[2][2] == ref[2][2]


def test_cholesky_solve_matches_jax():
    rng = np.random.default_rng(4)
    B, n = 3, 12
    M = rng.standard_normal((B, n, n))
    K = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(n)
    rhs, R = rng.standard_normal((B, n)), rng.standard_normal((B, n, 4))
    for steps in (0, 2):
        for b in (rhs, R):
            ref = np.stack([np.asarray(jlinalg.cholesky_solve(
                jnp.asarray(K[i]), jnp.asarray(b[i]), steps))
                for i in range(B)])
            got = tlinalg.cholesky_solve(torch.from_numpy(K),
                                         torch.from_numpy(b), steps)
            _close(got, ref, 1e-10)
            _close(got, np.linalg.solve(K, b if b.ndim == 3 else b[..., None])
                   .reshape(b.shape), 1e-8)
