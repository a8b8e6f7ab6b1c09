"""The PyTorch port's sparse fleets (``solve_sparse_batch``,
``solve_sparse_heterogeneous``) on the CPU, float64.

One ``SparseOperator`` holds a fleet: float leaves stacked along the
batch, index maps shared, every reduction per problem.  So a fleet's
problems take exactly the steps they take alone:

* a same-pattern fleet equals its per-problem solves (x, y within 1e-12)
  and the JAX package's per-problem status and iterations; a banded fleet
  likewise;
* a fleet of mixed patterns, put on the union pattern, equals its
  per-problem solves (x, y within 1e-8), with the JAX package's statuses
  and iterations;
* a warm-started fleet takes the JAX package's warm iterations;
* a fleet of mixed sizes (padded, then the union) gives the JAX package's
  ``solve_sparse_heterogeneous`` statuses and iterations, x within 1e-8,
  each result a batch of one at its own sizes;
* ``mesh=`` over a mesh of one rank changes nothing.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import qpdo_tpu as qt

import qpdo_tpu_torch as pt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _fleet(B, n=36, m=28, seed=0, same=True):
    rng = np.random.default_rng(seed)
    pat_Q = sps.random(n, n, density=0.15, random_state=seed, format="csr")
    pat_A = sps.random(m, n, density=0.2, random_state=seed + 1,
                       format="csr")
    probs = []
    for b in range(B):
        if same:
            Bm, Ab = pat_Q.copy(), pat_A.copy()
            Bm.data = Bm.data * (1.0 + 0.1 * rng.random(Bm.nnz))
        else:
            Bm = sps.random(n, n, density=0.08 + 0.04 * b,
                            random_state=100 + b, format="csr")
            Ab = sps.random(m, n, density=0.15 + 0.05 * b,
                            random_state=200 + b, format="csr")
        Ab.data = rng.standard_normal(Ab.nnz)
        Q = (Bm.T @ Bm + 0.3 * sps.eye(n)).tocsr()
        probs.append((Q, rng.standard_normal(n), Ab, -np.ones(m), np.ones(m)))
    return probs


def _liswet(n, seed):
    rng = np.random.default_rng(seed)
    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.array([0, 1, 2])[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    return (sps.eye(n, format="csr") * (1.0 + rng.random()),
            rng.standard_normal(n), A, np.zeros(m), np.full(m, np.inf))


def _singles(probs, **kw):
    return [pt.solve_sparse(*p, device="cpu", **kw) for p in probs]


def _match_singles(res, singles, atol):
    for b, one in enumerate(singles):
        assert int(res.info.status_val[b]) == int(one.info.status_val[0])
        assert int(res.info.iterations[b]) == int(one.info.iterations[0])
        np.testing.assert_allclose(res.x[b].numpy(), one.x[0].numpy(),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(res.y[b].numpy(), one.y[0].numpy(),
                                   rtol=0, atol=atol)


def _match_jax(res, probs, **kw):
    for b, p in enumerate(probs):
        jr = qt.solve_sparse(*p, **kw)
        assert int(res.info.status_val[b]) == int(jr.info.status_val)
        assert int(res.info.iterations[b]) == int(jr.info.iterations)


def test_same_pattern_fleet_equals_its_problems_alone():
    probs = _fleet(3)
    res = pt.solve_sparse_batch(probs, device="cpu")
    assert res.x.shape == (3, 36) and res.y.shape == (3, 28)
    assert (res.info.status_val == pt.SOLVED).all()
    _match_singles(res, _singles(probs), 1e-12)
    _match_jax(res, probs)


def test_banded_fleet_equals_its_problems_alone():
    probs = [_liswet(24, seed=100 + s) for s in range(3)]
    res = pt.solve_sparse_batch(probs, device="cpu")
    assert (res.info.status_val == pt.SOLVED).all()
    _match_singles(res, _singles(probs), 1e-12)


def test_mixed_patterns_go_through_the_union():
    probs = _fleet(3, seed=33, same=False)
    assert len({p[0].nnz for p in probs}) > 1
    res = pt.solve_sparse_batch(probs, device="cpu")
    assert (res.info.status_val == pt.SOLVED).all()
    _match_singles(res, _singles(probs), 1e-8)
    _match_jax(res, probs)


def test_warm_started_fleet_takes_the_jax_iterations():
    probs = _fleet(3, seed=21)
    cold = pt.solve_sparse_batch(probs, device="cpu")
    moved = [(p[0], p[1] + 0.01, *p[2:]) for p in probs]
    x0, y0 = cold.x.numpy(), cold.y.numpy()
    warm = pt.solve_sparse_batch(moved, x0=x0, y0=y0, device="cpu")
    assert (warm.info.status_val == pt.SOLVED).all()
    for b, p in enumerate(moved):
        jr = qt.solve_sparse(*p, x0=x0[b], y0=y0[b])
        assert int(warm.info.status_val[b]) == int(jr.info.status_val)
        assert int(warm.info.iterations[b]) == int(jr.info.iterations)
        np.testing.assert_allclose(warm.x[b].numpy(), np.asarray(jr.x),
                                   rtol=0, atol=1e-8)


def test_heterogeneous_fleet_matches_jax():
    rng = np.random.default_rng(55)
    probs = []
    for i, (n, m) in enumerate([(20, 14), (33, 25), (27, 40)]):
        Bm = sps.random(n, n, density=0.2, random_state=700 + i,
                        format="csr")
        A = sps.random(m, n, density=0.3, random_state=800 + i, format="csr")
        A = A + sps.csr_matrix((rng.standard_normal(m),
                                (np.arange(m), rng.integers(0, n, m))),
                               shape=(m, n))
        probs.append(((Bm.T @ Bm + 0.4 * sps.eye(n)).tocsr(),
                      rng.standard_normal(n), A, -np.ones(m), np.ones(m)))
    got = pt.solve_sparse_heterogeneous(probs, device="cpu")
    ref = qt.solve_sparse_heterogeneous(probs)
    assert len(got) == 3
    for p, g, r in zip(probs, got, ref):
        n, m = p[1].shape[0], p[3].shape[0]
        assert g.x.shape == (1, n) and g.y.shape == (1, m)
        assert int(g.info.status_val[0]) == int(r.info.status_val) == \
            qt.SOLVED
        assert int(g.info.iterations[0]) == int(r.info.iterations)
        np.testing.assert_allclose(g.x[0].numpy(), np.asarray(r.x), rtol=0,
                                   atol=1e-8)


def test_mesh_waits_for_the_distributed_slice():
    """``mesh=``, ported since (tests/test_torch_serve_mesh.py holds it
    over 2 ranks against JAX): over a mesh of one rank a fleet is solved
    as without it, its leaves DTensors of the whole fleet."""
    from torch_dist import one_rank_mesh

    fleet = _fleet(2)
    ref = pt.solve_sparse_batch(fleet, device="cpu")
    with one_rank_mesh("batch") as mesh:
        res = pt.solve_sparse_batch(fleet, mesh=mesh, device="cpu")
        het = pt.solve_sparse_heterogeneous(fleet, mesh=mesh, device="cpu")
        assert res.x.shape == ref.x.shape
        np.testing.assert_array_equal(res.x.to_local().numpy(),
                                      ref.x.numpy())
    for b, one in enumerate(het):
        np.testing.assert_array_equal(one.x[0].numpy(), ref.x[b].numpy())
