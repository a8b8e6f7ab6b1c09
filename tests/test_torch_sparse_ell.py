"""The ELL (padded-row gather) matvecs of the PyTorch port's
``SparseOperator`` against the JAX package and against the scatter
matvecs, on the CPU, float64.

``setup_sparse`` builds the ELL maps only where the operator's device is
not the CPU (the JAX package's ``backend != "cpu"`` rule), so here the
tests attach the maps of ``solver.sparse._ell_maps`` to a CPU operator.

* The maps equal JAX's ``_ell_maps`` for each direction (Q, A, A') of
  random patterns with an empty row and an empty column.
* Every matvec (Qmv, Amv, Atmv, the paired ones, diag_K, a float32
  product) through ELL within 1e-14 of the scatter's, relative to the
  largest entry (the row sums add in another order).
* A pattern wider than the cap (128) or padded beyond ``pad_factor`` x
  nnz gets no map (None), an empty pattern none either, and the scatter
  takes that direction.
* A whole CG-route solve through ELL: the scatter operator's status,
  the oracle at 1e-6 and x within 1e-5 of the scatter's solve.  The row
  sums add in another order, and a CG iterate moves with rounding, so
  this is the JAX package's own contract for its ELL solve
  (tests/test_sparse.py:test_ell_end_to_end_solve: the oracle), with the
  band the port holds other rounding-moved CG solves to.
* On the CPU, ``setup_sparse`` builds no ELL map.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from qpdo_tpu.solver import sparse as jsparse

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.solver import core
from qpdo_tpu_torch.solver import sparse as tsparse
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _problem(n, m, seed):
    rng = np.random.default_rng(seed)
    Bm = sps.random(n, n, density=0.1, random_state=seed, format="csr")
    Q = (Bm.T @ Bm + 0.5 * sps.eye(n)).tocsr()
    A = sps.random(m, n, density=0.15, random_state=100 + seed,
                   format="lil")
    A[rng.integers(0, m)] = 0.0           # an empty row
    A[:, rng.integers(0, n)] = 0.0        # an empty column
    A = A.tocsr()
    A.eliminate_zeros()
    return (Q, rng.standard_normal(n), A, -rng.random(m) - 0.1,
            rng.random(m) + 0.1)


def _directions(op):
    qi, ai = op.q_idx.numpy(), op.a_idx.numpy()
    return {"ellQ": (qi[:, 0], qi[:, 1], op.n),
            "ellA": (ai[:, 0], ai[:, 1], op.m),
            "ellAt": (ai[:, 1], ai[:, 0], op.n)}


def _with_ell(op):
    maps = {k: tsparse._ell_maps(*v) for k, v in _directions(op).items()}
    assert all(v is not None for v in maps.values())
    return op._replace(**{k: tsparse._on(v, op.device)
                          for k, v in maps.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_ell_maps_equal_jax(seed):
    op = tsparse.setup_sparse(*_problem(60 + 20 * seed, 45, seed),
                              device="cpu")
    for name, args in _directions(op).items():
        got = tsparse._ell_maps(*args)
        ref = jsparse._ell_maps(*args)
        for a, b in zip(got, ref):
            assert np.array_equal(a, np.asarray(b)), name
        assert got[2].dtype == np.int8


def test_ell_matvecs_match_the_scatter():
    op = tsparse.setup_sparse(*_problem(80, 60, 2), device="cpu")
    ell = _with_ell(op)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, op.n)))
    y = torch.from_numpy(rng.standard_normal((1, op.m)))
    act = torch.from_numpy((rng.random((1, op.m)) < 0.5) * 1.0)
    mu = torch.from_numpy(rng.random((1, op.m)) + 0.1)
    sigma = torch.full((1,), 0.3, dtype=torch.float64)

    def close(a, b, tol=1e-14):
        scale = max(1.0, b.abs().max().item())
        assert (a - b).abs().max().item() <= tol * scale

    close(ell.Qmv(x), op.Qmv(x))
    close(ell.Amv(x), op.Amv(x))
    close(ell.Atmv(y), op.Atmv(y))
    for f, v in (("Qmv2", x), ("Amv2", x), ("Atmv2", y)):
        for a, b in zip(getattr(ell, f)(v, -2 * v), getattr(op, f)(v, -2 * v)):
            close(a, b)
    close(ell.diag_K(act, mu, sigma, True), op.diag_K(act, mu, sigma, True))
    # a float32 product: float32 data and vector, cast back
    close(ell.Amv(x, dtype="float32"), op.Amv(x, dtype="float32"), 1e-6)
    assert ell.Amv(x, dtype="float32").dtype == torch.float64


def test_irregular_patterns_get_no_map():
    n = 300
    dense_row = np.concatenate([np.zeros(n, np.int64), np.arange(1, 20)])
    cols = np.concatenate([np.arange(n), np.arange(1, 20)])
    # a row of 300 entries: K = 300 > cap_width 128
    assert tsparse._ell_maps(dense_row, cols, 20) is None
    assert jsparse._ell_maps(dense_row, cols, 20) is None
    # 120 entries in one of 1,000 rows: 1,000 x 120 > 8 x nnz + rows
    skew = np.concatenate([np.zeros(120, np.int64), np.arange(1, 200)])
    assert tsparse._ell_maps(skew, skew, 1000) is None
    assert tsparse._ell_maps(np.zeros(0, np.int64), np.zeros(0), 5) is None
    # the scatter then takes the direction
    A = sps.csr_matrix((np.ones(n), (np.zeros(n, int), np.arange(n))),
                       shape=(3, n))
    data = (sps.eye(n, format="csr"), np.zeros(n), A, -np.ones(3),
            np.ones(3))
    op = tsparse.setup_sparse(*data, device="cpu")
    ai = op.a_idx.numpy()
    assert tsparse._ell_maps(ai[:, 0], ai[:, 1], 3) is None
    at = tsparse._ell_maps(ai[:, 1], ai[:, 0], n)
    ell = op._replace(ellAt=tsparse._on(at, "cpu"))
    x = torch.randn((1, n), dtype=torch.float64)
    assert torch.equal(ell.Amv(x), op.Amv(x))


def test_whole_solve_through_ell_matches_the_scatter():
    Q, q, A, l, u = data = _problem(60, 45, 3)
    op = tsparse.setup_sparse(*data, device="cpu")
    settings = pt.Settings()
    ref = core.solve_scaled(op, settings)
    got = core.solve_scaled(_with_ell(op), settings)
    assert got.info.status == ref.info.status == ["solved"]
    x, y = got.x[0].numpy(), got.y[0].numpy()
    Ax = A @ x
    assert np.abs(Ax - np.clip(Ax + y, l, u)).max() <= 1e-6
    assert np.abs(Q @ x + q + A.T @ y).max() <= 1e-6
    np.testing.assert_allclose(x, ref.x[0].numpy(), rtol=0, atol=1e-5)


def test_no_ell_maps_on_the_cpu():
    op = tsparse.setup_sparse(*_problem(50, 40, 4), device="cpu")
    assert op.ellQ is None and op.ellA is None and op.ellAt is None
