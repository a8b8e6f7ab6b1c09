"""Block cyclic reduction of the PyTorch port's banded route
(``SparseOperator._banded_factor_cr`` and the CR branch of
``_banded_solve``) against the JAX package on the CPU, float64.

* The factor-and-solve against JAX's ``_banded_factor_cr`` within 1e-12
  relative, per problem of a batch of two, for nb in {1, 2, 3, 7, 8}
  (odd and even block counts at every level, one block, a power of two)
  at full depth and at ``max_levels`` = 2 (the scan finishes the coarse
  remainder), and against numpy's dense solve.
* A whole ``solve_sparse(banded_algo="cr")``: JAX's status and
  iterations, x and y within 1e-8.
* The accuracy-gated scan fallback on a float32 factor at
  ``mu_min=1e-9`` (the problem of JAX's
  ``test_cr_gated_fallback_survives_level704_conditioning`` at n=200):
  the fallback re-solves with the scan factor, and the solve ends SOLVED
  in JAX's iterations within the oracle; with the gate compiled out
  (``robust_gate_auto`` at mu_min >= 1e-6) no fallback runs.
* ``banded_algo="auto"`` is the scan on a CPU tensor.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.operators import SparseOperator as JSparseOperator

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert, operators
from qpdo_tpu_torch.operators import SparseOperator
from qpdo_tpu_torch.solver.sparse import setup_sparse

from test_sparse import _liswet as liswet_from_data
from test_torch_sparse_banded import _liswet
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B_SIZE = 3


def _block_tridiagonal(batch, nb, b, seed):
    """SPD block-tridiagonal matrices of a batch: (K, D, E)."""
    rng = np.random.default_rng(seed)
    n = nb * b
    blk = np.arange(n) // b
    band = np.abs(blk[:, None] - blk[None, :]) <= 1
    M = rng.standard_normal((batch, n, n)) * band
    K = (M @ M.transpose(0, 2, 1)) * band + n * np.eye(n)
    cut = lambda i, j: K[:, i * b:(i + 1) * b, j * b:(j + 1) * b]
    D = np.stack([cut(k, k) for k in range(nb)], axis=1)
    E = (np.stack([cut(k + 1, k) for k in range(nb - 1)], axis=1) if nb > 1
         else np.zeros((batch, 1, b, b)))
    return K, D, E


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 8])
def test_cr_factor_solve_matches_jax(nb):
    K, D, E = _block_tridiagonal(2, nb, B_SIZE, seed=nb)
    r = np.random.default_rng(100 + nb).standard_normal((2, nb, B_SIZE))
    exact = np.linalg.solve(K, r.reshape(2, -1, 1))[..., 0]
    for levels in (0, 2):
        got = SparseOperator._banded_factor_cr(
            torch.from_numpy(D), torch.from_numpy(E), levels)(
                torch.from_numpy(r)).numpy()
        ref = np.stack([np.asarray(JSparseOperator._banded_factor_cr(
            jnp.asarray(D[i]), jnp.asarray(E[i]), levels)(jnp.asarray(r[i])))
            for i in range(2)])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(got.reshape(2, -1), exact, rtol=0,
                                   atol=1e-12 * scale)


def test_whole_cr_solve_matches_jax():
    data = _liswet(90, seed=11)
    settings = qt.Settings(banded_algo="cr")
    jr = qt.solve_sparse(*data, settings=settings)
    tr = pt.solve_sparse(*data, settings=convert.settings(settings),
                         device="cpu")
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    for a, b in ((tr.x, jr.x), (tr.y, jr.y)):
        np.testing.assert_allclose(a[0].numpy(), np.asarray(b), rtol=0,
                                   atol=1e-8)


def _float32_scan_calls(monkeypatch):
    """Count the scan factorizations of a float32 factor: the CR
    fallback's (the state-dtype escalation factors in float64)."""
    calls = []
    scan = SparseOperator._banded_factor_scan

    def counting(D, E):
        if D.dtype == torch.float32:
            calls.append(D.shape)
        return scan(D, E)

    monkeypatch.setattr(operators.SparseOperator, "_banded_factor_scan",
                        staticmethod(counting))
    return calls


def _level704_problem(n):
    rng = np.random.default_rng(42)
    t = np.linspace(0, 1, n)
    d = np.sin(4 * np.pi * t) + 0.1 * rng.standard_normal(n)
    return liswet_from_data(n, d)


def test_cr_fallback_fires_on_a_float32_factor(monkeypatch):
    Q, q, A, l, u = data = _level704_problem(200)
    settings = qt.Settings(eps_abs=1e-6, max_iter=3000, inner_max_iter=100,
                           eps_abs_in=0.1, rho=0.2, delta=1e-4, theta=0.9,
                           kkt_dtype="float32", mu_min=1e-9, refine_steps=3,
                           banded_algo="cr")
    calls = _float32_scan_calls(monkeypatch)
    tr = pt.solve_sparse(*data, settings=convert.settings(settings),
                         device="cpu")
    assert len(calls) > 0
    jr = qt.solve_sparse(*data, settings=settings)
    assert int(tr.info.status_val[0]) == int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    x, y = tr.x[0].numpy(), tr.y[0].numpy()
    Ax = A @ x
    assert np.abs(Ax - np.clip(Ax + y, l, u)).max() <= 1e-6
    assert np.abs(Q @ x + q + A.T @ y).max() <= 1e-6


def test_cr_fallback_is_compiled_out_above_its_mu_floor(monkeypatch):
    """robust_gate_auto at mu_min >= 1e-6 leaves the fallback out even on
    a float32 factor whose residual fails the gate (operators.py:1321-1323
    of the JAX package, mirrored); robust_gate_auto=False keeps it."""
    op = setup_sparse(*_liswet(40, seed=7), device="cpu")
    m, n = op.m, op.n
    w = torch.full((1, m), 1e9, dtype=torch.float64)
    sigma = torch.full((1,), 1e-7, dtype=torch.float64)
    rhs = torch.from_numpy(np.random.default_rng(3).standard_normal((1, n)))
    base = pt.Settings(kkt_dtype="float32", mu_min=1e-5, banded_algo="cr",
                       banded_cr_fallback_rtol=1e-12, banded_pcg_refine=0)
    calls = _float32_scan_calls(monkeypatch)
    op._banded_solve(w, sigma, rhs, base)
    assert calls == []
    op._banded_solve(w, sigma, rhs, base.replace(robust_gate_auto=False))
    assert len(calls) == 1


def test_auto_is_the_scan_on_a_cpu_tensor(monkeypatch):
    data = _liswet(40)
    cr = []
    factor = SparseOperator._banded_factor_cr

    def counting(*args):
        cr.append(1)
        return factor(*args)

    monkeypatch.setattr(operators.SparseOperator, "_banded_factor_cr",
                        staticmethod(counting))
    a = pt.solve_sparse(*data, settings=pt.Settings(banded_algo="auto"),
                        device="cpu")
    assert cr == []
    b = pt.solve_sparse(*data, settings=pt.Settings(banded_algo="scan"),
                        device="cpu")
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    pt.solve_sparse(*data, settings=pt.Settings(banded_algo="cr"),
                    device="cpu")
    assert cr
