"""The dense Newton modes "inv" and "cg" of the PyTorch port and their CG
pieces, against the JAX package on the CPU (float64).

* ``cg_fixed`` and ``pcg`` with a tolerance per problem agree with the
  vmapped JAX functions to 1e-12, ``pcg_refined`` (float32 inner solves)
  to 1e-6, with equal iteration counts per problem.
* One ``_newton_solve_inv`` and one ``_newton_solve_cg`` from the same
  inputs agree to 1e-12 relative where the system fixes the direction: the
  anchored inverse is exact, or CG runs to 1e-14 or for 60 iterations
  (n = 24), on penalties in [1e-2, 1].
* Full solves on the problem of tests/test_solve.py:664-690: "inv" gives
  JAX's status and iteration count, x and y within 1e-8.  The other modes
  stop CG at a loose relative residual (the Eisenstat-Walker term, up to
  1e-2) or after a fixed count, and there the CG iterate moves far more
  than the rounding that separates two implementations (a relative change
  of 1e-15 in K moves a 26-iteration iterate by 3e-5 of max|x|, numpy
  against numpy), so no two implementations follow one path: "cg" and
  "cg" with ``kkt_cg_fixed`` are held to JAX's own test of them (SOLVED,
  the oracle at 1e-6, x within 1e-5 of JAX's), and "inv" with
  ``kkt_cg_fixed=6`` to JAX's trajectory over its first 15 iterations.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.operators import DenseOperator as JOp
from qpdo_tpu.ops import cg as jcg

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.operators import DenseOperator as TOp
from qpdo_tpu_torch.ops import cg as tcg

from torch_parity import (assert_same, family, oracle, rel_err,
                          scaled_pair, solve_both, stacked)
from utils import random_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spd(B, n, seed, shift=1.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    return np.einsum("bij,bkj->bik", M, M) / n + shift * np.eye(n), rng


def _mv(K):
    Kt = _t(K)
    return lambda v: torch.matmul(Kt.to(v.dtype), v[..., None])[..., 0]


def test_cg_fixed_matches_jax():
    K, rng = _spd(4, 16, seed=61, shift=0.05)
    rhs, x0 = rng.standard_normal((4, 16)), rng.standard_normal((4, 16))
    rhs[2] = 0.0
    x0[2] = 0.0                          # a converged problem: no-op steps
    dinv = 1.0 / np.einsum("bii->bi", K)
    jx = jax.jit(jax.vmap(lambda Kb, rb, db, xb: jcg.cg_fixed(
        lambda v: Kb @ v, rb, db, 7, x0=xb)))(K, rhs, dinv, x0)
    tx = tcg.cg_fixed(_mv(K), _t(rhs), _t(dinv), 7, x0=_t(x0))
    assert rel_err(tx, jx) <= 1e-12
    assert torch.all(tx[2] == 0)


def test_pcg_with_a_tolerance_per_problem_matches_jax():
    K, rng = _spd(5, 20, seed=62)
    rhs = rng.standard_normal((5, 20))
    tol = np.array([1e-2, 1e-4, 1e-6, 1e-8, 1e-10])
    dinv = 1.0 / np.einsum("bii->bi", K)
    jx, jk, jrel = jax.jit(jax.vmap(lambda Kb, rb, db, tb: jcg.pcg(
        lambda v: Kb @ v, rb, db, tb, 100)))(K, rhs, dinv, tol)
    tx, tk, trel = tcg.pcg(_mv(K), _t(rhs), _t(dinv), _t(tol), 100)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert len(set(tk.tolist())) == 5    # each problem its own count
    assert rel_err(tx, jx) <= 1e-12
    np.testing.assert_allclose(trel.numpy(), np.asarray(jrel), rtol=1e-6,
                               atol=1e-14)


def test_pcg_refined_matches_jax():
    K, rng = _spd(4, 20, seed=63, shift=0.5)
    rhs, x0 = rng.standard_normal((4, 20)), rng.standard_normal((4, 20))
    tol = np.array([1e-1, 1e-6, 1e-9, 1e-12])
    dinv = 1.0 / np.einsum("bii->bi", K)
    f32 = jnp.float32

    def jone(Kb, rb, db, tb, xb):
        K32 = Kb.astype(f32)
        return jcg.pcg_refined(lambda v: Kb @ v, lambda v: K32 @ v, rb,
                               db.astype(f32), tb, 40, 4, f32, x0=xb)

    jx, jk, jrel = jax.jit(jax.vmap(jone))(K, rhs, dinv, tol, x0)
    tx, tk, trel = tcg.pcg_refined(_mv(K), _mv(K), _t(rhs),
                                   _t(dinv).float(), _t(tol), 40, 4,
                                   torch.float32, x0=_t(x0))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk[0] < tk[3]                 # a loose problem stops first
    # float32 inner solves: both packages' rounds agree to float32
    # rounding of the corrections, far below the refined accuracy
    assert rel_err(tx, jx) <= 1e-6
    assert np.all(trel.numpy() <= np.maximum(tol, 1e-6))


def _newton_inputs(settings, seed):
    """A scaled batch, an active set, penalties, sigma, rhs and the
    anchored inverse X of exactly that system (both packages)."""
    d = family(3, 24, 36, seed)
    jsp, tsp = scaled_pair(d, settings)
    rng = np.random.default_rng(seed + 1)
    active = (rng.random((3, 36)) < 0.4).astype(np.float64)
    mu = 10.0 ** rng.uniform(-2, 0, (3, 36))
    sigma = np.full(3, 1e-3)
    rhs = rng.standard_normal((3, 24))
    dx_prev = 0.1 * rng.standard_normal((3, 24))
    eps_in = np.array([1.0, 1e-3, 1e-6])
    return jsp, tsp, (active, mu, sigma, rhs, dx_prev, eps_in)


@pytest.mark.parametrize("fixed", [0, 6])
def test_newton_solve_inv_step_matches_jax(fixed):
    settings = qt.Settings(kkt_solver="inv", kkt_cg_fixed=fixed)
    jsp, tsp, (active, mu, sigma, rhs, dx_prev, eps_in) = _newton_inputs(
        settings, seed=64)

    def jone(sp, a, m, s, r, dp, e):
        op = JOp(sp=sp)
        X = op.kkt_cache_init(a, m, settings, sigma=s)
        return op._newton_solve_inv(a, m, s, r, settings, X, dp, e)

    jdx, jX = jax.jit(jax.vmap(jone))(jsp, active, mu, sigma, rhs, dx_prev,
                                      eps_in)
    op = TOp(tsp)
    ts = convert.settings(settings)
    X = op.kkt_cache_init(_t(active), _t(mu), ts, sigma=_t(sigma))
    dx, X2 = op._newton_solve_inv(_t(active), _t(mu), _t(sigma), _t(rhs),
                                  ts, X, _t(dx_prev), _t(eps_in))
    assert X2 is X
    assert rel_err(X, jX) <= 1e-12
    assert rel_err(dx, jdx) <= 1e-12


@pytest.mark.parametrize("extra", [dict(cg_tol=1e-14),
                                   dict(kkt_cg_fixed=60)])
def test_newton_solve_cg_step_matches_jax(extra):
    settings = qt.Settings(kkt_solver="cg", **extra)
    jsp, tsp, (active, mu, sigma, rhs, dx_prev, eps_in) = _newton_inputs(
        settings, seed=65)
    # eps_in of 1e-14 drives the Eisenstat-Walker term to cg_tol
    eps_in = np.full(3, 1e-14)
    jdx = jax.jit(jax.vmap(lambda sp, a, m, s, r, dp, e: JOp(
        sp=sp)._newton_solve_cg(a, m, s, r, settings, dp, e)))(
            jsp, active, mu, sigma, rhs, dx_prev, eps_in)
    dx = TOp(tsp)._newton_solve_cg(_t(active), _t(mu), _t(sigma), _t(rhs),
                                   convert.settings(settings), _t(dx_prev),
                                   _t(eps_in))
    assert rel_err(dx, jdx) <= 1e-12


_QP = random_qp(40, 60, seed=21)          # tests/test_solve.py:664-690


def _solve_one(settings):
    jr = qt.solve(qt.make_problem(*_QP), settings)
    tr = pt.solve(pt.make_problem(*_QP, device="cpu"),
                  convert.settings(settings))
    return jr, tr


def test_inv_solve_matches_jax():
    jr, tr = _solve_one(qt.Settings(kkt_solver="inv"))
    assert int(tr.info.status_val) == qt.SOLVED
    np.testing.assert_array_equal(tr.info.iterations.numpy(),
                                  np.asarray(jr.info.iterations)[None])
    assert np.abs(tr.x.numpy()[0] - np.asarray(jr.x)).max() <= 1e-8
    assert np.abs(tr.y.numpy()[0] - np.asarray(jr.y)).max() <= 1e-8


@pytest.mark.parametrize("extra", [{}, dict(kkt_cg_fixed=12)])
def test_cg_mode_solves_as_jax_does(extra):
    jr, tr = _solve_one(qt.Settings(kkt_solver="cg", **extra))
    assert int(jr.info.status_val) == int(tr.info.status_val) == qt.SOLVED
    d = stacked([_QP])
    for x, y in ((np.asarray(jr.x)[None], np.asarray(jr.y)[None]),
                 (tr.x.numpy(), tr.y.numpy())):
        rp, rd = oracle(d, x, y)
        assert rp.max() < 1e-6 and rd.max() < 1e-6
    assert np.abs(tr.x.numpy()[0] - np.asarray(jr.x)).max() <= 1e-5


def test_inv_fixed_count_follows_jax_for_15_iterations():
    """Through an anchor refresh (every 8 iterations) and the first
    subproblem ends, before the first step whose six CG iterations are
    rounding-sensitive."""
    settings = qt.Settings(kkt_solver="inv", kkt_cg_fixed=6, max_iter=15)
    jr, tr = solve_both(stacked([_QP]), settings)
    assert_same(tr, jr)
    assert int(tr.info.status_val) == qt.MAX_ITER_REACHED
