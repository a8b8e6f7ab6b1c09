"""Parity of the PyTorch port's PCG and of the ``pallas_kkt`` and PCG
branches of its Newton solve with the JAX package, on the CPU.

The same numpy inputs go through both packages; the JAX side runs jitted
and vmapped (its Pallas kernel in interpret mode), the port batched.  PCG
agrees to 1e-10 with equal iteration counts; the Newton solve's tolerances
are stated beside each case, relative to max(1, max|dx|).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qpdo_tpu.ops import cg as jcg
from qpdo_tpu.ops import linalg as jlinalg

from qpdo_tpu_torch.ops import cg as tcg
from qpdo_tpu_torch.ops import linalg as tlinalg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _newton_inputs(B, n, m, seed, mu_lo=-2.0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    A = rng.standard_normal((B, m, n))
    active = (rng.random((B, m)) < 0.4).astype(np.float64)
    mu = 10.0 ** rng.uniform(mu_lo, 0, (B, m))
    sigma = np.full(B, 1e-3)
    rhs = rng.standard_normal((B, n))
    return Q, A, active, mu, sigma, rhs


@pytest.mark.parametrize("precond", ["jacobi", "callable"])
def test_pcg_matches_jax(precond):
    Q, A, active, mu, sigma, rhs = _newton_inputs(5, 24, 36, seed=31)
    # a well-conditioned K, so that both packages stop at the same count
    # (over ~50 iterations their float64 roundoff moves it by one or two)
    K = Q + 0.01 * np.einsum("bmi,bm,bmj->bij", A, active, A) + np.eye(24)
    rhs[3] = 0.0                           # converged at once: no-op steps
    dinv = 1.0 / np.einsum("bii->bi", K)

    def jone(Kb, rb, db):
        pre = db if precond == "jacobi" else (lambda r: db * r)
        return jcg.pcg(lambda v: Kb @ v, rb, pre, 1e-8, 200)

    jx, jk, jrel = jax.jit(jax.vmap(jone))(jnp.asarray(K), jnp.asarray(rhs),
                                           jnp.asarray(dinv))
    Kt, dt_ = _t(K), _t(dinv)
    pre = dt_ if precond == "jacobi" else (lambda r: dt_ * r)
    x, k, rel = tcg.pcg(lambda v: torch.matmul(Kt, v[..., None])[..., 0],
                        _t(rhs), pre, 1e-8, 200)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    assert k[3] == 0 and 0 < int(k.max()) < 200
    assert _err(x.numpy(), jx) <= 1e-10
    np.testing.assert_allclose(rel.numpy(), np.asarray(jrel), rtol=1e-6,
                               atol=1e-14)


def test_pcg_stops_at_the_cap_and_on_nan_per_problem():
    Q, A, active, mu, sigma, rhs = _newton_inputs(3, 12, 18, seed=32)
    K = _t(Q + 1e-3 * np.eye(12))
    rhs = _t(rhs)
    rhs[1, 0] = float("nan")
    x, k, rel = tcg.pcg(lambda v: torch.matmul(K, v[..., None])[..., 0],
                        rhs, torch.ones_like(rhs), 1e-14, 3)
    assert k.tolist() == [3, 0, 3]
    assert torch.isnan(rel[1]) and torch.isfinite(x[[0, 2]]).all()


def _jax_newton(args, **kw):
    Q, A, active, mu, sigma, rhs = [jnp.asarray(a) for a in args]
    # one compiled program, not one per primitive
    return np.asarray(jax.jit(jax.vmap(
        lambda Q, A, a, m, s, r: jlinalg.newton_system_solve(
            Q, A, a, m, s, r, True, **kw)))(Q, A, active, mu, sigma, rhs))


def _torch_newton(args, **kw):
    return tlinalg.newton_system_solve(*[_t(a) for a in args], True,
                                       **kw).numpy()


@pytest.mark.parametrize("branch,kw,tol,ref_tol", [
    # One float32 kernel solve of a cond ~2e3 system.  Both packages are
    # 1.5e-3 off the exact solve (the static shift 1.2e-5 times cond), and
    # 1.2e-5 off each other (measured).
    ("plain", dict(refine_steps=0), 1e-4, 5e-3),
    # two sweeps against float32 matvecs (kkt_dtype): 3e-6 measured
    ("refined_f32_matvecs", dict(refine_steps=2, kkt_dtype="float32"),
     2e-5, 2e-5),
    # two sweeps against float64 matvecs: 1.3e-10 measured
    ("refined", dict(refine_steps=2), 1e-8, 1e-7),
    # PCG to 1e-9 with float64 matvecs: 5e-12 measured
    ("pcg", dict(refine_steps=0, pcg_refine=12), 1e-9, 1e-8),
])
def test_newton_system_solve_pallas_kkt_matches_jax(branch, kw, tol, ref_tol):
    args = _newton_inputs(3, 30, 45, seed=33, mu_lo=-1.0)
    dx = _torch_newton(args, pallas_kkt=True, **kw)
    jdx = _jax_newton(args, pallas_kkt=True, **kw)
    assert dx.dtype == np.float64
    assert _err(dx, jdx) <= tol, branch
    # and the branch solves the system it was given
    Q, A, active, mu, sigma, rhs = args
    K = Q + np.einsum("bmi,bm,bmj->bij", A, active / mu, A) + 1e-3 * np.eye(30)
    ref = np.linalg.solve(K, rhs[..., None])[..., 0]
    assert _err(dx, ref) <= ref_tol, branch


def test_newton_system_solve_pallas_kkt_guards_a_failed_problem():
    args = list(_newton_inputs(3, 10, 12, seed=34))
    args[0] = args[0].copy()
    args[0][1] = -args[0][1] - 10.0 * np.eye(10)      # not SPD
    args[5] = args[5].copy()
    args[5][2, 0] = np.nan
    dx = _torch_newton(args, pallas_kkt=True, refine_steps=1)
    assert np.all(dx[2] == 0) and np.all(dx[0] != 0)
    assert np.isfinite(dx).all()


@pytest.mark.parametrize("escalate", [False, True])
def test_newton_system_solve_pcg_refine_and_escalation_match_jax(escalate):
    """The chol path's PCG refinement with a float32 factor; with penalties
    down to 1e-9 the float32 factor fails and the state-dtype escalation
    takes over for those problems."""
    args = list(_newton_inputs(4, 30, 45, seed=35,
                               mu_lo=-9.5 if escalate else -3.0))
    if escalate:
        args[3][0] = 1.0                   # problem 0 stays easy
    kw = dict(refine_steps=0, kkt_dtype="float32", pcg_refine=32,
              escalate_rtol=1e-6)
    dx = _torch_newton(args, **kw)
    jdx = _jax_newton(args, **kw)
    assert np.isfinite(dx).all() and np.abs(dx).max() > 0
    rel = np.abs(dx - jdx).max(axis=1) / np.abs(jdx).max(axis=1)
    assert rel.max() <= 1e-6, rel


def test_newton_solve_hands_the_fused_solve_its_cached_float32_casts(
        monkeypatch):
    """``DenseOperator.newton_solve`` passes the float32 Q and A it keeps;
    the result equals, bit for bit, the solve that casts on every call."""
    from qpdo_tpu_torch import Problem, Settings
    from qpdo_tpu_torch import operators
    from qpdo_tpu_torch.operators import DenseOperator
    from qpdo_tpu_torch.solver.scaling import scale_problem

    Q, A, active, mu, sigma, rhs = [_t(a) for a in
                                    _newton_inputs(3, 30, 45, seed=36)]
    settings = Settings(kkt_dtype="float32", refine_steps=2, pallas_kkt=True)
    B, m = active.shape
    sp = scale_problem(Problem(Q=Q, q=rhs, A=A, l=-torch.ones(B, m,
                               dtype=Q.dtype), u=torch.ones(B, m,
                               dtype=Q.dtype), c=torch.zeros(B, dtype=Q.dtype)),
                       settings.scaling)
    op = DenseOperator(sp)
    new = op.newton_solve(active, mu, sigma, rhs, settings)
    assert set(op._casts) == {("Q", torch.float32), ("A", torch.float32)}
    kept = dict(op._casts)
    again = op.newton_solve(active, mu, sigma, rhs, settings)
    assert all(op._casts[k] is v for k, v in kept.items())      # cast once
    seen = []

    def casting_every_call(*args, kkt_mats=None, **kw):
        seen.append(kkt_mats)
        return tlinalg.newton_system_solve(*args, **kw)

    monkeypatch.setattr(operators, "newton_system_solve", casting_every_call)
    old = op.newton_solve(active, mu, sigma, rhs, settings)
    assert seen[0][0] is kept[("Q", torch.float32)]
    assert seen[0][1] is kept[("A", torch.float32)]
    assert torch.equal(new, old) and torch.equal(again, old)
    assert new.abs().max() > 0
