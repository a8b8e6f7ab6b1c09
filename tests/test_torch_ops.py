"""Parity of the PyTorch port's kernel modules and dense linear algebra
with the JAX package, on the CPU.

The same numpy inputs go through both packages.  On the CPU the port's
kernel wrappers run their plain PyTorch versions and the JAX Pallas
kernels run in interpret mode (as tests/test_pallas_*.py runs them).
Tolerances: formation rtol 1e-5 (f32) / 1e-12 (f64) relative to max|K|,
residuals rtol 1e-6 (f32) / 1e-12 (f64) elementwise with ``active``
equal, and 1e-12 relative for the float64 scaling, linesearch, inverse
and Newton solves.  f32 differences come from the two CPU backends
summing matrix products in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from qpdo_tpu import operators as jops
from qpdo_tpu.ops import linalg as jlinalg
from qpdo_tpu.ops import linesearch as jls
from qpdo_tpu.ops.pallas_formation import fused_formation as j_formation
from qpdo_tpu.ops.pallas_formation import reference_formation as j_ref_formation
from qpdo_tpu.ops.pallas_residuals import fused_residuals as j_residuals
from qpdo_tpu.solver.scaling import scale_problem as j_scale
import qpdo_tpu as qt

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert, kernels
from qpdo_tpu_torch.operators import DenseOperator
from qpdo_tpu_torch.ops import linalg as tlinalg
from qpdo_tpu_torch.ops import linesearch as tls
from qpdo_tpu_torch.ops.fused_formation import fused_formation
from qpdo_tpu_torch.ops.fused_residuals import fused_residuals, kernel_outputs
from qpdo_tpu_torch.solver.scaling import scale_problem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _family(B, n, m, seed):
    """The bench problem family (bench.py:344-352)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


def _scaled_pair(B, n, m, seed):
    d = _family(B, n, m, seed)
    jsp = jax.vmap(lambda p: j_scale(p, 10))(
        qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()}))
    return jsp, convert.scaled_problem(jsp, "cpu")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,n,m", [(8, 100, 150), (16, 64, 96)])
def test_formation_matches_jax(B, n, m, dtype):
    npdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(B + n)
    A = rng.standard_normal((B, m, n)).astype(npdt)
    w = rng.random((B, m)).astype(npdt)
    M = rng.standard_normal((B, n, n)).astype(npdt)
    Q = (np.einsum("bij,bkj->bik", M, M) / n).astype(npdt)
    sigma = (rng.random(B) * 0.1).astype(npdt)
    out = fused_formation(_t(A), _t(w), _t(Q), _t(sigma))
    assert out.dtype == tdt and out.shape == (B, n, n)
    jargs = [jnp.asarray(a) for a in (A, w, Q, sigma)]
    kern = np.asarray(j_formation(*jargs, interpret=True))
    if dtype == "float32":
        assert _rel(out.numpy(), kern) <= 1e-5
    else:
        # The JAX Pallas kernel accumulates in float32 whatever its input
        # (preferred_element_type=f32), so in float64 it is held against
        # the JAX plain version at 1e-12, and against the kernel at its
        # float32 rounding.
        assert _rel(out.numpy(), np.asarray(j_ref_formation(*jargs))) <= 1e-12
        assert _rel(out.numpy(), kern) <= 1e-7


def _residual_inputs(B, n, m, npdt, seed):
    rng = np.random.default_rng(seed)
    d = lambda *s: rng.standard_normal(s).astype(npdt)
    Ax, y, ybar = d(B, m), d(B, m), d(B, m)
    mu = (rng.random((B, m)) + 0.1).astype(npdt)
    l = -(rng.random((B, m)) + 0.2).astype(npdt)
    u = (rng.random((B, m)) + 0.2).astype(npdt)
    E = (rng.random((B, m)) + 0.5).astype(npdt)
    Qx, q, Aty, x, xbar = d(B, n), d(B, n), d(B, n), d(B, n), d(B, n)
    Dinv = (rng.random((B, n)) + 0.5).astype(npdt)
    sigma = (rng.random(B) * 0.1).astype(npdt)
    cinv = (rng.random(B) + 0.5).astype(npdt)
    return (Ax, y, mu, ybar, l, u, E, (1.0 / E).astype(npdt),
            Qx, q, Aty, x, xbar, Dinv, sigma, cinv)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("B,n,m", [(8, 100, 150), (16, 64, 96)])
def test_residuals_match_jax(B, n, m, dtype):
    npdt, tdt = DTYPES[dtype]
    args = _residual_inputs(B, n, m, npdt, seed=B)
    out = fused_residuals(*[_t(a) for a in args])
    ref = j_residuals(*[jnp.asarray(a) for a in args], interpret=True)
    tol = 1e-6 if dtype == "float32" else 1e-12
    names = ["res_prim", "res_prim_in", "w", "active", "res_dual_in",
             "rp", "rd", "rpi", "rdi"]
    for name, a, b in zip(names, out, ref):
        assert a.dtype == tdt, name
        if name == "active":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=tol,
                                       atol=tol, err_msg=name)


def test_residual_norms_are_per_problem_and_propagate_nan():
    args = [_t(a) for a in _residual_inputs(4, 10, 12, np.float64, seed=1)]
    base = fused_residuals(*args)
    args[0] = args[0].clone()
    args[0][2, 3] = float("nan")          # Ax of problem 2 only
    out = fused_residuals(*args)
    rp = out[5]
    assert torch.isnan(rp[2]) and torch.isfinite(rp[[0, 1, 3]]).all()
    assert torch.equal(rp[[0, 1, 3]], base[5][[0, 1, 3]])


def test_wrappers_check_their_arguments():
    A = torch.zeros((2, 5, 3), dtype=torch.float64)
    w = torch.zeros((2, 5), dtype=torch.float64)
    Q = torch.zeros((2, 3, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match="sigma"):
        fused_formation(A, w, Q, torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="w is"):
        fused_formation(A, w.float(), Q, torch.zeros(2, dtype=torch.float64))


def _bad_residual_args(case):
    args = [_t(a) for a in _residual_inputs(3, 4, 5, np.float64, seed=2)]
    if case == "scalar shape":
        args[14] = args[14][:2]                      # sigma (2,), B = 3
    elif case == "primal shape":
        args[10] = torch.zeros((3, 6), dtype=torch.float64)      # Aty
    elif case == "dual dtype":
        args[5] = args[5].float()                    # u
    elif case == "device":
        args[7] = torch.empty((3, 5), dtype=torch.float64, device="meta")
    elif case == "unsupported device":
        args = [a.to("meta") for a in args]
    elif case == "rank":
        args[0] = args[0][None]
    elif case == "out":
        return args, kernel_outputs(3, 4, 5, torch.float64, "cpu")
    return args, None


@pytest.mark.parametrize("case,error,match", [
    ("scalar shape", ValueError, r"sigma must be \(3,\)"),
    ("primal shape", ValueError, r"Aty must be \(3, 4\)"),
    ("dual dtype", ValueError, "u is torch.float32"),
    ("device", ValueError, "Einv is torch.float64 on meta"),
    ("unsupported device", ValueError, "unsupported device meta"),
    ("rank", ValueError, r"Ax must be \(B, m\)"),
    ("out", ValueError, r"out must be kernel_outputs\(3, 5, 4\)"),
])
def test_residual_wrapper_checks_its_arguments(case, error, match):
    """Every bad argument raises before anything runs (the card test adds
    a non-contiguous one, which only the kernel's path refuses)."""
    args, out = _bad_residual_args(case)
    with pytest.raises(error, match=match):
        fused_residuals(*args, out=out)


def test_kernel_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", tmp_path / "nvcc")
    kernels.library.cache_clear()
    try:
        with pytest.raises(kernels.KernelError, match="nvcc not found"):
            kernels.library()
    finally:
        kernels.library.cache_clear()


@pytest.mark.parametrize("ruiz_kkt", [False, True])
def test_scale_problem_matches_jax(ruiz_kkt):
    d = _family(5, 30, 45, seed=3)
    d["u"][:, :4] = np.inf                # some infinite bounds
    jp = qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})
    jsp = jax.vmap(lambda p: j_scale(p, 10, ruiz_kkt))(jp)
    tsp = scale_problem(pt.Problem(**{k: _t(v) for k, v in d.items()}), 10,
                        ruiz_kkt)
    jleaves = jax.tree.leaves(jsp)
    tleaves = [tsp.data.Q, tsp.data.q, tsp.data.A, tsp.data.l, tsp.data.u,
               tsp.data.c, *tsp.scaling, tsp.l_finite, tsp.u_finite,
               tsp.norm_q]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=0)


def _linesearch_inputs(B, n, m, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Qs = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    dx = rng.standard_normal((B, n))
    Qdx = np.einsum("bij,bj->bi", Qs, dx)
    dy = rng.standard_normal((B, m))
    Adx = rng.standard_normal((B, m))
    df = rng.standard_normal((B, n))
    y = rng.standard_normal((B, m))
    w = rng.standard_normal((B, m))
    mu = 10.0 ** rng.uniform(-4, 0, (B, m))
    l = -rng.random((B, m))
    u = rng.random((B, m))
    return dx, dy, Qdx, Adx, df, y, w, mu, l, u


@pytest.mark.parametrize("method", ["bisect", "sort"])
def test_exact_linesearch_matches_jax(method):
    args = _linesearch_inputs(7, 20, 30, seed=11)
    tau = tls.exact_linesearch(*[_t(a) for a in args], method=method)
    jtau = jax.vmap(lambda *a: jls.exact_linesearch(*a, method=method))(
        *[jnp.asarray(a) for a in args])
    assert tau.shape == (7,)
    np.testing.assert_allclose(tau.numpy(), np.asarray(jtau), rtol=1e-12)


def test_linesearch_bisect_and_sort_agree():
    args = [_t(a) for a in _linesearch_inputs(7, 20, 30, seed=12)]
    a = tls.exact_linesearch(*args, method="bisect")
    b = tls.exact_linesearch(*args, method="sort")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10)


def _newton_inputs(B, n, m, seed):
    jsp, tsp = _scaled_pair(B, n, m, seed)
    rng = np.random.default_rng(seed + 1)
    active = (rng.random((B, m)) < 0.4).astype(np.float64)
    # penalties of a well-conditioned K, so that 1e-12 measures the port
    # and not the amplification of roundoff by cond(K)
    mu = 10.0 ** rng.uniform(-2, 0, (B, m))
    sigma = np.full(B, 1e-3)
    rhs = rng.standard_normal((B, n))
    return jsp, tsp, active, mu, sigma, rhs


def test_kkt_inverse_matches_jax():
    jsp, tsp, active, mu, sigma, _ = _newton_inputs(4, 30, 45, seed=21)
    X = tlinalg.kkt_inverse(tsp.data.Q, tsp.data.A, _t(active), _t(mu),
                            _t(sigma), True)
    jX = jax.vmap(lambda Q, A, a, m, s: jlinalg.kkt_inverse(Q, A, a, m, s,
                                                            True))(
        jsp.data.Q, jsp.data.A, jnp.asarray(active), jnp.asarray(mu),
        jnp.asarray(sigma))
    assert _rel(X.numpy(), np.asarray(jX)) <= 1e-12


@pytest.mark.parametrize("refine_steps", [0, 2])
def test_newton_system_solve_matches_jax(refine_steps):
    jsp, tsp, active, mu, sigma, rhs = _newton_inputs(4, 30, 45, seed=22)
    dx = tlinalg.newton_system_solve(tsp.data.Q, tsp.data.A, _t(active),
                                     _t(mu), _t(sigma), _t(rhs), True,
                                     refine_steps)
    jdx = jax.vmap(lambda Q, A, a, m, s, r: jlinalg.newton_system_solve(
        Q, A, a, m, s, r, True, refine_steps))(
        jsp.data.Q, jsp.data.A, jnp.asarray(active), jnp.asarray(mu),
        jnp.asarray(sigma), jnp.asarray(rhs))
    assert _rel(dx.numpy(), np.asarray(jdx)) <= 1e-12


def test_newton_system_solve_fused_formation_branch_f32_factor():
    """The pallas_formation branch with a float32 factor and float64
    state (the bench's phase 2): both packages' f32 products round
    differently, so the directions agree to f32-factor accuracy."""
    jsp, tsp, active, mu, sigma, rhs = _newton_inputs(4, 30, 45, seed=23)
    dx = tlinalg.newton_system_solve(tsp.data.Q, tsp.data.A, _t(active),
                                     _t(mu), _t(sigma), _t(rhs), True, 2,
                                     "float32", pallas_formation=True)
    jdx = jax.vmap(lambda Q, A, a, m, s, r: jlinalg.newton_system_solve(
        Q, A, a, m, s, r, True, 2, "float32", pallas_formation=True))(
        jsp.data.Q, jsp.data.A, jnp.asarray(active), jnp.asarray(mu),
        jnp.asarray(sigma), jnp.asarray(rhs))
    assert dx.dtype == torch.float64
    assert _rel(dx.numpy(), np.asarray(jdx)) <= 1e-4


def test_newton_solve_failed_factor_is_guarded_per_problem():
    _, tsp, active, mu, sigma, rhs = _newton_inputs(3, 10, 12, seed=24)
    Q = tsp.data.Q.clone()
    Q[1] = -Q[1] - 10.0 * torch.eye(10, dtype=Q.dtype)  # not SPD
    dx = tlinalg.newton_system_solve(Q, tsp.data.A, _t(active), _t(mu),
                                     _t(sigma), _t(rhs), True, 1)
    assert torch.all(dx[1] == 0)
    assert torch.all(dx[[0, 2]] != 0)


@pytest.mark.parametrize("kkt_dtype", [None, "float32"])
def test_newton_solve_ns_matches_jax(kkt_dtype):
    jsp, tsp, active, mu, sigma, rhs = _newton_inputs(4, 30, 45, seed=25)
    # X from a neighbouring system, so the NS updates have work to do
    X0 = jax.vmap(lambda Q, A, a, m, s: jlinalg.kkt_inverse(
        Q, A, a, m, s, True, kkt_dtype))(
        jsp.data.Q, jsp.data.A, jnp.asarray(active), jnp.asarray(2.0 * mu),
        jnp.asarray(sigma))
    settings = qt.Settings(kkt_solver="ns", kkt_ns_steps=5,
                           kkt_dtype=kkt_dtype)
    jdx, jX = jax.vmap(
        lambda sp, a, m, s, r, X: jops.DenseOperator(sp=sp)._newton_solve_ns(
            a, m, s, r, settings, X))(
        jsp, jnp.asarray(active), jnp.asarray(mu), jnp.asarray(sigma),
        jnp.asarray(rhs), X0)
    dx, X = DenseOperator(tsp)._newton_solve_ns(
        _t(active), _t(mu), _t(sigma), _t(rhs), convert.settings(settings),
        _t(X0))
    tol = 1e-12 if kkt_dtype is None else 1e-4
    assert _rel(dx.numpy(), np.asarray(jdx)) <= tol
    assert _rel(X.numpy(), np.asarray(jX)) <= tol


def test_mixed_matvecs_pick_the_smallest_mu_rows_like_top_k():
    jsp, tsp, _, _, _, _ = _newton_inputs(3, 20, 30, seed=26)
    rng = np.random.default_rng(27)
    mu = np.full((3, 30), 1e-3)           # ties at the clip value
    mu[:, 5] = 1e-6
    x = rng.standard_normal((3, 20))
    y = rng.standard_normal((3, 30))
    op = DenseOperator(tsp)
    Ax = op.Amv_mixed(_t(x), _t(mu), 8, torch.float32)
    Aty = op.Atmv_mixed(_t(y), _t(mu), 8, torch.float32)
    jAx = jax.vmap(lambda sp, v, m: jops.DenseOperator(sp=sp).Amv_mixed(
        v, m, 8, jnp.float32))(jsp, jnp.asarray(x), jnp.asarray(mu))
    jAty = jax.vmap(lambda sp, v, m: jops.DenseOperator(sp=sp).Atmv_mixed(
        v, m, 8, jnp.float32))(jsp, jnp.asarray(y), jnp.asarray(mu))
    # the exact rows agree to f64 roundoff, the rest to f32 roundoff
    exact = np.argsort(mu, axis=-1, kind="stable")[:, :8]
    np.testing.assert_allclose(np.take_along_axis(Ax.numpy(), exact, 1),
                               np.take_along_axis(np.asarray(jAx), exact, 1),
                               rtol=1e-12)
    assert _rel(Ax.numpy(), np.asarray(jAx)) <= 1e-6
    assert _rel(Aty.numpy(), np.asarray(jAty)) <= 1e-6
