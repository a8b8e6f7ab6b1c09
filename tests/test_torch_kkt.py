"""Parity of the PyTorch port's fused KKT solve and stacked Cholesky solve
(the plain versions of its two KKT kernels) with the JAX package's Pallas
kernels, on the CPU.

The same numpy inputs go through both packages.  The JAX Pallas kernels
run in interpret mode (as tests/test_pallas_kkt.py runs them: n=128
directly, other sizes through the padding of ``fused_kkt_solve``); the
port runs its plain versions at the unpadded size.  Tolerances, relative
to max(1, max|dx|) as in tests/test_pallas_kkt.py: the fused solve 1e-5,
the stacked Cholesky solve 5e-4 (the JAX package's own bounds against a
dense solve).  The float32 results are not bit for bit equal: the two
packages sum the same recurrences in another order.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpdo_tpu.ops import pallas_kkt as jkkt

from qpdo_tpu_torch.ops import fused_kkt as tkkt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def _kkt_inputs(B, n, m, seed, wscale=10.0, shift=0.1):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    Q = (np.einsum("bij,bkj->bik", M, M) / n
         + shift * np.eye(n)).astype(np.float32)
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    w = (rng.random((B, m)) * wscale).astype(np.float32)
    sigma = np.full(B, 1e-3, np.float32)
    rhs = rng.standard_normal((B, n)).astype(np.float32)
    return Q, A, w, sigma, rhs


def _dense_solve(Q, A, w, sigma, rhs):
    out = []
    for b in range(Q.shape[0]):
        n = Q.shape[-1]
        K = (Q[b].astype(np.float64) + float(sigma[b]) * np.eye(n)
             + A[b].T.astype(np.float64)
             @ (w[b][:, None] * A[b]).astype(np.float64))
        out.append(np.linalg.solve(K, rhs[b].astype(np.float64)))
    return np.stack(out)


@pytest.mark.parametrize("B,n,m,entry,dense_tol", [
    # the JAX kernel's own shape, and its test's bound against a dense solve
    (3, 128, 256, "pallas_kkt_solve", 5e-6),
    # the bench shape (JAX pads to 128); fewer rows, a worse-conditioned K
    (4, 100, 150, "fused_kkt_solve", 5e-5),
    (2, 40, 60, "fused_kkt_solve", 5e-5),
])
def test_fused_kkt_solve_matches_jax(B, n, m, entry, dense_tol):
    args = _kkt_inputs(B, n, m, seed=n)
    dx = tkkt.fused_kkt_solve(*[_t(a) for a in args])
    assert dx.dtype == torch.float32 and dx.shape == (B, n)
    jdx = getattr(jkkt, entry)(*[jnp.asarray(a) for a in args],
                               interpret=True)
    assert _err(dx.numpy(), jdx) <= 1e-5
    # and both against a float64 dense solve
    ref = _dense_solve(*args)
    assert _err(dx.numpy(), ref) <= dense_tol
    assert _err(jdx, ref) <= dense_tol


def test_fused_kkt_solve_casts_float64_inputs():
    args = _kkt_inputs(2, 30, 45, seed=1)
    dx64 = tkkt.fused_kkt_solve(*[_t(a).double() for a in args])
    dx32 = tkkt.fused_kkt_solve(*[_t(a) for a in args])
    assert dx64.dtype == torch.float32
    assert torch.equal(dx64, dx32)


def test_fused_kkt_solve_ignores_rows_of_zero_weight():
    """w = 0 rows (inactive constraints) must not contribute."""
    Q, A, w, sigma, rhs = _kkt_inputs(1, 128, 256, seed=1, shift=0.5)
    w = np.zeros_like(w)
    A[0, 3] = 1e6                          # would dominate if it counted
    dx = tkkt.fused_kkt_solve(*[_t(a) for a in (Q, A, w, sigma, rhs)])
    jdx = jkkt.pallas_kkt_solve(*[jnp.asarray(a) for a in
                                  (Q, A, w, sigma, rhs)], interpret=True)
    K = Q[0].astype(np.float64) + sigma[0] * np.eye(128)
    ref = np.linalg.solve(K, rhs[0].astype(np.float64))
    assert np.abs(dx.numpy()[0] - ref).max() < 1e-4
    assert _err(dx.numpy(), jdx) <= 1e-5


def test_nonpositive_diagonal_gets_scale_one():
    """A diagonal entry <= 0 is left unscaled (dinv = 1), and the clamped
    pivot then gives the huge but finite factor the JAX kernel gives."""
    n, m = 128, 128
    Q = np.eye(n, dtype=np.float32)[None].copy()
    Q[0, 0, 0] = -4.0
    A = np.zeros((1, m, n), np.float32)
    w = np.zeros((1, m), np.float32)
    sigma = np.zeros(1, np.float32)
    rhs = np.ones((1, n), np.float32)
    dx = tkkt.fused_kkt_solve(*[_t(a) for a in (Q, A, w, sigma, rhs)])
    jdx = np.asarray(jkkt.pallas_kkt_solve(
        *[jnp.asarray(a) for a in (Q, A, w, sigma, rhs)], interpret=True))
    # R[0,0] = (-4 + reg) * rsqrt(1e-30): dx[0] = rhs[0] / R[0,0]^2
    r00 = (np.float32(-4.0) + np.float32(tkkt._static_reg32())) * 1e15
    assert dx[0, 0].item() == pytest.approx(1.0 / r00 ** 2, rel=1e-4)
    np.testing.assert_allclose(dx.numpy(), jdx, rtol=1e-5, atol=1e-37)
    assert np.isfinite(dx.numpy()).all()


def test_nan_and_failed_factor_stay_in_their_problem():
    Q, A, w, sigma, rhs = _kkt_inputs(4, 20, 30, seed=2)
    base = tkkt.fused_kkt_solve(*[_t(a) for a in (Q, A, w, sigma, rhs)])
    rhs = rhs.copy()
    rhs[1, 5] = np.nan
    Q = Q.copy()
    Q[2, 7, 7] = np.nan                   # a NaN pivot must stay NaN
    dx = tkkt.fused_kkt_solve(*[_t(a) for a in (Q, A, w, sigma, rhs)])
    finite = torch.isfinite(dx).all(dim=1)
    assert finite.tolist() == [True, False, False, True]
    assert torch.equal(dx[[0, 3]], base[[0, 3]])
    # the JAX kernel agrees on which problems fail (n padded to 128 there)
    jdx = np.asarray(jkkt.fused_kkt_solve(
        *[jnp.asarray(a) for a in (Q, A, w, sigma, rhs)], interpret=True))
    assert np.isfinite(jdx).all(axis=1).tolist() == finite.tolist()


def _spd(B, n, seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    K = np.einsum("bik,bjk->bij", M, M) / n + 0.5 * np.eye(n, dtype=np.float32)
    return K.astype(np.float32), rng.standard_normal((B, n)).astype(np.float32)


@pytest.mark.parametrize("B,n", [(16, 128), (8, 128)])
def test_chol_solve_stacked_matches_jax(B, n):
    K, rhs = _spd(B, n, seed=5 + B)
    dx = tkkt.chol_solve_stacked(_t(K), _t(rhs))
    assert dx.dtype == torch.float32 and dx.shape == (B, n)
    jdx = jkkt.pallas_chol_solve_stacked(jnp.asarray(K), jnp.asarray(rhs),
                                         interpret=True)
    ref = np.stack([np.linalg.solve(K[b], rhs[b]) for b in range(B)])
    err = np.abs(dx.numpy() - ref).max() / np.abs(ref).max()
    assert err < 5e-4                      # the JAX test's own bound
    assert _err(dx.numpy(), jdx) <= 5e-4


def test_chol_solve_takes_sizes_the_tpu_kernel_cannot():
    """No multiple-of-8 batch and no multiple-of-128 n: those were the
    TPU's."""
    K, rhs = _spd(3, 37, seed=9)
    dx = tkkt.chol_solve_stacked(_t(K), _t(rhs))
    ref = np.stack([np.linalg.solve(K[b].astype(np.float64), rhs[b])
                    for b in range(3)])
    assert _err(dx.numpy(), ref) <= 1e-5


def test_chol_solve_clamps_divisors_where_the_fused_solve_does_not():
    """A negative pivot: the stacked solve divides by max(R_jj, 1e-30),
    the fused solve by R_jj itself (the JAX kernels differ in the same
    way)."""
    n = 128
    K = np.eye(n, dtype=np.float32)[None].copy()
    K[0, 0, 0] = -4.0
    rhs = np.ones((1, n), np.float32)
    dx = tkkt.chol_solve_stacked(_t(K), _t(rhs)).numpy()
    jdx = np.asarray(jkkt.pallas_chol_solve_stacked(
        jnp.asarray(np.repeat(K, 8, 0)), jnp.asarray(np.repeat(rhs, 8, 0)),
        interpret=True))[:1]
    # z0 = 1 / 1e-30 and x0 = z0 / 1e-30 overflow float32 in both
    assert np.array_equal(np.isfinite(dx), np.isfinite(jdx))
    np.testing.assert_allclose(dx[0, 1:], jdx[0, 1:], rtol=1e-5)
    plain = tkkt._chol_solve_plain(_t(K), _t(rhs), clamp_div=False).numpy()
    assert np.isfinite(plain).all() and plain[0, 0] > 0
