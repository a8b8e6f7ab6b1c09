"""Dense KKT formation and factorize/solve for the Newton step, batched.

Port of the parts of ``qpdo_tpu/ops/linalg.py`` that the dense batched
solve runs.  The reduced system of every problem b is

    K_b = Q_b + sigma_b*I*[proximal] + A_b' diag(active_b/mu_b) A_b

formed by the fused formation kernel (``ops/fused_formation.py``) and
factored by a Jacobi-prescaled Cholesky, optionally in a reduced
``kkt_dtype`` with iterative refinement against exact state-dtype
matvecs.  Cholesky and triangular solves stay on ``torch.linalg``, as the
JAX package leaves them to ``lax.linalg``.
"""

from __future__ import annotations

import torch

from .batched import all_finite, bwhere, mtv, mv, norm2
from .fused_formation import fused_formation


def resolve_dtype(name, default: torch.dtype) -> torch.dtype:
    """A settings dtype name ("float32", "float64" or None) as a torch
    dtype; a torch dtype passes through."""
    if name is None:
        return default
    if isinstance(name, torch.dtype):
        return name
    dtypes = {"float32": torch.float32, "float64": torch.float64}
    if str(name) not in dtypes:
        raise NotImplementedError(f"dtype setting {name!r}: only float32 and "
                                  "float64 are supported")
    return dtypes[str(name)]


def form_kkt(Q, A, active, mu, sigma, proximal: bool):
    """K = Q + [proximal]*sigma*I + A' diag(active/mu) A (sigma is (B,)).

    Goes through the formation kernel on a CUDA tensor; the weights are
    divided in the dtype of the arguments, as ``qpdo_tpu``'s ``form_kkt``
    divides them (``linalg.py:39``)."""
    w = active / mu
    sig = sigma if proximal else torch.zeros_like(sigma)
    return fused_formation(A, w, Q, sig)


def _static_reg(dtype: torch.dtype) -> float:
    """Diagonal shift of the Jacobi-scaled factor: two orders above eps."""
    return 100.0 * float(torch.finfo(dtype).eps)


def jacobi_cholesky(K):
    """Factor Khat = D^-1 K D^-1 + reg*I with D = sqrt(diag K), per problem.
    Returns (chol(Khat), dinv).

    Like ``jnp.linalg.cholesky``, the input is symmetrized first and a
    problem whose matrix is not positive definite gets an all-NaN factor
    (``cholesky_ex`` reports it instead of raising), so the callers'
    finiteness guards act on that problem alone."""
    d = torch.sqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    d = torch.where(d > 0, d, torch.ones_like(d))
    dinv = 1.0 / d
    Khat = K * dinv[..., :, None] * dinv[..., None, :]
    n = K.shape[-1]
    Khat = Khat + _static_reg(K.dtype) * torch.eye(n, dtype=K.dtype,
                                                   device=K.device)
    Khat = (Khat + Khat.mT) / 2
    chol, info = torch.linalg.cholesky_ex(Khat)
    chol = bwhere(info == 0, chol, torch.full_like(chol, float("nan")))
    return chol, dinv


def kkt_inverse(Q, A, active, mu, sigma, proximal: bool, kkt_dtype=None):
    """Explicit K^{-1} per problem (the init of the Newton-Schulz-tracked
    inverse, kkt_solver "ns"): Jacobi-prescaled Cholesky, one matrix-RHS
    triangular solve and one GEMM."""
    dt = Q.dtype
    kdt = resolve_dtype(kkt_dtype, dt)
    K = form_kkt(Q.to(kdt), A.to(kdt), active.to(kdt), mu.to(kdt),
                 sigma.to(kdt), proximal)
    chol, dinv = jacobi_cholesky(K)
    n = K.shape[-1]
    eye = torch.eye(n, dtype=kdt, device=K.device).expand(K.shape)
    Linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    Xhat = torch.matmul(Linv.mT, Linv)                    # L^-T L^-1
    return Xhat * dinv[..., :, None] * dinv[..., None, :]


def _prescaled_tri_solver(chol, dinv, out_dtype):
    """b -> D^-1 (LL')^-1 D^-1 b for a Jacobi-prescaled factor (b is (B, n))."""
    kdt = chol.dtype

    def solve1(b):
        bh = (b * dinv).to(kdt).unsqueeze(-1)
        z = torch.linalg.solve_triangular(chol, bh, upper=False)
        z = torch.linalg.solve_triangular(chol.mT, z, upper=True)
        return z.squeeze(-1).to(out_dtype) * dinv.to(out_dtype)

    return solve1


def _exact_kmv(Q, A, w, sigma, proximal: bool, kdt, dt):
    """v -> K(w) v with matvecs in the KKT dtype (sigma is (B,))."""
    Qk, Ak, wk = Q.to(kdt), A.to(kdt), w.to(kdt)

    def Kmv(v):
        vk = v.to(kdt)
        Kv = (mv(Qk, vk) + mtv(Ak, wk * mv(Ak, vk))).to(dt)
        if proximal:
            Kv = Kv + sigma[:, None] * v
        return Kv

    return Kmv


def newton_system_solve(Q, A, active, mu, sigma, rhs, proximal: bool,
                        refine_steps: int = 0, kkt_dtype=None,
                        pallas_formation: bool = False,
                        ytilde=None, res_dual_in=None,
                        pcg_refine: int = 0,
                        pallas_kkt: bool = False,
                        escalate_rtol: float = 0.0):
    """Form K and solve K dx = rhs per problem (the chol Newton solve).

    Arguments are batched: Q (B, n, n), A (B, m, n), active/mu (B, m),
    sigma (B,), rhs (B, n).  ``pallas_formation`` keeps the arithmetic of
    the JAX package's fused-formation branch (the weights divided in the
    state dtype, then cast, ``linalg.py:266,336``); without it the weights
    are cast first and divided in the KKT dtype (``form_kkt``).  Both reach
    the formation kernel on a CUDA tensor.  ``escalate_rtol`` acts only
    inside the PCG refinement, which is not ported."""
    if pallas_kkt:
        raise NotImplementedError(
            "Settings.pallas_kkt: the fused chol-path Newton-solve kernel "
            "(qpdo_tpu/ops/pallas_kkt.py) is not ported yet")
    if ytilde is not None or res_dual_in is not None:
        raise NotImplementedError(
            "Settings.fused_newton_rhs is not ported yet")
    if pcg_refine > 0:
        raise NotImplementedError(
            "Settings.kkt_pcg_refine (PCG refinement and state-dtype "
            "escalation, qpdo_tpu/ops/cg.py) is not ported yet; it engages "
            "when kkt_dtype is reduced and mu_min < 1e-7")
    dt = Q.dtype
    kdt = resolve_dtype(kkt_dtype, dt)
    w = active / mu
    if pallas_formation:
        sig = sigma.to(kdt) if proximal else torch.zeros_like(sigma, dtype=kdt)
        K = fused_formation(A.to(kdt), w.to(kdt), Q.to(kdt), sig)
    else:
        K = form_kkt(Q.to(kdt), A.to(kdt), active.to(kdt), mu.to(kdt),
                     sigma.to(kdt), proximal)
    chol, dinv = jacobi_cholesky(K)
    solve1 = _prescaled_tri_solver(chol, dinv, dt)
    Kmv = _exact_kmv(Q, A, w, sigma, proximal, kdt, dt)

    dx = solve1(rhs)
    if refine_steps > 0:
        r = rhs - Kmv(dx)
        for _ in range(refine_steps):
            dx_new = dx + solve1(r)
            r_new = rhs - Kmv(dx_new)
            # monotone safeguard, per problem
            better = norm2(r_new) < norm2(r)
            dx = bwhere(better, dx_new, dx)
            r = bwhere(better, r_new, r)
    # a NaN factor must not poison the state
    return bwhere(all_finite(dx), dx, torch.zeros_like(dx))
