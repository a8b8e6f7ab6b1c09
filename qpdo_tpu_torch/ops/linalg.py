"""Dense KKT formation and factorize/solve for the Newton step, batched.

Port of the parts of ``qpdo_tpu/ops/linalg.py`` that the dense batched
solve runs.  The reduced system of every problem b is

    K_b = Q_b + sigma_b*I*[proximal] + A_b' diag(active_b/mu_b) A_b

formed by the fused formation kernel (``ops/fused_formation.py``) and
factored by a Jacobi-prescaled Cholesky, optionally in a reduced
``kkt_dtype`` with iterative refinement (Richardson sweeps or PCG) against
exact state-dtype matvecs.  Cholesky and triangular solves stay on
``torch.linalg``, as the JAX package leaves them to ``lax.linalg``, except
under ``Settings.pallas_kkt``: there the whole solve is the fused kernel
of ``ops/fused_kkt.py``.
"""

from __future__ import annotations

import torch

from .batched import all_finite, bwhere, mtv, mv, norm2
from .cg import pcg
from .fused_formation import fused_formation
from .fused_kkt import fused_kkt_solve


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


def _jacobi_scale(K):
    """(D^-1 K D^-1, dinv) with D = sqrt(diag K); a non-positive diagonal
    entry gets scale 1."""
    d = torch.sqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    d = torch.where(d > 0, d, torch.ones_like(d))
    dinv = 1.0 / d
    return K * dinv[..., :, None] * dinv[..., None, :], dinv


def _cholesky_nan(Khat):
    """Lower Cholesky factor per problem.  Like ``jnp.linalg.cholesky``,
    the input is symmetrized first and a problem whose matrix is not
    positive definite gets an all-NaN factor (``cholesky_ex`` reports it
    instead of raising), so the callers' finiteness guards act on that
    problem alone."""
    Khat = (Khat + Khat.mT) / 2
    chol, info = torch.linalg.cholesky_ex(Khat)
    return bwhere(info == 0, chol, torch.full_like(chol, float("nan")))


def jacobi_cholesky(K):
    """Factor Khat = D^-1 K D^-1 + reg*I with D = sqrt(diag K), per problem.
    Returns (chol(Khat), dinv)."""
    Khat, dinv = _jacobi_scale(K)
    n = K.shape[-1]
    Khat = Khat + _static_reg(K.dtype) * torch.eye(n, dtype=K.dtype,
                                                   device=K.device)
    return _cholesky_nan(Khat), dinv


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


def _state_dtype_kkt_solver(Q, A, active, mu, sigma, proximal: bool):
    """b -> K^-1 b with the factor in the state dtype: the escalation of
    the PCG refinement (``linalg.py:179-213`` of the JAX package) for the
    penalties below which a float32 factor cannot exist.  Jacobi-prescaled
    like the fast path, without the static shift; ``torch.linalg`` factors
    in float64 on the card as on the CPU."""
    K = form_kkt(Q, A, active, mu, sigma, proximal)
    Khat, dinv = _jacobi_scale(K)
    chol = _cholesky_nan(Khat)
    return _prescaled_tri_solver(chol, dinv, Q.dtype)


def _refine(solve1, Kmv, rhs, dx, refine_steps: int):
    """Richardson sweeps dx += solve1(rhs - K dx) with the monotone
    safeguard per problem: refinement diverges once cond(K)*eps(factor
    dtype) > 1, so the better iterate is kept."""
    if refine_steps <= 0:
        return dx
    r = rhs - Kmv(dx)
    for _ in range(refine_steps):
        dx_new = dx + solve1(r)
        r_new = rhs - Kmv(dx_new)
        better = norm2(r_new) < norm2(r)
        dx = bwhere(better, dx_new, dx)
        r = bwhere(better, r_new, r)
    return dx


def _pcg_tol(dt: torch.dtype) -> float:
    return 1e-9 if dt == torch.float64 else 1e-5


def _exact_kmv(Q, A, w, sigma, proximal: bool, kdt, dt):
    """v -> K(w) v with matvecs in ``kdt`` (the KKT dtype for the
    Richardson sweeps, the state dtype for PCG); sigma is (B,)."""
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
                        escalate_rtol: float = 0.0,
                        kkt_mats=None):
    """Form K and solve K dx = rhs per problem (the chol Newton solve).

    Arguments are batched: Q (B, n, n), A (B, m, n), active/mu (B, m),
    sigma (B,), rhs (B, n).  ``pallas_formation`` keeps the arithmetic of
    the JAX package's fused-formation branch (the weights divided in the
    state dtype, then cast, ``linalg.py:266,336``); without it the weights
    are cast first and divided in the KKT dtype (``form_kkt``).  Both reach
    the formation kernel on a CUDA tensor.

    ``pallas_kkt``: the whole solve (formation, Jacobi scaling, Cholesky,
    both substitutions) is one launch of the fused kernel
    (``ops/fused_kkt.py``), in float32 whatever ``kkt_dtype`` says; the
    refinement sweeps re-invoke it.  The JAX package takes this branch for
    any ``kkt_dtype`` on the CPU but only for float32 on a device
    (``linalg.py:269``); the port takes it whenever the flag is set.
    ``kkt_mats``: (Q, A) already cast to float32, for a caller that keeps
    them across calls (``DenseOperator`` does); cast here when absent.

    ``pcg_refine`` > 0 replaces the Richardson sweeps by PCG
    preconditioned by the reduced-precision factor, with state-dtype
    matvecs; where its relative residual ends above ``escalate_rtol`` (or
    NaN) and the factor dtype is reduced, that problem is solved again with
    a factor in the state dtype."""
    if ytilde is not None or res_dual_in is not None:
        raise NotImplementedError(
            "Settings.fused_newton_rhs is not ported yet")
    dt = Q.dtype
    kdt = resolve_dtype(kkt_dtype, dt)
    w = active / mu
    if pallas_kkt:
        f32 = torch.float32
        sig_eff = sigma.to(f32) if proximal else torch.zeros_like(sigma, dtype=f32)
        Q32, A32 = kkt_mats if kkt_mats is not None else (Q.to(f32), A.to(f32))
        w32 = w.to(f32)

        def ksolve(r):
            return fused_kkt_solve(Q32, A32, w32, sig_eff, r.to(f32)).to(dt)

        dx = ksolve(rhs)
        if pcg_refine > 0:
            # PCG against matvecs in the state dtype
            dx, _, _ = pcg(_exact_kmv(Q, A, w, sigma, proximal, dt, dt), rhs,
                           ksolve, _pcg_tol(dt), pcg_refine)
        else:
            dx = _refine(ksolve, _exact_kmv(Q, A, w, sigma, proximal, kdt, dt),
                         rhs, dx, refine_steps)
        return bwhere(all_finite(dx), dx, torch.zeros_like(dx))
    if pallas_formation:
        sig = sigma.to(kdt) if proximal else torch.zeros_like(sigma, dtype=kdt)
        K = fused_formation(A.to(kdt), w.to(kdt), Q.to(kdt), sig)
    else:
        K = form_kkt(Q.to(kdt), A.to(kdt), active.to(kdt), mu.to(kdt),
                     sigma.to(kdt), proximal)
    chol, dinv = jacobi_cholesky(K)
    solve1 = _prescaled_tri_solver(chol, dinv, dt)

    if pcg_refine > 0:
        Kmv_exact = _exact_kmv(Q, A, w, sigma, proximal, dt, dt)
        dx, _, rel = pcg(Kmv_exact, rhs, solve1, _pcg_tol(dt), pcg_refine)
        if escalate_rtol > 0 and kdt != dt:
            esc_ok = rel <= escalate_rtol              # False on NaN
            # lax.cond under vmap computes both sides; here the state-dtype
            # factor is built only when some problem needs it
            if not bool(esc_ok.all()):
                solve64 = _state_dtype_kkt_solver(Q, A, active, mu, sigma,
                                                  proximal)
                dx2 = solve64(rhs)
                dx2 = dx2 + solve64(rhs - Kmv_exact(dx2))
                dx = bwhere(esc_ok, dx, dx2)
    else:
        dx = _refine(solve1, _exact_kmv(Q, A, w, sigma, proximal, kdt, dt),
                     rhs, solve1(rhs), refine_steps)
    # a NaN factor must not poison the state
    return bwhere(all_finite(dx), dx, torch.zeros_like(dx))
