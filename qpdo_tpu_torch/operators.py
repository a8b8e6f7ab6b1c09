"""The dense problem operator, batched.

Port of ``qpdo_tpu/operators.py:DenseOperator`` (l.110-608): the scaled
data of a batch of dense QPs with their matvecs and Newton solves.  Every
vector is (B, n) or (B, m) and every per-problem scalar (B,); the solver
core (``solver/core.py``) is written against this class.  Only the dense
operator exists in the port so far.  Its Newton solves are the modes of
``Settings.kkt_solver`` ("chol", "ns", "inv", "cg") and the incremental
KKT cache of ``Settings.kkt_update_rows``; ``saddle_polish`` is the
polish's solve.

Reduced-precision copies of Q and A (``Qmv(x, dtype=...)`` and friends)
are cast once per operator and kept, where the JAX package relies on XLA
to hoist the loop-invariant cast out of its while loop.
"""

from __future__ import annotations

import torch

from .ops.batched import all_finite, bwhere, mtv, mv, norm2
from .ops.cg import cg_fixed, pcg, pcg_refined
from .ops.linalg import (form_kkt, fused_kkt_route, kkt_cache_build,
                         kkt_inverse, newton_system_solve,
                         newton_system_solve_cached, resolve_dtype,
                         saddle_polish_solve)
from .types import ScaledProblem, Settings, tree_map


def cast_scaled_problem(sp: ScaledProblem, to_dtype) -> ScaledProblem:
    """Cast every leaf of the problem dtype to ``to_dtype``."""
    from_dt = sp.data.Q.dtype
    return tree_map(lambda a: a.to(to_dtype) if a.dtype == from_dt else a, sp)


def _ew_tol(tol: float, rhs, tol_hint):
    """The Eisenstat-Walker forcing term per problem (operators.py:452-457):
    clip(0.05 * tol_hint / ||rhs||, tol, 1e-2), or ``tol`` without a hint."""
    if tol_hint is None:
        return tol
    rhs_norm = torch.clamp(norm2(rhs), min=1e-30)
    return torch.clamp(0.05 * tol_hint / rhs_norm, tol, 1e-2)


class DenseOperator:
    """Dense Q/A of a batch, with the KKT formation kernel and the Newton
    solves of every ``kkt_solver`` mode."""

    def __init__(self, sp: ScaledProblem):
        self.sp = sp
        self._casts = {}

    # -- data accessors (scaled space) --
    q = property(lambda self: self.sp.data.q)
    l = property(lambda self: self.sp.data.l)
    u = property(lambda self: self.sp.data.u)
    c = property(lambda self: self.sp.data.c)
    dtype = property(lambda self: self.sp.data.Q.dtype)
    device = property(lambda self: self.sp.data.Q.device)
    D = property(lambda self: self.sp.scaling.D)
    Dinv = property(lambda self: self.sp.scaling.Dinv)
    E = property(lambda self: self.sp.scaling.E)
    Einv = property(lambda self: self.sp.scaling.Einv)
    cost = property(lambda self: self.sp.scaling.c)
    cinv = property(lambda self: self.sp.scaling.cinv)
    l_finite = property(lambda self: self.sp.l_finite)
    u_finite = property(lambda self: self.sp.u_finite)

    def _mat(self, name: str, dtype: torch.dtype):
        """Q or A in ``dtype``, cast once per operator."""
        base = getattr(self.sp.data, name)
        if dtype == base.dtype:
            return base
        key = (name, dtype)
        if key not in self._casts:
            self._casts[key] = base.to(dtype)
        return self._casts[key]

    # -- vectors --
    def zeros_primal(self):
        B, n = self.sp.data.q.shape
        return torch.zeros((B, n), dtype=self.dtype, device=self.device)

    def zeros_dual(self):
        B, m = self.sp.data.l.shape
        return torch.zeros((B, m), dtype=self.dtype, device=self.device)

    # -- matvecs; ``dtype`` selects a reduced-precision compute path whose
    # result is cast back to the state dtype --
    def _apply(self, name, v, dtype, transpose=False):
        dt = self.dtype
        k = dt if dtype is None else resolve_dtype(dtype, dt)
        M = self._mat(name, k)
        out = (mtv if transpose else mv)(M, v.to(k))
        return out.to(dt)

    def Qmv(self, x, dtype=None):
        return self._apply("Q", x, dtype)

    def Amv(self, x, dtype=None):
        return self._apply("A", x, dtype)

    def Atmv(self, y, dtype=None):
        return self._apply("A", y, dtype, transpose=True)

    # -- paired matvecs: two right-hand sides in one batched GEMM --
    def Amv2(self, xa, xb):
        AV = torch.matmul(self.sp.data.A, torch.stack([xa, xb], dim=-1))
        return AV[..., 0], AV[..., 1]

    def Atmv2(self, ya, yb):
        AtV = torch.matmul(self.sp.data.A.mT, torch.stack([ya, yb], dim=-1))
        return AtV[..., 0], AtV[..., 1]

    def QAmv2(self, xa, xb):
        """(Q xa, Q xb, A xa, A xb).  The JAX package stacks [Q; A] into
        one GEMM to save a TPU dispatch; here it is two batched GEMMs on
        the same pair of columns (the same per-row products)."""
        V = torch.stack([xa, xb], dim=-1)
        QV = torch.matmul(self.sp.data.Q, V)
        AV = torch.matmul(self.sp.data.A, V)
        return QV[..., 0], QV[..., 1], AV[..., 0], AV[..., 1]

    # -- mixed-precision matvecs with exact "hard rows": the GEMM runs in
    # ``dtype`` and the k smallest-mu rows of each problem get an exact
    # product (operators.py:230-255).  ``lax.top_k(-mu, k)`` puts the lower
    # index first among ties, and mu is full of ties at its clip values; a
    # stable ascending argsort picks the same rows in the same order. --
    def _hard_rows(self, mu, k: int):
        return torch.argsort(mu, dim=-1, stable=True)[..., :k]

    def Amv_mixed(self, x, mu, k: int, dtype):
        A = self.sp.data.A
        k = min(k, A.shape[-2])
        fast = self.Amv(x, dtype=dtype)
        idx = self._hard_rows(mu, k)
        rows = torch.gather(A, 1, idx[..., None].expand(-1, -1, A.shape[-1]))
        exact = mv(rows, x)
        return fast.scatter(1, idx, exact)

    def Atmv_mixed(self, y, mu, k: int, dtype):
        A = self.sp.data.A
        k = min(k, A.shape[-2])
        idx = self._hard_rows(mu, k)
        y_soft = y.scatter(1, idx, torch.zeros_like(idx, dtype=y.dtype))
        fast = self.Atmv(y_soft, dtype=dtype)
        rows = torch.gather(A, 1, idx[..., None].expand(-1, -1, A.shape[-1]))
        return fast + mtv(rows, torch.gather(y, 1, idx))

    # -- Newton system solves --
    def newton_solve(self, active, mu, sigma, rhs, settings: Settings,
                     dx_prev=None, tol_hint=None,
                     ytilde=None, res_dual_in=None):
        """The Newton solve without a carried cache: the factorization-free
        CG mode, else the direct (chol) solve
        ``ops/linalg.newton_system_solve``.  ``ytilde``/``res_dual_in``
        select the fused-rhs mode (``rhs`` is then ignored)."""
        d = self.sp.data
        if settings.kkt_solver == "cg":
            return self._newton_solve_cg(active, mu, sigma, rhs, settings,
                                         dx_prev, tol_hint,
                                         ytilde, res_dual_in)
        pcg_iters = settings.kkt_pcg_refine
        if pcg_iters < 0:  # AUTO: only the f32-factor/tiny-mu regime pays
            reduced = resolve_dtype(settings.kkt_dtype, self.dtype) != self.dtype
            pcg_iters = 32 if (reduced and settings.mu_min < 1e-7) else 0
        # the fused solve runs in float32 whatever kkt_dtype says: hand it
        # the casts kept by this operator instead of two copies per call,
        # and only where it runs (fused_kkt_route)
        fused = settings.pallas_kkt and fused_kkt_route(
            self.device.type, resolve_dtype(settings.kkt_dtype, self.dtype))
        kkt_mats = ((self._mat("Q", torch.float32),
                     self._mat("A", torch.float32)) if fused else None)
        return newton_system_solve(d.Q, d.A, active, mu, sigma, rhs,
                                   settings.proximal, settings.refine_steps,
                                   settings.kkt_dtype,
                                   settings.pallas_formation,
                                   ytilde, res_dual_in,
                                   pcg_refine=pcg_iters,
                                   pallas_kkt=settings.pallas_kkt,
                                   escalate_rtol=settings.kkt_escalate_rtol,
                                   kkt_mats=kkt_mats)

    def kkt_cache_init(self, active, mu, settings: Settings, sigma=None):
        """The carried KKT cache, built exactly: the explicit inverse for
        "inv" and "ns", else the incremental (K_tilde, w_applied)."""
        d = self.sp.data
        if settings.kkt_solver in ("inv", "ns"):
            if sigma is None:
                sigma = torch.full(d.q.shape[:1], settings.sigma_init,
                                   dtype=self.dtype, device=self.device)
            return kkt_inverse(d.Q, d.A, active, mu, sigma,
                               settings.proximal, settings.kkt_dtype)
        return kkt_cache_build(d.Q, d.A, active / mu, settings.kkt_dtype)

    def newton_solve_cached(self, active, mu, sigma, rhs,
                            settings: Settings, cache, dx_prev=None,
                            tol_hint=None):
        """The Newton solve with a carried cache.  Returns (dx, cache)."""
        if settings.kkt_solver == "ns":
            return self._newton_solve_ns(active, mu, sigma, rhs, settings,
                                         cache)
        if settings.kkt_solver == "inv":
            return self._newton_solve_inv(active, mu, sigma, rhs, settings,
                                          cache, dx_prev, tol_hint)
        d = self.sp.data
        return newton_system_solve_cached(
            d.Q, d.A, active / mu, sigma, rhs, cache, settings.proximal,
            settings.refine_steps, settings.kkt_dtype,
            settings.kkt_update_rows)

    def _state_kmv(self, active, mu, sigma, proximal: bool):
        """v -> K v with state-dtype matvecs (the refinement's residual)."""
        d = self.sp.data
        w = active / mu

        def Kmv(v):
            Kv = mv(d.Q, v) + mtv(d.A, w * mv(d.A, v))
            if proximal:
                Kv = Kv + sigma[:, None] * v
            return Kv

        return Kmv

    def _newton_solve_inv(self, active, mu, sigma, rhs, settings: Settings,
                          X, dx_prev=None, tol_hint=None):
        """Anchored-inverse Newton solve (operators.py:411-496): form the
        current K and run CG preconditioned by the anchored inverse X, to
        the Eisenstat-Walker tolerance (or ``kkt_cg_fixed`` iterations); in
        a reduced KKT dtype, fixed-count CG inside monotone state-dtype
        refinement.  Returns (dx, X)."""
        dt = self.dtype
        kdt = resolve_dtype(settings.kkt_dtype, dt)
        K = form_kkt(self._mat("Q", kdt), self._mat("A", kdt),
                     active.to(kdt), mu.to(kdt), sigma.to(kdt),
                     settings.proximal)
        iters = settings.kkt_cg_fixed
        Kmv = lambda v: mv(K, v)
        precond = lambda r: mv(X, r)

        if kdt == dt:
            if iters <= 0:
                tol = _ew_tol(1e-9 if dt == torch.float64 else 1e-5, rhs,
                              tol_hint)
                dx, _, _ = pcg(Kmv, rhs, precond, tol,
                               min(settings.cg_max_iter, 4 * K.shape[-1]),
                               x0=dx_prev)
            else:
                dx = cg_fixed(Kmv, rhs, precond, iters, x0=dx_prev)
        else:
            iters_eff = iters if iters > 0 else 8

            def solve_lo(b, x0=None):
                return cg_fixed(Kmv, b.to(kdt), precond, iters_eff,
                                x0=x0).to(dt)

            Kmv_hi = self._state_kmv(active, mu, sigma, settings.proximal)
            dx = solve_lo(rhs, None if dx_prev is None else dx_prev.to(kdt))
            r = rhs - Kmv_hi(dx)
            rn = norm2(r)
            for _ in range(settings.refine_steps):
                dx_new = dx + solve_lo(r)
                r_new = rhs - Kmv_hi(dx_new)
                rn_new = norm2(r_new)
                better = rn_new < rn
                dx = bwhere(better, dx_new, dx)
                r = bwhere(better, r_new, r)
                rn = torch.where(better, rn_new, rn)
        return bwhere(all_finite(dx), dx, torch.zeros_like(dx)), X

    def _newton_solve_cg(self, active, mu, sigma, rhs, settings: Settings,
                         dx_prev=None, tol_hint=None,
                         ytilde=None, res_dual_in=None):
        """Factorization-free Newton solve (operators.py:498-575): form K
        and solve by Jacobi-preconditioned CG warm-started from the
        previous direction, to the Eisenstat-Walker tolerance
        (``kkt_cg_fixed`` > 0: that many iterations); in a reduced KKT
        dtype, ``pcg_refined`` with state-dtype rounds.  Directions are
        inexact (``newton_exact`` is False)."""
        dt = self.dtype
        kdt = resolve_dtype(settings.kkt_dtype, dt)
        if ytilde is not None:  # fused-rhs mode: no GEMM to ride here
            rhs = -(res_dual_in
                    + mtv(self._mat("A", kdt), ytilde.to(kdt)).to(dt))
        K = form_kkt(self._mat("Q", kdt), self._mat("A", kdt),
                     active.to(kdt), mu.to(kdt), sigma.to(kdt),
                     settings.proximal)
        diag = torch.diagonal(K, dim1=-2, dim2=-1)
        pos = diag > 0
        dinv = torch.where(pos, 1.0 / torch.where(pos, diag,
                                                  torch.ones_like(diag)),
                           torch.ones_like(diag))
        tol = _ew_tol(settings.cg_tol if dt == torch.float64 else 1e-5, rhs,
                      tol_hint)
        iters = min(settings.cg_max_iter, 4 * K.shape[-1])
        Kmv = lambda v: mv(K, v)

        if kdt == dt and settings.kkt_cg_fixed > 0:
            dx = cg_fixed(Kmv, rhs, dinv, settings.kkt_cg_fixed, x0=dx_prev)
        elif kdt != dt:
            dx, _, _ = pcg_refined(
                self._state_kmv(active, mu, sigma, settings.proximal), Kmv,
                rhs, dinv, tol, iters, settings.cg_refine_rounds, kdt,
                x0=dx_prev)
        else:
            dx, _, _ = pcg(Kmv, rhs, dinv, tol, iters, x0=dx_prev)
        return bwhere(all_finite(dx), dx, torch.zeros_like(dx))

    def _newton_solve_ns(self, active, mu, sigma, rhs, settings: Settings,
                         X):
        """Newton-Schulz-tracked inverse (operators.py:320-409), per
        problem: form K, damp X by a bound on ||KX||_2, run kkt_ns_steps
        updates X <- X(2I - KX), apply dx = X rhs with one monotone
        Richardson correction (plus one state-dtype correction when the
        KKT dtype is reduced), resymmetrize X, and guard NaNs.
        Returns (dx, X_new)."""
        dt = self.dtype
        kdt = resolve_dtype(settings.kkt_dtype, dt)
        proximal = settings.proximal
        K = form_kkt(self._mat("Q", kdt), self._mat("A", kdt),
                     active.to(kdt), mu.to(kdt), sigma.to(kdt), proximal)
        n = K.shape[-1]
        eye = torch.eye(n, dtype=kdt, device=K.device)
        ns_steps = max(1, settings.kkt_ns_steps)

        KX = torch.matmul(K, X)
        # spectral-radius safeguard per problem: lam >= ||KX||_2
        absKX = torch.abs(KX)
        lam = torch.sqrt(torch.amax(torch.sum(absKX, dim=-1), dim=-1)
                         * torch.amax(torch.sum(absKX, dim=-2), dim=-1))
        c = torch.clamp(1.9 / torch.clamp(lam, min=1e-30), max=1.0)
        X = c[:, None, None] * X
        KX = c[:, None, None] * KX
        for i in range(ns_steps):
            if i > 0:
                KX = torch.matmul(K, X)
            X = torch.matmul(X, 2.0 * eye - KX)
        X = 0.5 * (X + X.mT)

        rhs_k = rhs.to(kdt)
        dx0 = mv(X, rhs_k)
        r0 = rhs_k - mv(K, dx0)
        dx1 = dx0 + mv(X, r0)
        r1 = rhs_k - mv(K, dx1)
        dx = bwhere(norm2(r1) < norm2(r0), dx1, dx0).to(dt)
        if kdt != dt:
            # one state-dtype correction (the kkt_dtype contract)
            Kmv = self._state_kmv(active, mu, sigma, proximal)
            r = rhs - Kmv(dx)
            dx_new = dx + mv(X, r.to(kdt)).to(dt)
            better2 = norm2(rhs - Kmv(dx_new)) < norm2(r)
            dx = bwhere(better2, dx_new, dx)
        # a diverged X must not poison the cache: fall back to Jacobi
        dK = torch.diagonal(K, dim1=-2, dim2=-1)
        pos = dK > 0
        jdiag = torch.where(pos, 1.0 / torch.where(pos, dK, torch.ones_like(dK)),
                            torch.ones_like(dK))
        jac = torch.zeros_like(X) + jdiag[..., :, None] * eye
        X = bwhere(all_finite(X), X, jac)
        dx = bwhere(all_finite(dx), dx, torch.zeros_like(dx))
        return dx, X

    def newton_exact(self, settings: Settings) -> bool:
        """True for "chol", and also for "ns", whose directions are
        inexact: this mirrors a known fault of the JAX package
        (operators.py:591-592), which lets the full-step acceptance take
        tau=1 on Newton-Schulz directions; the port keeps it for parity."""
        return (settings.kkt_update_rows == 0
                and settings.kkt_solver in ("chol", "inv", "ns"))

    def saddle_polish(self, act, bnd, settings: Settings):
        """The polish's saddle solve on the identified active set
        (``ops/linalg.saddle_polish_solve``), LU in ``kkt_dtype``."""
        d = self.sp.data
        return saddle_polish_solve(d.Q, d.A, d.q, act, bnd,
                                   settings.polish_delta,
                                   settings.polish_refine,
                                   settings.kkt_dtype)

    def cast(self, dtype) -> "DenseOperator":
        return DenseOperator(cast_scaled_problem(self.sp, dtype))
