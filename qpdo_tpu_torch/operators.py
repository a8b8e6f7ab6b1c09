"""Problem operators, batched: one algorithm core over interchangeable
linear algebra.

Port of ``qpdo_tpu/operators.py``.  Every operator holds the scaled data
of a batch of QPs with its matvecs and Newton solves; every vector is
(B, n) or (B, m) and every per-problem scalar (B,), and each operator
has a batch size, a device and a dtype.  The solver core
(``solver/core.py``) is written against them.

- ``DenseOperator`` (JAX l.110-608): dense Q/A.  Its Newton solves are the
  modes of ``Settings.kkt_solver`` ("chol", "ns", "inv", "cg") and the
  incremental KKT cache of ``Settings.kkt_update_rows``;
  ``saddle_polish`` is the polish's solve.
- ``RowShardedOperator``: a ``DenseOperator`` that holds one rank's block
  of the constraint rows of a problem whose rows are split over a process
  group (``parallel/row_sharded.py``); its comm (``op.comm``) reduces
  every contraction over the rows.
- ``SparseOperator`` (JAX l.684-1483): sparse triplets of Q/A with the
  matrix-free Newton solves of the large-n path: preconditioned CG
  (Jacobi, block-Jacobi, two-level) and, on banded KKT patterns, the
  exact block-tridiagonal factorization (the sequential scan or block
  cyclic reduction).
- ``BlockAngularOperator`` (JAX l.1484-1627): scenario-structured data
  whose Newton systems are arrow-shaped, solved by a Schur complement
  over batched scenario Cholesky factors.

Reduced-precision copies of Q and A (``Qmv(x, dtype=...)`` and friends)
are cast once per operator and kept, where the JAX package relies on XLA
to hoist the loop-invariant cast out of its while loop.
"""

from __future__ import annotations

import torch

from .ops.batched import all_finite, bwhere, mtv, mv, norm2
from .ops.cg import cg_fixed, pcg, pcg_refined
from .ops.linalg import (_cholesky_nan, cholesky_solve, form_kkt,
                         fused_kkt_route, kkt_cache_build, kkt_inverse,
                         newton_system_solve, newton_system_solve_cached,
                         resolve_dtype, saddle_polish_solve)
from .ops.ordered_sum import ordered_segment_sum
from .types import ScaledProblem, Settings, tree_map

# Every operator may carry a comm (``parallel/comm.py``) in ``comm``: the
# reductions over the entries it splits over the ranks of a process
# group.  None (a single-process operator) changes nothing.


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

    comm = None

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
    batch = property(lambda self: self.sp.data.q.shape[0])
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
        # and only where it runs (fused_kkt_route; not on split rows)
        fused = self.comm is None and settings.pallas_kkt and fused_kkt_route(
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
                                   kkt_mats=kkt_mats, comm=self.comm)

    def kkt_cache_init(self, active, mu, settings: Settings, sigma=None):
        """The carried KKT cache, built exactly: the explicit inverse for
        "inv" and "ns", else the incremental (K_tilde, w_applied)."""
        d = self.sp.data
        if settings.kkt_solver in ("inv", "ns"):
            if sigma is None:
                sigma = torch.full(d.q.shape[:1], settings.sigma_init,
                                   dtype=self.dtype, device=self.device)
            return kkt_inverse(d.Q, d.A, active, mu, sigma,
                               settings.proximal, settings.kkt_dtype,
                               self.comm)
        return kkt_cache_build(d.Q, d.A, active / mu, settings.kkt_dtype,
                               self.comm)

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
            settings.kkt_update_rows, self.comm)

    def _state_kmv(self, active, mu, sigma, proximal: bool):
        """v -> K v with state-dtype matvecs (the refinement's residual)."""
        d = self.sp.data
        w = active / mu

        def Kmv(v):
            AtwAv = mtv(d.A, w * mv(d.A, v))
            if self.comm is not None:
                self.comm.sum(AtwAv)
            Kv = mv(d.Q, v) + AtwAv
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
                     settings.proximal, self.comm)
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
            rhs = -(res_dual_in + self.Atmv(ytilde, dtype=kdt))
        K = form_kkt(self._mat("Q", kdt), self._mat("A", kdt),
                     active.to(kdt), mu.to(kdt), sigma.to(kdt),
                     settings.proximal, self.comm)
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
                     active.to(kdt), mu.to(kdt), sigma.to(kdt), proximal,
                     self.comm)
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


class RowShardedOperator(DenseOperator):
    """A ``DenseOperator`` over one rank's block of the constraint rows of
    a problem whose rows are split over the ranks of ``comm``
    (``parallel/comm.RowComm``): A (B, m_local, n), l, u, E, the dual
    vectors and mu hold the local rows; Q, q, D and the primal vectors
    are replicated.  Each contraction over the rows is a local product
    and one all-reduce: ``Atmv``, ``Atmv2``, the KKT formation (kernel 1
    on the local rows, ``ops/linalg.form_kkt``), the refinement's
    ``A'(w A v)``; the core reduces its own norms and sums through
    ``comm``.  ``Amv``, ``Amv2`` and ``QAmv2`` are row-local.

    The hard rows of the mixed-GEMM phase are the k smallest-mu rows of
    the whole problem: mu is gathered from every rank to pick them, and
    each rank treats the ones it holds; the incremental KKT cache picks
    its rows the same way (``ops/linalg.newton_system_solve_cached``).
    The polish gathers the rows."""

    def __init__(self, sp: ScaledProblem, comm):
        super().__init__(sp)
        self.comm = comm

    def _Atmv_local(self, y, dtype=None):
        return super().Atmv(y, dtype)

    def Atmv(self, y, dtype=None):
        return self.comm.sum(self._Atmv_local(y, dtype))

    def Atmv2(self, ya, yb):
        AtV = torch.matmul(self.sp.data.A.mT, torch.stack([ya, yb], dim=-1))
        self.comm.sum(AtV)
        return AtV[..., 0], AtV[..., 1]

    def _hard_rows(self, mu, k: int):
        """(local row index (B, k), held here (B, k)) of the k
        smallest-mu rows of the whole problem, in the order of the
        single-device pick; a row held elsewhere gets index m_local, one
        past the local rows."""
        m_local = mu.shape[-1]
        idx = super()._hard_rows(self.comm.gather_rows(mu), k)
        lo = self.comm.rank * m_local
        here = (idx >= lo) & (idx < lo + m_local)
        return torch.where(here, idx - lo, m_local), here

    def _rows_of(self, li, here):
        A = self.sp.data.A
        safe = torch.where(here, li, 0)
        return torch.gather(A, 1, safe[..., None].expand(-1, -1, A.shape[-1]))

    def Amv_mixed(self, x, mu, k: int, dtype):
        k = min(k, mu.shape[-1] * self.comm.size)
        li, here = self._hard_rows(mu, k)
        fast = self.Amv(x, dtype=dtype)
        exact = mv(self._rows_of(li, here), x)
        # rows held elsewhere land in a scratch column past the local rows
        ext = torch.cat([fast, torch.zeros_like(fast[:, :1])], dim=1)
        return ext.scatter(1, li, exact)[:, :-1]

    def Atmv_mixed(self, y, mu, k: int, dtype):
        k = min(k, mu.shape[-1] * self.comm.size)
        li, here = self._hard_rows(mu, k)
        ext = torch.cat([y, torch.zeros_like(y[:, :1])], dim=1)
        y_soft = ext.scatter(1, li, torch.zeros_like(li, dtype=y.dtype))
        y_hard = torch.where(here, ext.gather(1, li), 0.0)
        part = (self._Atmv_local(y_soft[:, :-1], dtype=dtype)
                + mtv(self._rows_of(li, here), y_hard))
        return self.comm.sum(part)

    def saddle_polish(self, act, bnd, settings: Settings):
        """The polish's saddle solve on every rank, on the rows gathered
        from every rank (once per polish; the JAX package's GSPMD
        gathers the sharded rows for the LU as well).  Returns x and the
        local rows of y."""
        d = self.sp.data
        g = self.comm.gather_rows
        xp, yp = saddle_polish_solve(d.Q, g(d.A), d.q, g(act), g(bnd),
                                     settings.polish_delta,
                                     settings.polish_refine,
                                     settings.kkt_dtype)
        m_local = act.shape[-1]
        lo = self.comm.rank * m_local
        return xp, yp[:, lo:lo + m_local]

    def cast(self, dtype) -> "RowShardedOperator":
        return RowShardedOperator(cast_scaled_problem(self.sp, dtype),
                                  self.comm)


# ---------------------------------------------------------------------------
# Sparse operator (the large-n path)
# ---------------------------------------------------------------------------

# The state-dtype escalation of the banded solve is compiled in, under
# Settings.robust_gate_auto, only where mu_min can push cond(K) past what
# a float32 factor carries (operators.py:40-44 of the JAX package).
_ESCALATE_MU_FLOOR = 1e-7

# The accuracy-gated scan fallback of cyclic reduction is compiled in,
# under Settings.robust_gate_auto, only where mu_min can push cond(K) past
# ~1e6 with a reduced-precision factor (operators.py:36-43 of the JAX
# package: the CR cancellation class was measured at cond(K) ~ 1e7).
_CR_FALLBACK_MU_FLOOR = 1e-6


def _tri_solve(L, r, lower_trans: bool = False):
    """Solve L z = r (``lower_trans`` False) or L' z = r for lower
    triangular L (..., b, b) and r (..., b)."""
    if lower_trans:
        z = torch.linalg.solve_triangular(L.mT, r[..., None], upper=True)
    else:
        z = torch.linalg.solve_triangular(L, r[..., None], upper=False)
    return z[..., 0]


class SparseOperator:
    """Sparse triplets of Q/A with matrix-free Newton solves, batch-first.

    The large-n replacement of the reference's sparse LDL' backend
    (src/cholmod_interface.c:8-52): K = Q + sigma*I + A' diag(active/mu) A
    is never formed; Newton directions come from Jacobi-, block-Jacobi- or
    two-level-preconditioned CG (``ops/cg.py``), whose matvec is three
    O(nnz) scatter products, or, where the KKT pattern is banded, from the
    exact block-tridiagonal factorization.  Scaled-space data; build it
    with ``qpdo_tpu_torch.solver.sparse.setup_sparse``.

    The float leaves are batch-first, (B, nnz), (B, n), (B, m) and (B,);
    the index leaves (the triplets' (nnz, 2) [row, col] pairs and the
    preconditioner and banded maps of ``solver/sparse.py``) are one copy
    that every problem of the batch shares, so a batch is a fleet of one
    sparsity pattern (``solve_sparse_batch`` puts mixed patterns on their
    union).  This replaces the JAX package's stacking and ``vmap`` over
    per-problem operators.

    A matvec is a scatter over the row-sorted triplets, which takes every
    pattern, or, where the operator carries the ELL maps of its direction
    (``ellQ``, ``ellA``, ``ellAt``: ``solver/sparse.py:_ell_maps``, built
    on a CUDA device as the JAX package builds them off the CPU), a gather
    and a dense row sum (operators.py:777-809).  Every sum into a shared
    target (the scatter matvecs, diag(K), the block-Jacobi, coarse and
    banded blocks) goes through ``ops.ordered_sum.ordered_segment_sum``
    over the segment map that setup built for it (``segQ``, ``segA``,
    ``segAt``, ``segPJ``, ``segPC``, ``segRC``, ``segBD``, ``segBDsub``:
    ``solver/sparse.py:_segment_maps``): each target adds its terms in the
    order of the triplets, as the JAX package's ``.at[].add`` does, with
    the same bits on every run and device.
    """

    FIELDS = ("q_data", "q_idx", "a_data", "a_idx", "diagQ", "q", "l", "u",
              "c", "D", "Dinv", "E", "Einv", "cost", "cinv", "l_finite",
              "u_finite", "pjA", "pjQ", "pcA", "pcQ", "pc_counts", "bdA",
              "bdAsub", "bdQ", "bdQsub", "bd_shape", "ellQ", "ellA", "ellAt",
              "segQ", "segA", "segAt", "segPJ", "segPC", "segRC", "segBD",
              "segBDsub")

    comm = None

    def __init__(self, **fields):
        unknown = set(fields) - set(self.FIELDS)
        if unknown:
            raise TypeError(f"SparseOperator: unknown fields {sorted(unknown)}")
        for name in self.FIELDS:
            setattr(self, name, fields.get(name))
        self._casts = {}

    def _replace(self, **fields) -> "SparseOperator":
        kw = {name: getattr(self, name) for name in self.FIELDS}
        kw.update(fields)
        return SparseOperator(**kw)

    dtype = property(lambda self: self.q.dtype)
    device = property(lambda self: self.q.device)
    batch = property(lambda self: self.q.shape[0])
    n = property(lambda self: self.q.shape[-1])
    m = property(lambda self: self.l.shape[-1])

    def zeros_primal(self):
        return torch.zeros((self.batch, self.n), dtype=self.dtype,
                           device=self.device)

    def zeros_dual(self):
        return torch.zeros((self.batch, self.m), dtype=self.dtype,
                           device=self.device)

    # -- matvecs --
    def _data(self, name: str, dtype: torch.dtype):
        """q_data or a_data in ``dtype``, cast once per operator."""
        base = getattr(self, name)
        if dtype == base.dtype:
            return base
        key = (name, dtype)
        if key not in self._casts:
            self._casts[key] = base.to(dtype)
        return self._casts[key]

    def _scatter_mv(self, name, seg, cols, x, dtype):
        """out[:, t] = the sum over k with target t of the segment map
        ``seg`` of data[:, k] * x[:, cols[k]], in map order, in ``dtype``
        (the state dtype when None) and returned in the state dtype."""
        cd = self.dtype if dtype is None else resolve_dtype(dtype, self.dtype)
        data = self._data(name, cd)
        prod = data * x.index_select(1, cols).to(cd)
        return ordered_segment_sum(prod, seg).to(self.dtype)

    def _ell_vals(self, name, which, dtype: torch.dtype):
        """data[:, gather] * mask of the ELL map ``which`` in ``dtype``,
        (B, out, K), gathered once per operator."""
        key = ("ell", name, which, dtype)
        if key not in self._casts:
            g, _, mask = getattr(self, which)
            self._casts[key] = self._data(name, dtype)[:, g] * mask.to(dtype)
        return self._casts[key]

    def _ell_mv(self, name, which, x, dtype):
        """out[:, i] = sum_k data[:, g[i, k]] * x[:, idx[i, k]] * mask[i, k]:
        a gather and a dense row sum, no scatter."""
        cd = self.dtype if dtype is None else resolve_dtype(dtype, self.dtype)
        idx = getattr(self, which)[1]
        out = (self._ell_vals(name, which, cd) * x.to(cd)[:, idx]).sum(-1)
        return out.to(self.dtype)

    def Qmv(self, x, dtype=None):
        if self.ellQ is not None:
            return self._ell_mv("q_data", "ellQ", x, dtype)
        return self._scatter_mv("q_data", self.segQ, self.q_idx[:, 1], x,
                                dtype)

    def Amv(self, x, dtype=None):
        if self.ellA is not None:
            return self._ell_mv("a_data", "ellA", x, dtype)
        return self._scatter_mv("a_data", self.segA, self.a_idx[:, 1], x,
                                dtype)

    def Atmv(self, y, dtype=None):
        # A' y re-uses the same triplets with roles swapped
        if self.ellAt is not None:
            return self._ell_mv("a_data", "ellAt", y, dtype)
        return self._scatter_mv("a_data", self.segAt, self.a_idx[:, 0], y,
                                dtype)

    def _pair_mv(self, name, which, seg, cols, xa, xb):
        """Two right-hand sides in one product: the ELL gather where the
        map exists, else one ordered segment sum of both, (2B, terms)."""
        X = torch.stack([xa, xb], dim=-1)
        if getattr(self, which) is not None:
            idx = getattr(self, which)[1]
            vals = self._ell_vals(name, which, self.dtype)
            V = (vals[..., None] * X[:, idx, :]).sum(-2)
            return V[..., 0], V[..., 1]
        prod = getattr(self, name)[:, :, None] * X.index_select(1, cols)
        Bn = X.shape[0]
        V = ordered_segment_sum(prod.transpose(1, 2).reshape(2 * Bn, -1),
                                seg).view(Bn, 2, -1)
        return V[:, 0], V[:, 1]

    def Amv2(self, xa, xb):
        return self._pair_mv("a_data", "ellA", self.segA, self.a_idx[:, 1],
                             xa, xb)

    def Atmv2(self, ya, yb):
        return self._pair_mv("a_data", "ellAt", self.segAt,
                             self.a_idx[:, 0], ya, yb)

    def Qmv2(self, xa, xb):
        return self._pair_mv("q_data", "ellQ", self.segQ, self.q_idx[:, 1],
                             xa, xb)

    def diag_K(self, active, mu, sigma, proximal: bool):
        """diag(K) in O(nnz) without forming K: diag(Q) + sigma +
        sum_i (active_i/mu_i) A_ij^2 per column j; with the ``ellAt`` map
        a gather over each column's entries (its idx are their rows)."""
        w = active / mu
        if self.ellAt is not None:
            ridx = self.ellAt[1]
            vals = self._ell_vals("a_data", "ellAt", self.dtype)
            d = (w[:, ridx] * torch.square(vals)).sum(-1)
        else:
            d = ordered_segment_sum(
                w.index_select(1, self.a_idx[:, 0])
                * torch.square(self.a_data), self.segAt)
        d = d + self.diagQ
        if proximal:
            d = d + sigma[:, None]
        return d

    def _Kmv(self, w, sigma, proximal: bool):
        def Kmv(v):
            Kv = self.Qmv(v) + self.Atmv(w * self.Amv(v))
            if proximal:
                Kv = Kv + sigma[:, None] * v
            return Kv
        return Kmv

    # -- preconditioners --
    def _block_diagonal(self, pairs, qpart, seg, w, nblocks, b):
        """Stack of (B, nblocks, b, b) blocks: the w-weighted products of
        same-row A pairs ``pairs`` = (t1, t2, rows, blk, o1, o2), then the
        Q entries ``qpart`` = (t, blk, o1, o2), added in map order (the
        segment map ``seg`` holds both, A's terms first)."""
        t1, t2, rows_p = pairs[:3]
        vals = self.a_data[:, t1] * self.a_data[:, t2] * w[:, rows_p]
        terms = torch.cat([vals, self.q_data[:, qpart[0]]], dim=1)
        return ordered_segment_sum(terms, seg).view(self.batch, nblocks, b, b)

    @staticmethod
    def _lift_diagonal(M, sigma, proximal: bool):
        """Add sigma (or 0) to the diagonal of every block, and 1 more where
        the diagonal would stay at or below 0 (padded tail, untouched
        variables)."""
        diag = torch.diagonal(M, dim1=-2, dim2=-1)
        shift = (sigma if proximal else torch.zeros_like(sigma))[:, None, None]
        bump = torch.where(diag + shift > 0, shift, shift + 1.0)
        diag.add_(bump)
        return M

    def _block_jacobi_apply(self, w, sigma, dinv_jacobi, settings: Settings):
        """Build the block diagonal of K matrix-free and return the
        preconditioner apply r -> M^-1 r (operators.py:859-913).

        The blocks are assembled by an ordered segment sum over the
        precomputed same-row, same-block pairs of A (pjA) and Q's in-block
        entries (pjQ), then factored by one batched dense Cholesky in
        ``precond_dtype``.  A block whose factor fails (NaN) falls back to
        its Jacobi rows."""
        b = settings.precond_block
        n = self.n
        nb = -(-n // b)
        dt = self.dtype
        Bn = self.batch
        blocks = self._block_diagonal(self.pjA, self.pjQ, self.segPJ, w, nb,
                                      b)
        blocks = self._lift_diagonal(blocks, sigma, settings.proximal)
        # factor in precond_dtype: the preconditioner only steers CG
        pdt = resolve_dtype(settings.precond_dtype, dt)
        chol = _cholesky_nan(blocks.to(pdt))
        ok = torch.isfinite(chol).all(dim=-1).all(dim=-1)          # (B, nb)
        pad = nb * b - n
        ones = torch.ones((Bn, pad), dtype=dt, device=self.device)
        dj = torch.cat([dinv_jacobi, ones], dim=1) if pad else dinv_jacobi
        dj = dj.reshape(Bn, nb, b)

        coarse = None
        if settings.precond_two_level and self.pcA is not None:
            coarse = self._coarse_apply(w, sigma, settings)

        def apply(r):
            rp = (torch.cat([r, torch.zeros((Bn, pad), dtype=dt,
                                            device=r.device)], dim=1)
                  if pad else r)
            rb = rp.reshape(Bn, nb, b)
            z = _tri_solve(chol, rb.to(pdt))
            z = _tri_solve(chol, z, lower_trans=True).to(dt)
            z = torch.where(ok[..., None], z, dj * rb)
            z = z.reshape(Bn, nb * b)[:, :n]
            if coarse is not None:
                z = z + coarse(r)
            return z

        return apply

    def _coarse_matrix(self, w):
        """P'(Q + A'WA)P, (B, nc, nc): the w-weighted products of same-row A
        pairs ``pcA`` and the Q entries ``pcQ`` in their coarse cells,
        added in map order (``segPC``, A's terms first)."""
        nc = self.pc_counts.shape[0]
        t1, t2, rows_p = self.pcA[:3]
        vals = self.a_data[:, t1] * self.a_data[:, t2] * w[:, rows_p]
        return ordered_segment_sum(torch.cat([vals, self.q_data], dim=1),
                                   self.segPC).view(self.batch, nc, nc)

    def _coarse_apply(self, w, sigma, settings: Settings):
        """Two-level additive coarse correction r -> P Kc^-1 P' r with P
        the piecewise-constant aggregation of ``precond_block`` columns
        (operators.py:915-956): Kc = P'KP is assembled matrix-free from
        the precomputed maps and factored densely at nc = ceil(n / block),
        with a relative diagonal shift; a failed factor disables the
        correction for that problem."""
        dt = self.dtype
        nc = self.pc_counts.shape[0]
        Kc = self._coarse_matrix(w)
        counts = self.pc_counts.to(dt)
        shift = sigma if settings.proximal else torch.zeros_like(sigma)
        diag = torch.diagonal(Kc, dim1=-2, dim2=-1)
        diag.add_(shift[:, None] * counts)
        # relative regularization keeps a semidefinite coarse matrix
        # factorizable; a NaN factor disables the correction entirely
        tr = torch.sum(torch.abs(diag), dim=-1) / nc
        diag.add_((1e-10 * tr + 1e-30)[:, None])
        pdt = resolve_dtype(settings.precond_dtype, dt)
        cholc = _cholesky_nan(Kc.to(pdt))
        ok = torch.isfinite(cholc).flatten(1).all(dim=1)
        cgrid = self.segRC[0]                 # the aggregate of each column

        def coarse(r):
            rc = ordered_segment_sum(r, self.segRC)
            z = _tri_solve(cholc, rc.to(pdt))
            z = _tri_solve(cholc, z, lower_trans=True).to(dt)
            z = torch.where(ok[:, None], z, torch.zeros_like(z))
            return z.index_select(1, cgrid)

        return coarse

    # -- Newton solves --
    def newton_exact(self, settings: Settings) -> bool:
        """Whether ``newton_solve`` returns exact (direct) directions: only
        the banded factorization does.  The full-step acceptance
        (Settings.newton_full_step) is only sound for exact directions."""
        return self.bd_shape is not None and settings.newton_direct

    def _assemble_banded(self, w, sigma, settings: Settings):
        """The block-tridiagonal form of K = Q + sigma*I + A'WA by ordered
        segment sums over the banded maps (operators.py:966-1016): D
        (B, nb, b, b) diagonal blocks, E (B, max(nb-1, 1), b, b)
        sub-diagonal blocks E_k = K[k+1, k], both Jacobi-equilibrated in
        the state dtype (``banded_jacobi_scale``: S K S with S =
        diag(K)^-1/2) and then cast to the KKT dtype.  Returns (D, E, s)."""
        dt = self.dtype
        nb, b = self.bd_shape
        D = self._block_diagonal(self.bdA, self.bdQ, self.segBD, w, nb, b)
        E = self._block_diagonal(self.bdAsub, self.bdQsub, self.segBDsub, w,
                                 max(nb - 1, 1), b)
        D = self._lift_diagonal(D, sigma, settings.proximal)
        if settings.banded_jacobi_scale:
            s = torch.rsqrt(torch.diagonal(D, dim1=-2, dim2=-1))  # (B, nb, b)
            D = D * s[..., :, None] * s[..., None, :]
            if nb > 1:
                E = E * s[:, 1:, :, None] * s[:, :-1, None, :]
        else:
            s = torch.ones((self.batch, nb, b), dtype=dt, device=self.device)
        kdt = resolve_dtype(settings.kkt_dtype, dt)
        if kdt != dt:
            D, E = D.to(kdt), E.to(kdt)
        return D, E, s

    @staticmethod
    def _banded_factor_scan(D, E):
        """Sequential block-tridiagonal Cholesky K = L L' with
        block-bidiagonal L (operators.py:1064-1111), per problem of the
        batch: L_0 = chol(D_0), M_k' = L_{k-1}^-1 E_{k-1}',
        L_k = chol(D_k - M_k M_k').  A Python loop over the nb blocks.
        Returns solve(rb: (B, nb, b)) -> (B, nb, b)."""
        nb = D.shape[1]
        Ls = [_cholesky_nan(D[:, 0])]
        Mts = []
        for k in range(1, nb):
            Mt = torch.linalg.solve_triangular(Ls[-1], E[:, k - 1].mT,
                                               upper=False)
            Ls.append(_cholesky_nan(D[:, k] - Mt.mT @ Mt))
            Mts.append(Mt)

        def solve(rb):
            # forward: u_k = L_k^-1 (r_k - M_k u_{k-1})
            U = [_tri_solve(Ls[0], rb[:, 0])]
            for k in range(1, nb):
                prod = (Mts[k - 1].mT @ U[-1][..., None])[..., 0]
                U.append(_tri_solve(Ls[k], rb[:, k] - prod))
            # backward: z_k = L_k^-T (u_k - M_{k+1}' z_{k+1})
            Z = [None] * nb
            Z[nb - 1] = _tri_solve(Ls[nb - 1], U[nb - 1], lower_trans=True)
            for k in range(nb - 2, -1, -1):
                prod = (Mts[k] @ Z[k + 1][..., None])[..., 0]
                Z[k] = _tri_solve(Ls[k], U[k] - prod, lower_trans=True)
            return torch.stack(Z, dim=1)

        return solve

    @staticmethod
    def _banded_factor_cr(D, E, max_levels: int = 0):
        """Block cyclic reduction (operators.py:1113-1206), per problem of
        the batch: every level eliminates the odd-indexed blocks with one
        batched Cholesky and batched triangular solves and GEMMs over ~k/2
        blocks, halving the system, so the depth is ~log2(nb) levels
        where the scan's is nb blocks.

        ``max_levels`` > 0 stops after that many levels and finishes the
        coarse remainder with the scan factorization (float32 Schur
        updates compound across levels; the scan is the stable finish).
        A pivot block that is not positive definite gives NaN in that
        problem only.  D is (B, nb, b, b), E (B, >= nb-1, b, b) with
        E_k = K[k+1, k].  Returns solve(rb: (B, nb, b)) -> (B, nb, b)."""
        def chs(L, X):
            return torch.linalg.solve_triangular(
                L.mT, torch.linalg.solve_triangular(L, X, upper=False),
                upper=True)

        zblk = torch.zeros_like(D[:, :1])
        levels = []
        while D.shape[1] > 1 and (max_levels <= 0
                                  or len(levels) < max_levels):
            k = D.shape[1]
            no, ne = k // 2, k - k // 2
            # odd blocks j = 2t+1, t = 0..no-1; kept evens i = 2e
            Lo = _cholesky_nan(D[:, 1::2])
            Epad = torch.cat([E[:, :k - 1], zblk], dim=1)    # (B, k, b, b)
            Ejm1 = Epad[:, 0::2][:, :no]        # E_{j-1} for odd j
            Ej = Epad[:, 1::2][:, :no]          # E_j (zero when j = k-1)
            Ua = chs(Lo, Ejm1)                  # D_j^-1 E_{j-1}
            Ub = chs(Lo, Ej.mT)                 # D_j^-1 E_j'
            # Schur updates of the kept evens: from the left odd
            # (lands on even t+1) and from the right odd (lands on even t);
            # when k is even the last odd has no right even, and its
            # zero-padded E_j makes the dropped tail exactly zero
            left = Ej @ Ub
            right = Ejm1.mT @ Ua
            Dnew = D[:, 0::2].clone()
            Dnew[:, 1:] -= left[:, :ne - 1]
            Dnew[:, :no] -= right
            # the new coupling of kept evens (e, e+1): -E_j D_j^-1 E_{j-1}
            Enew = -(Ej @ Ua)[:, :ne - 1]
            levels.append((Lo, Ua, Ub, Ejm1, Ej, k, no, ne))
            D, E = Dnew, Enew
        if D.shape[1] == 1:
            Lfin = _cholesky_nan(D[:, 0])

            def coarse_solve(r):
                return chs(Lfin, r[:, 0, :, None])[..., 0][:, None]
        else:
            coarse_solve = SparseOperator._banded_factor_scan(D, E)

        def solve(rb):
            rs_odd = []
            r = rb
            for Lo, Ua, Ub, Ejm1, Ej, k, no, ne in levels:
                yo = chs(Lo, r[:, 1::2, :, None])[..., 0]     # (B, no, b)
                rs_odd.append(yo)
                rnew = r[:, 0::2].clone()
                rnew[:, 1:] -= (Ej @ yo[..., None])[..., 0][:, :ne - 1]
                rnew[:, :no] -= (Ejm1.mT @ yo[..., None])[..., 0]
                r = rnew
            x = coarse_solve(r)
            for (Lo, Ua, Ub, Ejm1, Ej, k, no, ne), yo in zip(
                    reversed(levels), reversed(rs_odd)):
                xl = x[:, :no]                                 # x_{j-1}
                xr = torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])],
                               dim=1)[:, :no]                  # x_{j+1}
                xo = (yo - (Ua @ xl[..., None])[..., 0]
                      - (Ub @ xr[..., None])[..., 0])
                full = x.new_empty((x.shape[0], k, x.shape[2]))
                full[:, 0::2] = x
                full[:, 1::2] = xo
                x = full
            return x

        return solve

    def _banded_solve(self, w, sigma, rhs, settings: Settings):
        """Exact block-tridiagonal solve of K dx = rhs
        (operators.py:1208-1393), the banded-pattern replacement of the
        reference's sparse LDL' (cholmod_interface.c:8-30, 98-102): the
        factorization in the KKT dtype (``banded_algo`` "scan", the
        sequential block Cholesky, or "cr", block cyclic reduction;
        "auto" is CR on a CUDA tensor and the scan on a CPU tensor, as
        the JAX package picks CR off the CPU), refined on the true system
        by state-dtype PCG preconditioned by the factor
        (``banded_pcg_refine`` > 0, at most that many iterations) or by
        monotone Richardson sweeps (0: ``refine_steps``, keeping the
        better iterate by true residual).  Then two gates, each per
        problem: a CR solve whose refined residual stays above
        ``banded_cr_fallback_rtol`` is re-solved with the scan factor,
        and, with a reduced KKT dtype, a solve whose residual stays above
        ``banded_escalate_rtol`` is re-solved with a state-dtype scan
        factor and one correction sweep.  The JAX package's ``lax.cond``
        around each becomes, for a batch, a per-problem select (as its
        ``vmap`` lowers it), computed only when some problem fails the
        gate.  NaN residuals fail both gates."""
        dt = self.dtype
        nb, b = self.bd_shape
        n = self.n
        Bn = self.batch
        pad = nb * b - n
        kdt = resolve_dtype(settings.kkt_dtype, dt)
        D, E, s = self._assemble_banded(w, sigma, settings)
        Kmv = self._Kmv(w, sigma, settings.proximal)
        algo = settings.banded_algo
        if algo == "auto":
            algo = "scan" if self.device.type == "cpu" else "cr"

        def solver(factor, s_blocks, in_dtype):
            s_flat = s_blocks.reshape(Bn, nb * b)[:, :n]

            def solve(r):
                r = (r * s_flat).to(in_dtype)
                if pad:
                    r = torch.cat([r, torch.zeros((Bn, pad), dtype=in_dtype,
                                                  device=r.device)], dim=1)
                z = factor(r.reshape(Bn, nb, b)).reshape(Bn, nb * b).to(dt)
                return z[:, :n] * s_flat
            return solve

        rhs_n = torch.clamp(norm2(rhs), min=1e-30)

        def run(factor):
            """Solve and refine with one factor: (dx, ||rhs - K dx||)."""
            solve = solver(factor, s, kdt)
            pcg_iters = int(settings.banded_pcg_refine)
            if pcg_iters > 0:
                tol = 1e-9 if dt == torch.float64 else 1e-5
                dx, _, rel = pcg(Kmv, rhs, solve, tol, pcg_iters)
                return dx, rel * rhs_n
            dx = solve(rhs)
            r = rhs - Kmv(dx)
            rn = norm2(r)
            for _ in range(settings.refine_steps):
                dx_new = dx + solve(r)
                r_new = rhs - Kmv(dx_new)
                rn_new = norm2(r_new)
                better = rn_new < rn
                dx = bwhere(better, dx_new, dx)
                r = bwhere(better, r_new, r)
                rn = torch.where(better, rn_new, rn)
            return dx, rn

        # Settings.robust_gate_auto: each fallback exists only where its
        # failure regime is reachable from the static settings
        # (operators.py:1319-1336).  This mirrors a fault of the
        # reference (ADVICE.md, round 5; ROADMAP.md Queue 3): the gate
        # reads mu_min alone, while cond(K) also depends on the data, so
        # an ill-scaled problem at mu_min >= 1e-6 with a float32 factor
        # keeps a NaN CR direction instead of falling back to the scan.
        auto = settings.robust_gate_auto
        reduced_factor = torch.finfo(kdt).eps > 1e-10
        if algo == "cr":
            dx, rn = run(self._banded_factor_cr(D, E,
                                                settings.banded_cr_levels))
            rtol = settings.banded_cr_fallback_rtol
            if rtol > 0 and (not auto or (
                    reduced_factor
                    and settings.mu_min < _CR_FALLBACK_MU_FLOOR)):
                ok = rn <= rtol * rhs_n              # False on NaN
                if not bool(ok.all()):
                    dx_scan, rn_scan = run(self._banded_factor_scan(D, E))
                    dx = bwhere(ok, dx, dx_scan)
                    rn = torch.where(ok, rn, rn_scan)
        else:
            dx, rn = run(self._banded_factor_scan(D, E))

        esc_rtol = settings.banded_escalate_rtol
        if esc_rtol > 0 and kdt != dt and (
                not auto or settings.mu_min < _ESCALATE_MU_FLOOR):
            esc_ok = rn <= esc_rtol * rhs_n          # False on NaN
            if not bool(esc_ok.all()):
                D64, E64, s64 = self._assemble_banded(
                    w, sigma, settings.replace(kkt_dtype=None))
                solve64 = solver(self._banded_factor_scan(D64, E64), s64, dt)
                dx2 = solve64(rhs)
                dx2 = dx2 + solve64(rhs - Kmv(dx2))
                dx = bwhere(esc_ok, dx, dx2)
        return bwhere(all_finite(dx), dx, torch.zeros_like(dx))

    def newton_solve(self, active, mu, sigma, rhs, settings: Settings,
                     dx_prev=None, tol_hint=None):
        """K dx = rhs per problem (operators.py:1395-1472): the banded
        direct solve where the maps exist and ``newton_direct`` is set;
        else matrix-free PCG warm-started from the previous direction, to
        the Eisenstat-Walker tolerance clip(0.05 * eps_in / ||rhs||,
        cg_tol, 1e-2), with the block-Jacobi (and two-level)
        preconditioner or Jacobi; with ``cg_dtype`` set, mixed-precision
        ``pcg_refined`` (inner CG, matvecs and preconditioner in
        ``cg_dtype``, inside state-dtype refinement rounds)."""
        w = active / mu
        if self.bd_shape is not None and settings.newton_direct:
            return self._banded_solve(w, sigma, rhs, settings)
        proximal = settings.proximal
        Kmv = self._Kmv(w, sigma, proximal)
        tol = _ew_tol(settings.cg_tol, rhs, tol_hint)
        block_jacobi = (settings.precond == "block_jacobi"
                        and self.pjA is not None)

        cg_dt = resolve_dtype(settings.cg_dtype, self.dtype)
        if cg_dt != self.dtype:
            op_lo = self.cast(cg_dt)
            w_lo = w.to(cg_dt)
            sigma_lo = sigma.to(cg_dt)
            Kmv_lo = op_lo._Kmv(w_lo, sigma_lo, proximal)
            d_lo = op_lo.diag_K(active.to(cg_dt), mu.to(cg_dt), sigma_lo,
                                proximal)
            pos = d_lo > 0
            dinv_lo = torch.where(pos, 1.0 / torch.where(pos, d_lo, 1.0), 1.0)
            precond_lo = (op_lo._block_jacobi_apply(w_lo, sigma_lo, dinv_lo,
                                                    settings)
                          if block_jacobi else dinv_lo)
            dx, _, _ = pcg_refined(Kmv, Kmv_lo, rhs, precond_lo, tol,
                                   settings.cg_max_iter,
                                   settings.cg_refine_rounds, cg_dt,
                                   x0=dx_prev)
            return bwhere(all_finite(dx), dx, torch.zeros_like(dx))

        d = self.diag_K(active, mu, sigma, proximal)
        pos = d > 0
        dinv = torch.where(pos, 1.0 / torch.where(pos, d, 1.0), 1.0)
        precond = (self._block_jacobi_apply(w, sigma, dinv, settings)
                   if block_jacobi else dinv)
        dx, _, _ = pcg(Kmv, rhs, precond, tol, settings.cg_max_iter,
                       x0=dx_prev)
        # NaN guard, mirroring the dense path
        return bwhere(all_finite(dx), dx, torch.zeros_like(dx))

    def cast(self, dtype) -> "SparseOperator":
        """Every float leaf of the operator's dtype in ``dtype`` (the index
        maps are shared); the cast is kept, so that the mixed-precision CG
        casts once per operator."""
        if dtype == self.dtype:
            return self
        key = ("op", dtype)
        if key not in self._casts:
            from_dt = self.dtype
            conv = lambda a: (a.to(dtype) if isinstance(a, torch.Tensor)
                              and a.dtype == from_dt else a)
            self._casts[key] = self._replace(
                **{name: conv(getattr(self, name)) for name in self.FIELDS})
        return self._casts[key]


class BlockAngularOperator:
    """Scenario-structured (block-angular) QPs of a batch, with arrow-KKT
    Newton solves (operators.py:1484-1627).

    Problems  min 0.5 x0'Q0 x0 + sum_s 0.5 xs'Qs xs + q0'x0 + sum_s qs'xs
              s.t.  l_s <= T_s x0 + W_s x_s <= u_s
    (two-stage stochastic programs, scenario MPC).  The semismooth-Newton
    KKT matrix is exactly arrow-structured, so every Newton solve is a
    Schur complement over the scenarios' Cholesky factors
    (``ops/schur.py``).

    The JAX package carries the primal side as an (x0, xs) pytree.  The
    port's core works on (B, n) tensors, so here every vector is flat: a
    primal vector is (B, n0 + S*ns), x0 then the scenarios' xs in order,
    and a dual vector (B, S*ms), scenario by scenario; each matvec and the
    Newton solve view them as (x0, xs) and (S, ms).  The inf-norms and
    inner products of the core over a flat vector are the JAX package's
    ``tnorm_inf``/``tdot`` over the tuple (operators.py:61-80), summed in
    one pass instead of leaf by leaf.  The matrices are batch-first: Q0
    (B, n0, n0), Qs (B, S, ns, ns), T (B, S, ms, n0), W (B, S, ms, ns).
    Build it with ``solver.structured.scale_block_angular``.  There is no
    ``Amv_mixed`` and no ``kkt_cache_init``, so the core's operator gates
    skip the mixed phase and the carried cache, as the JAX core's
    ``hasattr`` gates do.

    Scenario-sharded (``comm``, a ``parallel/comm.ScenarioComm``): the
    operator holds this rank's scenarios (Qs, T, W, the scenario parts of
    q, D and the dual vectors) and the replicated x0 block; the sums over
    the scenarios (T'y in ``Atmv``, the Schur complement S0 and its
    right-hand side in ``newton_solve``) are local sums and one
    all-reduce each, and the core reduces its norms and inner products
    through ``comm``.
    """

    FIELDS = ("Q0", "Qs", "T", "W", "q", "l", "u", "c", "D", "Dinv", "E",
              "Einv", "cost", "cinv", "l_finite", "u_finite")

    def __init__(self, comm=None, **fields):
        unknown = set(fields) - set(self.FIELDS)
        if unknown:
            raise TypeError(f"BlockAngularOperator: unknown fields "
                            f"{sorted(unknown)}")
        for name in self.FIELDS:
            setattr(self, name, fields[name])
        self.comm = comm
        self._casts = {}

    dtype = property(lambda self: self.Q0.dtype)
    device = property(lambda self: self.Q0.device)
    batch = property(lambda self: self.Q0.shape[0])
    shapes = property(lambda self: (self.T.shape[1], self.T.shape[2],
                                    self.T.shape[3], self.W.shape[3]))

    def zeros_primal(self):
        return torch.zeros_like(self.q)

    def zeros_dual(self):
        return torch.zeros_like(self.l)

    def split_primal(self, x):
        """A flat (B, n, ...) primal vector as (x0 (B, n0, ...), xs
        (B, S, ns, ...))."""
        S, _, n0, ns = self.shapes
        return x[:, :n0], x[:, n0:].reshape(x.shape[0], S, ns, *x.shape[2:])

    def _mats(self, dtype):
        """(Q0, Qs, T, W) in ``dtype`` (the state dtype when None), cast
        once per operator."""
        k = self.dtype if dtype is None else resolve_dtype(dtype, self.dtype)
        if k == self.dtype:
            return self.Q0, self.Qs, self.T, self.W
        if k not in self._casts:
            self._casts[k] = tuple(a.to(k) for a in (self.Q0, self.Qs,
                                                     self.T, self.W))
        return self._casts[k]

    def Qmv(self, x, dtype=None):
        Q0, Qs, _, _ = self._mats(dtype)
        x0, xs = self.split_primal(x.to(Q0.dtype))
        r0 = mv(Q0, x0)
        rs = (Qs @ xs[..., None])[..., 0]
        return torch.cat([r0, rs.flatten(1)], dim=1).to(self.dtype)

    def Amv(self, x, dtype=None):
        _, _, T, W = self._mats(dtype)
        x0, xs = self.split_primal(x.to(T.dtype))
        r = (T @ x0[:, None, :, None] + W @ xs[..., None])[..., 0]
        return r.flatten(1).to(self.dtype)

    def Atmv(self, y, dtype=None):
        _, _, T, W = self._mats(dtype)
        S, ms, _, _ = self.shapes
        yk = y.to(T.dtype).reshape(y.shape[0], S, ms, 1)
        r0 = (T.mT @ yk)[..., 0].sum(dim=1)
        if self.comm is not None:
            self.comm.sum(r0)
        rs = (W.mT @ yk)[..., 0]
        return torch.cat([r0, rs.flatten(1)], dim=1).to(self.dtype)

    # -- paired matvecs: two right-hand sides in one batched product --
    def Amv2(self, xa, xb):
        x0, xs = self.split_primal(torch.stack([xa, xb], dim=-1))
        R = self.T @ x0[:, None] + self.W @ xs          # (B, S, ms, 2)
        R = R.flatten(1, 2)
        return R[..., 0], R[..., 1]

    def Atmv2(self, ya, yb):
        S, ms, _, _ = self.shapes
        Y = torch.stack([ya, yb], dim=-1).reshape(ya.shape[0], S, ms, 2)
        R0 = (self.T.mT @ Y).sum(dim=1)                 # (B, n0, 2)
        if self.comm is not None:
            self.comm.sum(R0)
        Rs = (self.W.mT @ Y).flatten(1, 2)              # (B, S*ns, 2)
        R = torch.cat([R0, Rs], dim=1)
        return R[..., 0], R[..., 1]

    def Qmv2(self, xa, xb):
        x0, xs = self.split_primal(torch.stack([xa, xb], dim=-1))
        R = torch.cat([self.Q0 @ x0, (self.Qs @ xs).flatten(1, 2)], dim=1)
        return R[..., 0], R[..., 1]

    def newton_exact(self, settings: Settings) -> bool:
        """The Schur solve is a direct factorization: exact directions
        (the JAX core's default for operators without ``newton_exact``)."""
        return True

    def newton_solve(self, active, mu, sigma, rhs, settings: Settings,
                     dx_prev=None, tol_hint=None):
        """The arrow-KKT Schur-complement solve of K dx = rhs: the scenario
        blocks K_ss = Qs + W' diag(w) W (+ sigma I) and couplings
        B_s = W' diag(w) T factored and applied in one batched Cholesky
        solve against [B_s | r_s], the reduction over the scenarios, the
        n0 x n0 coupled solve, back-substitution, each Cholesky solve with
        ``refine_steps`` sweeps; a non-finite direction becomes zero per
        problem, as on the dense path."""
        from .ops.schur import local_contribution

        S, ms, n0, ns = self.shapes
        Bn, dt = self.batch, self.dtype
        refine = settings.refine_steps
        r0, rs = self.split_primal(rhs)
        w = (active / mu).reshape(Bn, S, ms, 1)
        wT, wW = w * self.T, w * self.W
        TwT = (self.T.mT @ wT).sum(dim=1)
        K00 = self.Q0 if self.comm is not None else self.Q0 + TwT
        Kss = self.Qs + self.W.mT @ wW
        Bs = self.W.mT @ wT                             # (B, S, ns, n0)
        if settings.proximal:
            K00 = K00 + sigma[:, None, None] * torch.eye(
                n0, dtype=dt, device=self.device)
            Kss = Kss + sigma[:, None, None, None] * torch.eye(
                ns, dtype=dt, device=self.device)
        SB, Sr, KinvB, Kinvr = local_contribution(Kss, Bs, rs, refine)
        if self.comm is None:
            S0 = K00 - SB.sum(dim=1)
            rhs0 = r0 - Sr.sum(dim=1)
            ok = all_finite
        else:
            # the sums over the scenarios of every rank: one all-reduce
            part = self.comm.sum(torch.cat(
                [TwT - SB.sum(dim=1), Sr.sum(dim=1)[..., None]], dim=-1))
            S0 = K00 + part[..., :-1]
            rhs0 = r0 - part[..., -1]
            ok = lambda v: ~self.comm.primal_any_nonfinite(v)
        dx0 = cholesky_solve(S0, rhs0, refine)
        dxs = Kinvr - (KinvB @ dx0[:, None, :, None])[..., 0]
        dx = torch.cat([dx0, dxs.flatten(1)], dim=1)
        return bwhere(ok(dx), dx, torch.zeros_like(dx))

    def cast(self, dtype) -> "BlockAngularOperator":
        """Every float leaf in ``dtype`` (kept, so that the hybrid warmup
        casts once per operator)."""
        if dtype == self.dtype:
            return self
        key = ("op", dtype)
        if key not in self._casts:
            self._casts[key] = BlockAngularOperator(
                comm=self.comm, **{name: getattr(self, name).to(dtype)
                                   for name in self.FIELDS})
        return self._casts[key]
