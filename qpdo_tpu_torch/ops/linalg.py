"""Dense KKT formation and factorize/solve for the Newton step, batched.

Port of the dense parts of ``qpdo_tpu/ops/linalg.py``.  The reduced
system of every problem b is

    K_b = Q_b + sigma_b*I*[proximal] + A_b' diag(active_b/mu_b) A_b

formed by the fused formation kernel (``ops/fused_formation.py``) and
factored by a Jacobi-prescaled Cholesky, optionally in a reduced
``kkt_dtype`` with iterative refinement (Richardson sweeps or PCG) against
exact state-dtype matvecs.  Cholesky, triangular solves and the LU of the
polish's saddle system stay on ``torch.linalg``, as the JAX package leaves
them to ``lax.linalg``, except under ``Settings.pallas_kkt`` where
``fused_kkt_route`` holds: there the whole Newton solve is the fused
kernel of ``ops/fused_kkt.py``.  The
incremental variant (``kkt_cache_build``, ``newton_system_solve_cached``)
carries K_tilde = Q + A' diag(w_applied) A across steps and updates it
with the k rows whose weight changed most.

``comm`` (``parallel/comm.py``, the row-sharded solve): A, active and mu
hold this rank's rows.  K is then formed on the local rows (the formation
kernel on a CUDA tensor), with Q and sigma*I added on the root rank only,
and summed over the ranks by one all-reduce; the state-dtype matvecs of
the refinement reduce A'(w A v) the same way.  Everything after K is n x
n and replicated.
"""

from __future__ import annotations

import torch

from .batched import all_finite, bwhere, dot, mtv, mv, norm2
from .cg import pcg
from .fused_formation import fused_formation
from .fused_kkt import fused_kkt_solve, kernel_route


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


def fused_kkt_route(device_type: str, kkt_dtype: torch.dtype) -> bool:
    """Whether ``Settings.pallas_kkt`` takes the fused KKT-solve kernel
    (its plain version on the CPU) for tensors on ``device_type`` with the
    resolved KKT dtype ``kkt_dtype``: on the CPU always, on a device only
    in float32, the JAX package's condition ``on_cpu or kdt == float32``
    (``qpdo_tpu/ops/linalg.py:269``).  Otherwise the flag's Newton solve
    is the chol route in the KKT dtype, as without the flag.  This is the
    reference's routing by settings, not a fallback: a kernel that fails
    to build or launch still raises."""
    return device_type == "cpu" or kkt_dtype == torch.float32


def fused_kkt_kernel_route(settings, B: int, n: int, device,
                           dtype: torch.dtype):
    """The route of the fused KKT-solve kernel ("register", "shared",
    "cluster" or "global": ``fused_kkt.kernel_route``) that a dense solve
    of ``B`` problems of ``n`` variables, whose tensors are ``dtype`` on
    ``device``, takes under ``settings``; None where the kernel does not
    run.  It runs for
    the direct Newton solve (every ``kkt_solver`` but "cg") under
    ``settings.pallas_kkt`` on a CUDA device where ``fused_kkt_route``
    holds: in the main phase when the KKT dtype resolves to float32, and
    in the float32 phase of ``hybrid_warmup``.  A CPU tensor runs the
    plain version (None)."""
    if (not settings.pallas_kkt or settings.kkt_solver == "cg"
            or torch.device(device).type != "cuda"):
        return None
    kkt_dtypes = [resolve_dtype(settings.kkt_dtype, dtype)]
    if settings.hybrid_warmup and dtype != torch.float32:
        kkt_dtypes.append(torch.float32)  # core.warmup_settings' phase
    if any(fused_kkt_route("cuda", k) for k in kkt_dtypes):
        index = torch.device(device).index
        return kernel_route("kkt_solve", B, n, index)
    return None


def _formation(A, w, Q, sig, comm=None):
    """The formation kernel's K = A' diag(w) A + Q + sig*I; with ``comm``
    over every rank's rows (Q and sig enter on the root rank only)."""
    if comm is None:
        return fused_formation(A, w, Q, sig)
    if not comm.root:
        Q, sig = torch.zeros_like(Q), torch.zeros_like(sig)
    return comm.sum(fused_formation(A, w, Q, sig))


def form_kkt(Q, A, active, mu, sigma, proximal: bool, comm=None):
    """K = Q + [proximal]*sigma*I + A' diag(active/mu) A (sigma is (B,)).

    Goes through the formation kernel on a CUDA tensor; the weights are
    divided in the dtype of the arguments, as ``qpdo_tpu``'s ``form_kkt``
    divides them (``linalg.py:39``)."""
    w = active / mu
    sig = sigma if proximal else torch.zeros_like(sigma)
    return _formation(A, w, Q, sig, comm)


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
    """Lower Cholesky factor of every matrix of a (..., n, n) stack.  Like
    ``jnp.linalg.cholesky``, the input is symmetrized first and a matrix
    that is not positive definite gets an all-NaN factor (``cholesky_ex``
    reports it instead of raising), so the callers' finiteness guards act
    on that matrix alone."""
    Khat = (Khat + Khat.mT) / 2
    chol, info = torch.linalg.cholesky_ex(Khat)
    return torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))


def jacobi_cholesky(K):
    """Factor Khat = D^-1 K D^-1 + reg*I with D = sqrt(diag K), per problem.
    Returns (chol(Khat), dinv)."""
    Khat, dinv = _jacobi_scale(K)
    n = K.shape[-1]
    Khat = Khat + _static_reg(K.dtype) * torch.eye(n, dtype=K.dtype,
                                                   device=K.device)
    return _cholesky_nan(Khat), dinv


def cholesky_solve(K, rhs, refine_steps: int = 0):
    """Solve K dx = rhs per problem by the Jacobi-prescaled Cholesky
    factor and ``refine_steps`` Richardson sweeps (``linalg.py:71-91`` of
    the JAX package; ldlchol + ldlsolveLD_rhs, cholmod_interface.c:8-30,
    98-102).  K is (B, n, n); ``rhs`` is (B, n) or a matrix of columns
    (B, n, k).  A problem whose K is not positive definite gets NaN."""
    chol, dinv = jacobi_cholesky(K)
    matrix_rhs = rhs.dim() == K.dim()
    drow = dinv[..., :, None] if matrix_rhs else dinv

    def solve1(b):
        bh = b * drow
        if not matrix_rhs:
            bh = bh[..., None]
        z = torch.linalg.solve_triangular(chol, bh, upper=False)
        z = torch.linalg.solve_triangular(chol.mT, z, upper=True)
        return (z if matrix_rhs else z[..., 0]) * drow

    Kmv = torch.matmul if matrix_rhs else mv
    dx = solve1(rhs)
    for _ in range(refine_steps):
        dx = dx + solve1(rhs - Kmv(K, dx))
    return dx


def kkt_inverse(Q, A, active, mu, sigma, proximal: bool, kkt_dtype=None,
                comm=None):
    """Explicit K^{-1} per problem (the init of the Newton-Schulz-tracked
    inverse, kkt_solver "ns"): Jacobi-prescaled Cholesky, one matrix-RHS
    triangular solve and one GEMM."""
    dt = Q.dtype
    kdt = resolve_dtype(kkt_dtype, dt)
    K = form_kkt(Q.to(kdt), A.to(kdt), active.to(kdt), mu.to(kdt),
                 sigma.to(kdt), proximal, comm)
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


def _state_dtype_kkt_solver(Q, A, active, mu, sigma, proximal: bool,
                            comm=None):
    """b -> K^-1 b with the factor in the state dtype: the escalation of
    the PCG refinement (``linalg.py:179-213`` of the JAX package) for the
    penalties below which a float32 factor cannot exist.  Jacobi-prescaled
    like the fast path, without the static shift; ``torch.linalg`` factors
    in float64 on the card as on the CPU."""
    K = form_kkt(Q, A, active, mu, sigma, proximal, comm)
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


def _exact_kmv(Q, A, w, sigma, proximal: bool, kdt, dt, comm=None):
    """v -> K(w) v with matvecs in ``kdt`` (the KKT dtype for the
    Richardson sweeps, the state dtype for PCG); sigma is (B,)."""
    Qk, Ak, wk = Q.to(kdt), A.to(kdt), w.to(kdt)

    def Kmv(v):
        vk = v.to(kdt)
        AtwAv = mtv(Ak, wk * mv(Ak, vk))
        if comm is not None:
            comm.sum(AtwAv)
        Kv = (mv(Qk, vk) + AtwAv).to(dt)
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
                        kkt_mats=None, comm=None):
    """Form K and solve K dx = rhs per problem (the chol Newton solve).

    Arguments are batched: Q (B, n, n), A (B, m, n), active/mu (B, m),
    sigma (B,), rhs (B, n).  ``pallas_formation`` keeps the arithmetic of
    the JAX package's fused-formation branch (the weights divided in the
    state dtype, then cast, ``linalg.py:266,336``); without it the weights
    are cast first and divided in the KKT dtype (``form_kkt``).  Both reach
    the formation kernel on a CUDA tensor.

    ``pallas_kkt``, where ``fused_kkt_route`` holds (on the CPU for any
    ``kkt_dtype``, on a device for a float32 one): the whole solve
    (formation, Jacobi scaling, Cholesky, both substitutions) is one
    launch of the fused kernel (``ops/fused_kkt.py``), in float32 whatever
    ``kkt_dtype`` says; the refinement sweeps re-invoke it.  Elsewhere the
    flag changes nothing.  ``kkt_mats``: (Q, A) already cast to float32,
    for a caller that keeps them across calls (``DenseOperator`` does);
    cast here when absent.

    ``pcg_refine`` > 0 replaces the Richardson sweeps by PCG
    preconditioned by the reduced-precision factor, with state-dtype
    matvecs; where its relative residual ends above ``escalate_rtol`` (or
    NaN) and the factor dtype is reduced, that problem is solved again with
    a factor in the state dtype.

    Fused-rhs mode (``ytilde``/``res_dual_in`` given, ``rhs`` ignored):
    rhs = -(res_dual_in + A' ytilde) with the matvec in the KKT dtype.
    The JAX package rides A' ytilde on the formation GEMM as an extra
    column (``linalg.py:317-328``, an op-count cut for the TPU's MXU); the
    formation kernel has no rhs column, so here it is computed apart,
    as the JAX package's fused-formation branch does (l.329-338), and K
    takes that branch's arithmetic (weights divided in the state dtype).
    Both agree with the GEMM branch to rounding.

    With ``comm`` (A, active and mu hold this rank's rows) the fused
    kernel, which forms K from the whole of A, does not run: the
    ``pallas_kkt`` route takes the formation route on the local rows in
    float32, one all-reduce of K, and the Jacobi-scaled Cholesky factor,
    so that A is never gathered."""
    dt = Q.dtype
    kdt = resolve_dtype(kkt_dtype, dt)
    w = active / mu
    fused_rhs = ytilde is not None
    if fused_rhs:
        Aty = mtv(A.to(kdt), ytilde.to(kdt))
        if comm is not None:
            comm.sum(Aty)
        rhs = -(res_dual_in + Aty.to(dt))
    fdt = kdt                       # the dtype K is formed and factored in
    if pallas_kkt and fused_kkt_route(Q.device.type, kdt) and comm is not None:
        # the fused kernel forms K from the whole of A: with the rows split,
        # the same function is the formation route below on the local rows,
        # one all-reduce of K and the float32 factor, A never gathered (and,
        # as in the fused route, no escalation to a state-dtype factor)
        fdt, pallas_formation, escalate_rtol = torch.float32, True, 0.0
    elif pallas_kkt and fused_kkt_route(Q.device.type, kdt):
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
    if pallas_formation or fused_rhs:
        sig = sigma.to(fdt) if proximal else torch.zeros_like(sigma, dtype=fdt)
        K = _formation(A.to(fdt), w.to(fdt), Q.to(fdt), sig, comm)
    else:
        K = form_kkt(Q.to(fdt), A.to(fdt), active.to(fdt), mu.to(fdt),
                     sigma.to(fdt), proximal, comm)
    chol, dinv = jacobi_cholesky(K)
    solve1 = _prescaled_tri_solver(chol, dinv, dt)

    if pcg_refine > 0:
        Kmv_exact = _exact_kmv(Q, A, w, sigma, proximal, dt, dt, comm)
        dx, _, rel = pcg(Kmv_exact, rhs, solve1, _pcg_tol(dt), pcg_refine)
        if escalate_rtol > 0 and fdt != dt:
            esc_ok = rel <= escalate_rtol              # False on NaN
            # lax.cond under vmap computes both sides; here the state-dtype
            # factor is built only when some problem needs it
            if not bool(esc_ok.all()):
                solve64 = _state_dtype_kkt_solver(Q, A, active, mu, sigma,
                                                  proximal, comm)
                dx2 = solve64(rhs)
                dx2 = dx2 + solve64(rhs - Kmv_exact(dx2))
                dx = bwhere(esc_ok, dx, dx2)
    else:
        dx = _refine(solve1,
                     _exact_kmv(Q, A, w, sigma, proximal, kdt, dt, comm),
                     rhs, solve1(rhs), refine_steps)
    # a NaN factor must not poison the state
    return bwhere(all_finite(dx), dx, torch.zeros_like(dx))


# ---------------------------------------------------------------------------
# Solution polish: the active-set saddle system
# ---------------------------------------------------------------------------

def saddle_solve(Q, A, act, rhs1, rhs2, delta, refine_steps: int = 2,
                 lu_dtype=None):
    """Solve per problem the symmetric indefinite saddle system

        [[Q,       (act*A)'                  ]]  [v1]   [rhs1]
        [[act*A,   diag(-delta*act + (1-act))]]  [v2] = [rhs2]

    (Q (B, n, n), A (B, m, n), act (B, m) in {0, 1}, rhs1 (B, n), rhs2
    (B, m)) by a batched LU in ``lu_dtype`` and ``refine_steps`` sweeps of
    refinement with state-dtype matvecs (``linalg.py:441-494``).  A
    problem whose solve is not finite (a singular LU included) gets the
    zero vector.  Returns (v1, v2)."""
    dt = Q.dtype
    ldt = resolve_dtype(lu_dtype, dt)
    n = Q.shape[-1]
    Aact = act[..., None] * A
    dblock = (1.0 - act) - delta * act
    top = torch.cat([Q, Aact.mT], dim=-1)
    bottom = torch.cat([Aact, torch.diag_embed(dblock)], dim=-1)
    S = torch.cat([top, bottom], dim=-2)
    rhs = torch.cat([rhs1, rhs2], dim=-1)

    LU, piv, _ = torch.linalg.lu_factor_ex(S.to(ldt))

    def solve1(b):
        return torch.linalg.lu_solve(LU, piv, b.to(ldt)[..., None])[..., 0].to(dt)

    def Smv(v):
        v1, v2 = v[..., :n], v[..., n:]
        return torch.cat([mv(Q, v1) + mtv(Aact, v2),
                          mv(Aact, v1) + dblock * v2], dim=-1)

    sol = solve1(rhs)
    for _ in range(refine_steps):
        sol = sol + solve1(rhs - Smv(sol))
    sol = bwhere(all_finite(sol), sol, torch.zeros_like(sol))
    return sol[..., :n], sol[..., n:]


def saddle_polish_solve(Q, A, q, act, bnd, delta, refine_steps: int = 2,
                        lu_dtype=None):
    """The polish solve (``linalg.py:412-438``): the saddle system on the
    identified active set, rhs (-q, act*bnd); inactive rows carry y_i = 0.
    Returns (xp, yp)."""
    xp, yp = saddle_solve(Q, A, act, -q, act * bnd, delta, refine_steps,
                          lu_dtype)
    return xp, yp * act


# ---------------------------------------------------------------------------
# Incremental KKT formation (Settings.kkt_update_rows)
# ---------------------------------------------------------------------------

def kkt_cache_build(Q, A, w, kkt_dtype=None, comm=None):
    """A fresh cache (K_tilde, w_applied) = (Q + A' diag(w) A, w) in the
    KKT dtype: the formation kernel with sigma = 0 (sigma is applied at
    factor time).  With ``comm``, w_applied holds the local rows."""
    kdt = resolve_dtype(kkt_dtype, Q.dtype)
    wk = w.to(kdt)
    zero = torch.zeros(Q.shape[:1], dtype=kdt, device=Q.device)
    return _formation(A.to(kdt), wk, Q.to(kdt), zero, comm), wk


def top_rows(v, k: int):
    """Per problem, the indices of the k largest entries of ``v`` (B, m),
    largest first, the lower index first among equals (as
    ``jax.lax.top_k`` orders them; ``torch.topk`` does not promise it)."""
    return torch.sort(v, dim=-1, descending=True, stable=True)[1][..., :k]


def _top_rows_split(dw, k: int, comm):
    """The k largest |dw| rows of the whole problem, picked from the rows
    of every rank: (local index (B, k), where this rank holds the row
    (B, k)); a row held elsewhere gets index m_local, one past the local
    rows, and a weight change of 0."""
    m_local = dw.shape[-1]
    idx = top_rows(torch.abs(comm.gather_rows(dw)), k)
    lo = comm.rank * m_local
    here = (idx >= lo) & (idx < lo + m_local)
    return torch.where(here, idx - lo, m_local), here


def newton_system_solve_cached(Q, A, w, sigma, rhs, cache, proximal: bool,
                               refine_steps: int, kkt_dtype, k: int,
                               comm=None):
    """The incremental Newton solve (``linalg.py:506-563``): add the rows
    of the k largest |w - w_applied| to K_tilde, factor K_tilde (+ sigma I)
    and solve the exact K(w) dx = rhs by 1 + max(refine_steps, 1) PCG
    iterations with that factor as the preconditioner.  Returns
    (dx, (K_tilde, w_applied)).  With ``comm`` the k rows are picked over
    every rank's rows, each rank adds the ones it holds and one
    all-reduce sums the update of K_tilde."""
    dt = Q.dtype
    kdt = resolve_dtype(kkt_dtype, dt)
    Ktilde, w_app = cache
    Ak = A.to(kdt)

    dw = w.to(kdt) - w_app
    if comm is None:
        k = min(int(k), A.shape[-2])
        idx = top_rows(torch.abs(dw), k)
        dw_sel = torch.gather(dw, 1, idx)                        # (B, k)
        A_sel = torch.gather(Ak, 1,
                             idx[..., None].expand(-1, -1, Ak.shape[-1]))
        Ktilde = Ktilde + torch.matmul(A_sel.mT, dw_sel[..., None] * A_sel)
        w_app = w_app.scatter(1, idx, torch.gather(w_app, 1, idx) + dw_sel)
    else:
        k = min(int(k), A.shape[-2] * comm.size)
        idx, here = _top_rows_split(dw, k, comm)
        safe = torch.where(here, idx, 0)
        dw_sel = torch.where(here, torch.gather(dw, 1, safe), 0.0)
        A_sel = torch.gather(Ak, 1,
                             safe[..., None].expand(-1, -1, Ak.shape[-1]))
        Ktilde = Ktilde + comm.sum(
            torch.matmul(A_sel.mT, dw_sel[..., None] * A_sel))
        # rows held elsewhere land in a scratch column past the local rows
        ext = torch.cat([w_app, torch.zeros_like(w_app[:, :1])], dim=1)
        w_app = ext.scatter(1, idx, torch.gather(ext, 1, idx)
                            + dw_sel)[:, :-1]

    Kfac = Ktilde
    if proximal:
        n = Q.shape[-1]
        Kfac = Kfac + sigma.to(kdt)[:, None, None] * torch.eye(
            n, dtype=kdt, device=Q.device)
    chol, dinv = jacobi_cholesky(Kfac)
    solve1 = _prescaled_tri_solver(chol, dinv, dt)
    Kmv = _exact_kmv(Q, A, w, sigma, proximal, kdt, dt, comm)

    tiny = torch.finfo(dt).tiny
    x = torch.zeros_like(rhs)
    r = rhs
    z = solve1(r)
    p = z
    rz = dot(r, z)
    one = torch.ones_like(rz)
    zero = torch.zeros_like(rz)
    for _ in range(1 + max(refine_steps, 1)):
        Kp = Kmv(p)
        pKp = dot(p, Kp)
        live = pKp > tiny
        alpha = torch.where(live, rz / torch.where(live, pKp, one), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Kp
        z = solve1(r)
        rz_new = dot(r, z)
        beta = torch.where(live, rz_new / torch.where(rz > tiny, rz, one),
                           zero)
        rz = rz_new
        p = z + beta[:, None] * p
    dx = bwhere(all_finite(x), x, torch.zeros_like(x))
    return dx, (Ktilde, w_app)
