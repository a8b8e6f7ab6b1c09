"""Core QPDO iteration, batched: the primal-dual Newton proximal method as
one masked step over a whole batch of problems.

Port of ``qpdo_tpu/solver/core.py``.  The JAX package writes the step for
one problem and vmaps it; here every function takes the batch, per-problem
scalars are (B,) tensors, and every reduction runs over one problem's
entries.  The step computes the Newton branch and the outer-update branch
for every problem and combines them with per-problem masks; a problem
whose status has latched is frozen exactly, so extra steps change nothing.

The carried KKT cache (``SolverState.kkt_cache``) is None, one (B, n, n)
tensor (the explicit inverse of ``kkt_solver`` "inv" and "ns") or the
pair (K_tilde, w_applied) of the incremental cache; ``select`` and
``masked`` pick it per problem like every other field.

The core is written against the operator protocol of ``operators.py``
(``DenseOperator``, ``SparseOperator``): every operator has a batch size,
a device and a dtype, and the dense-only branches (the carried KKT cache,
the mixed-GEMM phase, the fused right-hand side, reduced-precision
cache-feeding matvecs, the stacked [Q; A] product, the polish) are gated
on the operator's methods exactly where the JAX core gates them with
``hasattr``.

Distributed operators (``operators.RowShardedOperator``, the
scenario-sharded ``BlockAngularOperator``) hold only their rank's part of
the split axis, and carry a comm (``parallel/comm.py``) in ``op.comm``.
Every reduction of the core over dual entries (and over primal entries,
where those are split too) goes through ``_global_max``, ``_dual_sum``
and ``_pdot``, which reduce the local partial results over the ranks; on
an operator without a comm (``op.comm`` None) they change nothing, bit
for bit.  The JAX package gets the same reductions from GSPMD.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from .. import constants as _c
from ..operators import DenseOperator
from ..ops.batched import bwhere, dot, norm_inf
from ..ops.fused_residuals import fused_residuals, kernel_outputs
from ..ops.linalg import resolve_dtype
from ..ops.linesearch import exact_linesearch
from ..types import Info, Result, ScaledProblem, Settings, SolverState
from ..utils import debug as _debug
from ..utils import profiling as _profiling


def as_operator(sp_or_op):
    """Accept a ScaledProblem (wrapped in a DenseOperator) or an operator."""
    if isinstance(sp_or_op, ScaledProblem):
        return DenseOperator(sp_or_op)
    return sp_or_op


@contextlib.contextmanager
def matmul_precision(name: str):
    """PyTorch's counterpart of ``jax.default_matmul_precision``: "highest"
    (or "float32") runs float32 matmuls in full float32, with TF32 off for
    both cuBLAS and cuDNN; "tensorfloat32" (or "high") allows TF32.  The
    previous switches are restored on exit."""
    allow = {"highest": False, "float32": False,
             "tensorfloat32": True, "high": True}
    if name not in allow:
        raise NotImplementedError(f"matmul precision {name!r}: the port has "
                                  "'highest' and 'tensorfloat32'")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow[name]
    torch.backends.cudnn.allow_tf32 = allow[name]
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _with_matmul_precision(fn):
    """Run the wrapped (op, settings, ...) function under
    settings.matmul_precision (core.py:52-63)."""
    @functools.wraps(fn)
    def wrapped(op, settings, *args, **kwargs):
        with matmul_precision(settings.matmul_precision):
            return fn(op, settings, *args, **kwargs)
    return wrapped


def select(mask, a, b):
    """Per problem: ``a`` where ``mask`` (B,) holds, else ``b``, for a
    tensor, a tuple of tensors (the incremental KKT cache) or None."""
    if a is None:
        return None
    if isinstance(a, tuple):
        return tuple(bwhere(mask, x, y) for x, y in zip(a, b))
    return bwhere(mask, a, b)


def _scalar(op, value, dtype=None):
    """A (B,) tensor filled with ``value`` in the operator's dtype."""
    return torch.full((op.batch,), value, dtype=dtype or op.dtype,
                      device=op.device)


def _global_max(op, dual=(), primal=()):
    """Per-problem maxima over dual and primal entries: the partial maxima
    ``dual`` and ``primal`` made global over the ranks of a distributed
    operator (one collective), returned in that order; as given
    otherwise."""
    if op.comm is None:
        return tuple(dual) + tuple(primal)
    return op.comm.max(dual, primal)


def _dual_sum(op, *ts):
    """Per-problem sums over dual entries, global over the ranks."""
    return ts if op.comm is None else op.comm.dual_sum(*ts)


def _pdot(op, a, b):
    """The per-problem inner product of two primal vectors."""
    return dot(a, b) if op.comm is None else op.comm.primal_dot(a, b)


def mixed_mode(settings: Settings, op) -> bool:
    """The anchored mixed-GEMM phase: A-GEMMs in a dtype below the state's,
    on operators with the anchored hard-row products (core.py:232-234)."""
    dt = op.dtype
    return (settings.phase2_gemm_dtype is not None
            and resolve_dtype(settings.phase2_gemm_dtype, dt) != dt
            and hasattr(op, "Amv_mixed"))


# ---------------------------------------------------------------------------
# Warm start / state initialization (qpdo_warm_start, qpdo.c:217-299)
# ---------------------------------------------------------------------------

@_with_matmul_precision
def init_state(op, settings: Settings, x0=None, y0=None) -> SolverState:
    """The initial state of a batch.  ``x0`` (B, n) and ``y0`` (B, m) are
    unscaled warm-start points; None means a cold start of that side (the
    JAX package's ``warm_x``/``warm_y`` flags)."""
    op = as_operator(op)
    dt = op.dtype
    sigma = _scalar(op, settings.sigma_init)
    warm_x, warm_y = x0 is not None, y0 is not None

    if warm_x:
        x = op.Dinv * x0.to(dt)                              # qpdo.c:237-242
        Qx = op.Qmv(x)
        Ax = op.Amv(x)
    else:
        x = op.zeros_primal()
        Qx = op.zeros_primal()
        Ax = op.zeros_dual()

    if warm_y:
        y = op.cost[:, None] * (op.Einv * y0.to(dt))         # qpdo.c:268-274
        Aty = op.Atmv(y)
    else:
        y = op.zeros_dual()
        Aty = op.zeros_primal()

    # initialize_mu: Birgin-Martinez balancing (iteration.c:98-109)
    Qx_eff = Qx + sigma[:, None] * x if settings.proximal else Qx
    f = 0.5 * _pdot(op, x, Qx_eff) + _pdot(op, op.q, x)
    fmax = torch.clamp(torch.abs(f), min=1.0)
    mu = torch.clamp(
        0.1 * torch.clamp(0.5 * torch.square(Ax - torch.clamp(Ax, op.l, op.u)),
                          min=1.0) / fmax[:, None], 1e-3, 1e3)

    if (warm_x or warm_y) and settings.warm_mu_adapt:
        # Scale the initial penalties by the warm point's own KKT residual
        # (core.py:109-128 of the JAX package): a near-optimal point
        # justifies near-final penalties, a bad one keeps scale 1.
        y_term = (op.E * op.E / op.cost[:, None]) * y
        rp0 = norm_inf(op.Einv * (Ax - torch.clamp(Ax + y_term, op.l, op.u)))
        rd0 = norm_inf(op.Dinv * (Qx + op.q + Aty))
        rp0, rd0 = _global_max(op, (rp0,), (rd0,))
        rd0 = rd0 / op.cost
        quality = torch.maximum(rp0, rd0)
        mu_scale = torch.clamp(quality, settings.warm_mu_scale_min, 1.0)
        mu = torch.clamp(mu * mu_scale[:, None], min=settings.mu_min)

    zero = _scalar(op, 0.0)
    i0 = _scalar(op, 0, torch.int32)
    kkt_cache = None
    if ((settings.kkt_update_rows > 0 or settings.kkt_solver in ("inv", "ns"))
            and hasattr(op, "kkt_cache_init")):
        # initial cache from the init-state active set (ybar = y)
        w0 = Ax + 0.5 * mu * y
        active0 = ((w0 <= op.l) | (w0 >= op.u)).to(dt)
        kkt_cache = op.kkt_cache_init(active0, mu, settings, sigma=sigma)
    return SolverState(
        x=x, y=y, Qx=Qx, Ax=Ax, Aty=Aty, dx_prev=op.zeros_primal(),
        xbar=x, ybar=y, mu=mu,
        sigma=sigma, eps_in=_scalar(op, settings.eps_abs_in),
        res_prim_old=op.zeros_dual(), tau=zero,
        iter=i0, iter_old=i0, oter=i0,
        status=_scalar(op, _c.UNSOLVED, torch.int32),
        res_prim_norm=zero, res_dual_norm=zero,
        res_prim_in_norm=zero, res_dual_in_norm=zero,
        kkt_cache=kkt_cache, warmup_iter=i0)


# ---------------------------------------------------------------------------
# One masked solver step (the body of the main loop, qpdo.c:343-449)
# ---------------------------------------------------------------------------

def outer_residuals(op, y, Qx, Ax, Aty):
    """Outer residual vectors and unscaled norms (iteration.c:30-60)."""
    cinv = op.cinv[:, None]
    res_prim = Ax - torch.clamp(Ax + (op.E * op.E * cinv) * y, op.l, op.u)
    res_dual = Qx + op.q + Aty
    rp, rd = _global_max(op, (norm_inf(op.Einv * res_prim),),
                         (norm_inf(op.Dinv * res_dual),))
    return res_prim, res_dual, rp, rd * op.cinv


def residual_outputs(s: SolverState):
    """Buffers for the residual block of every step of a loop over the
    batch of ``s`` (``step``'s ``residual_out``).  A step reads its
    residual outputs only while it runs, and ``masked`` copies whatever of
    them the state keeps, so each step may overwrite the last one's."""
    B, n = s.x.shape
    return kernel_outputs(B, s.y.shape[1], n, s.x.dtype, s.x.device)


def _newton_direction(op, settings: Settings, s: SolverState, active,
                      ytilde, res_dual_in, ckdt):
    """The Newton direction dx of ``step`` and the carried KKT cache after
    it (span ``qpdo.newton``)."""
    if (settings.fused_newton_rhs and isinstance(op, DenseOperator)
            and s.kkt_cache is None):
        # fused-rhs mode: the Newton solve forms rhs itself
        dx = op.newton_solve(active, s.mu, s.sigma, None, settings,
                             dx_prev=s.dx_prev, tol_hint=s.eps_in,
                             ytilde=ytilde, res_dual_in=res_dual_in)
        return dx, s.kkt_cache
    At_ytilde = op.Atmv(ytilde, dtype=ckdt)
    rhs = -(res_dual_in + At_ytilde)
    if s.kkt_cache is not None and hasattr(op, "newton_solve_cached"):
        return op.newton_solve_cached(active, s.mu, s.sigma, rhs, settings,
                                      s.kkt_cache, dx_prev=s.dx_prev,
                                      tol_hint=s.eps_in)
    dx = op.newton_solve(active, s.mu, s.sigma, rhs, settings,
                         dx_prev=s.dx_prev, tol_hint=s.eps_in)
    return dx, s.kkt_cache


@_with_matmul_precision
def step(op, settings: Settings, s: SolverState,
         residual_out=None) -> SolverState:
    op = as_operator(op)
    dt = op.dtype
    one = torch.ones((), dtype=dt, device=op.device)
    eps_abs = torch.full((), settings.eps_abs, dtype=dt, device=op.device)
    cinv = op.cinv
    cost = op.cost
    sigma = s.sigma
    col = lambda v: v[:, None]

    # The whole residual block in one launch (ops/fused_residuals.py; the
    # kernel on a CUDA tensor whatever the flag, see types.py), into the
    # loop's buffers where it hands them in (residual_outputs).
    sig_eff = sigma if settings.proximal else torch.zeros_like(sigma)
    with _profiling.span("qpdo.residuals"):
        (res_prim, res_prim_in, w, active, res_dual_in,
         res_prim_norm, res_dual_norm, res_prim_in_norm,
         res_dual_in_norm) = fused_residuals(
             s.Ax, s.y, s.mu, s.ybar, op.l, op.u, op.E, op.Einv,
             s.Qx, op.q, s.Aty, s.x, s.xbar, op.Dinv, sig_eff, cinv,
             out=residual_out)
        (res_prim_norm, res_prim_in_norm, res_dual_norm,
         res_dual_in_norm) = _global_max(
             op, (res_prim_norm, res_prim_in_norm),
             (res_dual_norm, res_dual_in_norm))
    if settings.pallas_residuals and isinstance(op, DenseOperator):
        # the fused branch of core.py:205-207: df recovered from the kernel
        df = res_dual_in - s.Aty
    elif settings.proximal:
        df = s.Qx + op.q + col(sigma) * (s.x - s.xbar)
    else:
        df = s.Qx + op.q

    # ---- outer optimality / divergence (termination.c:11-23) ----
    infty = torch.full((), _c.QPDO_INFTY, dtype=dt, device=op.device)
    mixed = mixed_mode(settings, op)
    eps_latch = eps_abs * 0.9 if mixed else eps_abs
    diverged = (res_prim_norm > infty) | (res_dual_norm > infty)
    solved = (res_prim_norm <= eps_latch) & (res_dual_norm <= eps_latch)
    status_opt = torch.where(
        diverged, _c.NON_CVX,
        torch.where(solved, _c.SOLVED, _c.UNSOLVED)).to(torch.int32)
    running = status_opt == _c.UNSOLVED

    # ---- subproblem transition test (qpdo.c:365) ----
    inner_opt = (res_prim_in_norm <= s.eps_in) & (res_dual_in_norm <= s.eps_in)
    inner_cap = s.iter == s.iter_old + settings.inner_max_iter
    sub_done = ((s.iter > s.iter_old + 1) & inner_opt) | inner_cap
    can_check = s.iter < s.iter_old + settings.inner_max_iter

    # =======================================================================
    # Branch A: Newton step
    # =======================================================================
    # rhs: ytilde = (I+P) res_prim_in / mu, rhs = -(res_dual_in + A' ytilde)
    ytilde = (res_prim_in / s.mu) * (2.0 - active)

    check_inf = settings.eps_prim_inf > 0 or settings.eps_dual_inf > 0
    dy_c = s.y - s.ybar  # primal certificate direction
    dx_c = s.x - s.xbar  # dual certificate direction

    # reduced-precision cache-feeding matvecs (Qdx, A'ytilde) run in the
    # KKT dtype only on operators that re-anchor them (core.py:280-287);
    # a matrix-free operator keeps them exact
    ckdt = (resolve_dtype(settings.kkt_dtype, dt) if hasattr(op, "Amv_mixed")
            else dt)
    pdt = resolve_dtype(settings.phase2_gemm_dtype, dt) if mixed else None
    cert_dt = settings.cert_dtype or settings.phase2_gemm_dtype
    cdt = resolve_dtype(cert_dt, dt)
    split_certs = check_inf and cdt != dt

    with _profiling.span("qpdo.newton", device=op.device):
        dx, kkt_cache_new = _newton_direction(op, settings, s, active, ytilde,
                                              res_dual_in, ckdt)
    Qdx_c = Adx_c_raw = Atdy_c_raw = None
    if mixed:
        Qdx_pure = op.Qmv(dx, dtype=ckdt)
        Adx = op.Amv_mixed(dx, s.mu, settings.hard_rows, pdt)
        if check_inf:
            Adx_c_raw = op.Amv(dx_c, dtype=cdt)
            Qdx_c = op.Qmv(dx_c, dtype=cdt)
    elif split_certs:
        Qdx_pure = op.Qmv(dx, dtype=ckdt)
        Adx = op.Amv(dx)
        Adx_c_raw = op.Amv(dx_c, dtype=cdt)
        Qdx_c = op.Qmv(dx_c, dtype=cdt)
    elif check_inf:
        if ckdt == dt and hasattr(op, "QAmv2"):
            Qdx_pure, Qdx_c, Adx, Adx_c_raw = op.QAmv2(dx, dx_c)
        elif ckdt == dt:
            # operators without the stacked [Q; A] product pair the columns
            Qdx_pure, Qdx_c = op.Qmv2(dx, dx_c)
            Adx, Adx_c_raw = op.Amv2(dx, dx_c)
        else:
            Qdx_pure = op.Qmv(dx, dtype=ckdt)
            Qdx_c = op.Qmv(dx_c)
            Adx, Adx_c_raw = op.Amv2(dx, dx_c)
    else:
        Qdx_pure = op.Qmv(dx, dtype=ckdt)
        Adx = op.Amv(dx)
    Qdx = Qdx_pure + col(sigma) * dx if settings.proximal else Qdx_pure
    dy = ytilde + active * (Adx / s.mu)                       # newton.c:60-63
    if mixed:
        Atdy = op.Atmv_mixed(dy, s.mu, settings.hard_rows, pdt)
        if check_inf:
            Atdy_c_raw = op.Atmv(dy_c, dtype=cdt)
    elif split_certs:
        Atdy = op.Atmv(dy)
        Atdy_c_raw = op.Atmv(dy_c, dtype=cdt)
    elif check_inf:
        Atdy, Atdy_c_raw = op.Atmv2(dy, dy_c)
    else:
        Atdy = op.Atmv(dy)
    with _profiling.span("qpdo.linesearch"):
        tau = exact_linesearch(dx, dy, Qdx, Adx, df, s.y, w, s.mu, op.l,
                               op.u, settings.linesearch,
                               settings.linesearch_dtype, comm=op.comm)
    if settings.newton_full_step and op.newton_exact(settings):
        # full-step acceptance from the cache increments alone
        Ax_t = s.Ax + Adx
        y_t = s.y + dy
        w_t = Ax_t + s.mu * (s.ybar - 0.5 * y_t)
        rpi_t = Ax_t + s.mu * (s.ybar - y_t) - torch.clamp(w_t, op.l, op.u)
        Qx_t = s.Qx + Qdx_pure
        if settings.proximal:
            df_t = Qx_t + op.q + col(sigma) * ((s.x + dx) - s.xbar)
        else:
            df_t = Qx_t + op.q
        rdi_t = df_t + (s.Aty + Atdy)
        rpi_t_norm, rdi_t_norm = _global_max(
            op, (norm_inf(op.Einv * rpi_t),), (norm_inf(op.Dinv * rdi_t),))
        rdi_t_norm = rdi_t_norm * cinv
        cur = torch.maximum(res_prim_in_norm, res_dual_in_norm)
        trial = torch.maximum(rpi_t_norm, rdi_t_norm)
        take_full = (trial <= settings.full_step_gamma * cur) & (tau < one)
        tau = torch.where(take_full, one, tau)
    # iterate + cache updates (iteration.c:19-24)
    t = col(tau)
    x_nwt = s.x + t * dx
    y_nwt = s.y + t * dy
    Qx_nwt = s.Qx + t * Qdx_pure
    Ax_nwt = s.Ax + t * Adx
    Aty_nwt = s.Aty + t * Atdy

    # =======================================================================
    # Branch B: subproblem boundary: infeasibility checks + prox update
    # =======================================================================
    if check_inf:
        # primal infeasibility via dy = y - ybar (termination.c:97-151)
        norm_Edy = norm_inf(op.E * dy_c)
        Atdy_c_norm = norm_inf(op.Dinv * Atdy_c_raw)
        oob = torch.sum(op.u * torch.clamp(dy_c, min=0.0) * op.u_finite
                        + op.l * torch.clamp(dy_c, max=0.0) * op.l_finite,
                        dim=-1)
        norm_Ddx = norm_inf(op.D * dx_c)
        norm_Edy, Atdy_c_norm, norm_Ddx = _global_max(
            op, (norm_Edy,), (Atdy_c_norm, norm_Ddx))
        oob, = _dual_sum(op, oob)
        eps_pinf = settings.eps_prim_inf
        prim_inf = ((norm_Edy > 0)
                    & (Atdy_c_norm <= eps_pinf * norm_Edy)
                    & (oob <= -eps_pinf * norm_Edy))
        prim_inf &= can_check & (settings.eps_prim_inf > 0)

        # dual infeasibility via dx = x - xbar (termination.c:156-216)
        thr = settings.eps_dual_inf * norm_Ddx
        scaled = op.Einv * Adx_c_raw
        rows_bad = ((op.u_finite * (scaled >= col(thr)) > 0)
                    | (op.l_finite * (scaled <= -col(thr)) > 0)).any(dim=-1)
        if settings.proximal:
            # quirk preserved from termination.c:200-202: - sigma*tau*dx
            Qdx_c = Qdx_c - col(sigma * s.tau) * dx_c
        Qdx_c_norm = norm_inf(Qdx_c)
        if op.comm is not None:
            bad, Qdx_c_norm = op.comm.max((rows_bad.to(dt),), (Qdx_c_norm,))
            rows_bad = bad > 0
        dual_inf = ((norm_Ddx > 0) & ~rows_bad
                    & (Qdx_c_norm <= cost * thr)
                    & (_pdot(op, op.q, dx_c) <= -cost * thr))
        dual_inf &= can_check & (settings.eps_dual_inf > 0) & ~prim_inf
    else:
        prim_inf = torch.zeros_like(running)
        dual_inf = torch.zeros_like(running)

    # mu update (iteration.c:127-168), gated on oter > 0 and the outer
    # primal residual still above tolerance (qpdo.c:400-402)
    res_norm_scaled, = _global_max(op, (norm_inf(res_prim),))
    do_mu = (s.oter > 0) & (res_prim_norm > eps_abs)
    abs_rp = torch.abs(res_prim)
    cond = abs_rp > torch.maximum(eps_abs, settings.theta
                                  * torch.abs(s.res_prim_old))
    safe_rp = torch.where(cond, abs_rp, one)
    factor = one / torch.clamp(settings.delta * col(res_norm_scaled) / safe_rp,
                               max=1.0)
    shrunk = torch.clamp(s.mu / factor, min=settings.mu_min)
    mu_out = torch.where(col(do_mu) & cond, shrunk, s.mu)

    # sigma update (iteration.c:173-180), gated at qpdo.c:403-405
    do_sigma = (s.oter > 0) & (res_dual_norm > eps_abs) & settings.proximal
    sigma_shrunk = torch.clamp(sigma * settings.sigma_upd,
                               min=settings.sigma_min)
    sigma_out = torch.where(do_sigma & (sigma > settings.sigma_min),
                            sigma_shrunk, sigma)

    # prox-center update: recenter at the iterate (qpdo.c:396-397), or the
    # safeguarded inertial extrapolation of Settings.accel_gamma
    if settings.accel_gamma > 0:
        ot = s.oter.to(dt)
        gk = settings.accel_gamma * ot / (ot + 3.0)
        rp_prev_norm, = _global_max(op, (norm_inf(op.Einv * s.res_prim_old),))
        ok = can_check & (s.oter > 0) & (res_prim_norm <= rp_prev_norm)
        gk = col(torch.where(ok, gk, torch.zeros_like(gk)))
        xbar_new = s.x + gk * (s.x - s.xbar)
        ybar_new = s.y + gk * (s.y - s.ybar)
    else:
        xbar_new, ybar_new = s.x, s.y

    # inner tolerance shrink, only when the subproblem converged before the
    # iteration cap (qpdo.c:407-410)
    eps_in_out = torch.where(
        can_check, torch.maximum(settings.rho * s.eps_in, 0.1 * eps_abs),
        s.eps_in)

    # ---- warmup stall guard (phase 1 only; Settings.warmup_stall_exit) ----
    if settings.stall_exit > 0:
        prev_rp_norm, = _global_max(op, (norm_inf(op.Einv * s.res_prim_old),))
        warmup_stalled = ((s.oter >= 2)
                          & (res_prim_norm > settings.stall_exit * prev_rp_norm)
                          & (res_prim_norm > eps_abs))
    else:
        warmup_stalled = torch.zeros_like(running)

    # =======================================================================
    # Combine branches with masks
    # =======================================================================
    infeasible = prim_inf | dual_inf
    apply_newton = running & ~sub_done
    apply_outer = running & sub_done & ~infeasible & ~warmup_stalled
    advance = apply_newton | apply_outer       # no break this iteration

    unsolved = torch.full_like(status_opt, _c.UNSOLVED)
    status_next = torch.where(
        running,
        torch.where(sub_done & prim_inf, _c.PRIMAL_INFEASIBLE,
                    torch.where(sub_done & dual_inf, _c.DUAL_INFEASIBLE,
                                torch.where(sub_done & warmup_stalled,
                                            _c.WARMUP_STALLED, unsolved))),
        status_opt).to(torch.int32)

    def pick(newton_val, outer_val, old):
        return bwhere(apply_newton, newton_val,
                      bwhere(apply_outer, outer_val, old))

    return SolverState(
        x=pick(x_nwt, s.x, s.x),
        y=pick(y_nwt, s.y, s.y),
        Qx=pick(Qx_nwt, s.Qx, s.Qx),
        Ax=pick(Ax_nwt, s.Ax, s.Ax),
        Aty=pick(Aty_nwt, s.Aty, s.Aty),
        dx_prev=pick(dx, s.dx_prev, s.dx_prev),
        xbar=pick(s.xbar, xbar_new, s.xbar),  # prox center (qpdo.c:396)
        ybar=pick(s.ybar, ybar_new, s.ybar),
        mu=pick(s.mu, mu_out, s.mu),
        sigma=pick(s.sigma, sigma_out, s.sigma),
        eps_in=pick(s.eps_in, eps_in_out, s.eps_in),
        res_prim_old=pick(s.res_prim_old, res_prim, s.res_prim_old),
        tau=torch.where(apply_newton, tau, s.tau),
        iter=torch.where(advance, s.iter + 1, s.iter),
        iter_old=pick(s.iter_old, s.iter, s.iter_old),
        oter=pick(s.oter, s.oter + 1, s.oter),
        status=status_next,
        res_prim_norm=res_prim_norm,
        res_dual_norm=res_dual_norm,
        res_prim_in_norm=res_prim_in_norm,
        res_dual_in_norm=res_dual_in_norm,
        # the cache advances only on Newton steps
        kkt_cache=select(apply_newton, kkt_cache_new, s.kkt_cache),
        warmup_iter=s.warmup_iter,
    )


# ---------------------------------------------------------------------------
# Full solve on scaled data
# ---------------------------------------------------------------------------

def objective_value(op, x, Qx):
    """0.5 x'Qx + q'x, unscaled (compute_objective, iteration.c:185-221)."""
    op = as_operator(op)
    obj = 0.5 * _pdot(op, x, Qx) + _pdot(op, op.q, x)
    return obj * op.cinv + op.c


def rebuild_kkt_cache(op, settings: Settings, s: SolverState) -> SolverState:
    """Exact rebuild of the carried KKT cache from the current state."""
    op = as_operator(op)
    if ((settings.kkt_update_rows <= 0
         and settings.kkt_solver not in ("inv", "ns"))
            or not hasattr(op, "kkt_cache_init")):
        return s
    if (settings.kkt_solver in ("inv", "ns")
            and settings.kkt_update_rows <= 0
            and not settings.kkt_inv_refresh):
        return s  # init-only inverse: NS tracking carries X
    w = s.Ax + s.mu * (s.ybar - 0.5 * s.y)
    active = ((w <= op.l) | (w >= op.u)).to(op.dtype)
    return s._replace(kkt_cache=op.kkt_cache_init(active, s.mu, settings,
                                                  sigma=s.sigma))


def reanchor(op, settings: Settings, s: SolverState) -> SolverState:
    """Recompute the Qx/Ax/Aty caches with exact state-dtype matvecs (the
    anchor of the mixed-GEMM phase 2), then rebuild the KKT cache."""
    op = as_operator(op)
    s = s._replace(Qx=op.Qmv(s.x), Ax=op.Amv(s.x), Aty=op.Atmv(s.y))
    return rebuild_kkt_cache(op, settings, s)


def masked(new: SolverState, old: SolverState, mask) -> SolverState:
    """Per problem: ``new`` where ``mask`` (B,) holds, else ``old``."""
    return SolverState(*[select(mask, a, b) for a, b in zip(new, old)])


def masked_step(op, settings: Settings, s: SolverState, out,
                active) -> SolverState:
    """One masked step (span ``qpdo.step <B>``): ``step`` from ``s`` kept
    for the problems where ``active(s)`` holds, ``s`` elsewhere."""
    with _profiling.span("qpdo.step", s.x.shape[0]):
        return masked(step(op, settings, s, out), s, active(s))


def any_active(mask) -> bool:
    """Whether ``mask`` holds for any problem: a host read, where the host
    waits for the device (span ``qpdo.check``)."""
    with _profiling.span("qpdo.check"):
        return bool(mask.any())


def _loop_active(s: SolverState, iter_cap):
    return (s.status == _c.UNSOLVED) & (s.iter < iter_cap)


@_with_matmul_precision
def run_loop(op, settings: Settings, s: SolverState,
             iter_cap: int) -> SolverState:
    """Iterate every problem until its status latches or its ``iter``
    reaches ``iter_cap`` (qpdo.c:343-449).

    ``lax.while_loop`` becomes a Python loop of masked steps with one host
    check of "any problem still active" every ``anchor_every`` steps; a
    masked step leaves finished problems untouched.  In mixed-GEMM mode
    (and whenever a KKT cache is carried) the loop nests like the JAX one
    run per problem: each problem runs to its own chunk end
    min(iter + anchor_every, iter_cap), then the chunk's refresh is kept
    for the problems that were active when the chunk began.  A chunk takes
    at most anchor_every masked steps, since each step advances iter or
    latches the status."""
    op = as_operator(op)
    mixed = mixed_mode(settings, op)
    K = settings.anchor_every
    out = residual_outputs(s)
    if not mixed and s.kkt_cache is None:
        active = functools.partial(_loop_active, iter_cap=iter_cap)
        while any_active(active(s)):
            with _profiling.span("qpdo.chunk", s.x.shape[0]):
                for _ in range(K):
                    s = masked_step(op, settings, s, out, active)
            _debug.after_chunk(s)
        return s

    refresh = reanchor if mixed else rebuild_kkt_cache
    while True:
        began = _loop_active(s, iter_cap)
        if not any_active(began):
            return s
        with _profiling.span("qpdo.chunk", s.x.shape[0]):
            end = torch.clamp(s.iter + K, max=iter_cap)
            active = functools.partial(_loop_active, iter_cap=end)
            for _ in range(K):
                s = masked_step(op, settings, s, out, active)
            s = masked(refresh(op, settings, s), s, began)
        _debug.after_chunk(s)


@_profiling.spanned("qpdo.finalize")
@_with_matmul_precision
def finalize(op, settings: Settings, s: SolverState,
             unsolved_status: int = _c.MAX_ITER_REACHED) -> Result:
    """Unscale the solution and certificates and assemble Info
    (store_solution, termination.c:82-92; exit path qpdo.c:451-473)."""
    op = as_operator(op)
    status = torch.where(s.status == _c.UNSOLVED,
                         torch.full_like(s.status, unsolved_status),
                         s.status).to(torch.int32)
    cinv = op.cinv[:, None]
    x_out = op.D * s.x
    y_out = cinv * (op.E * s.y)
    dy_cert = cinv * (op.E * (s.y - s.ybar))
    dx_cert = op.D * (s.x - s.xbar)

    # NaN-filling per the MEX output contract (qpdo_mex.c:247-279)
    is_pinf = status == _c.PRIMAL_INFEASIBLE
    is_dinf = status == _c.DUAL_INFEASIBLE
    any_inf = is_pinf | is_dinf
    nan = lambda v: torch.full_like(v, float("nan"))
    x_out = bwhere(any_inf, nan(x_out), x_out)
    y_out = bwhere(any_inf, nan(y_out), y_out)
    dy_cert = bwhere(is_pinf, dy_cert, nan(dy_cert))
    dx_cert = bwhere(is_dinf, dx_cert, nan(dx_cert))

    zero = torch.zeros_like(s.sigma)
    info = Info(
        iterations=s.iter, oterations=s.oter, status_val=status,
        res_prim_norm=s.res_prim_norm, res_dual_norm=s.res_dual_norm,
        res_prim_in_norm=s.res_prim_in_norm,
        res_dual_in_norm=s.res_dual_in_norm,
        objective=objective_value(op, s.x, s.Qx),
        setup_time=zero, solve_time=zero, run_time=zero,
        warmup_iterations=(s.warmup_iter if s.warmup_iter is not None
                           else torch.zeros_like(s.iter)))
    return Result(x=x_out, y=y_out, prim_inf_cert=dy_cert,
                  dual_inf_cert=dx_cert, info=info)


@_profiling.spanned("qpdo.polish")
@_with_matmul_precision
def polish_state(op, settings: Settings, s: SolverState) -> SolverState:
    """The solution polish (Settings.polish; core.py:686-738): one saddle
    solve on the active set read from the current iterate, accepted per
    problem only when the recomputed outer residuals verify it.  A running
    problem latches SOLVED when the polished residuals meet eps_abs; a
    SOLVED one also needs a strict decrease of max(rp, rd); an infeasible
    or non-convex latch is never touched."""
    op = as_operator(op)
    if not settings.polish or not hasattr(op, "saddle_polish"):
        return s
    eps_abs = settings.eps_abs
    # activity in the mu -> 0 limit (newton.c:96-107): z = Ax + E^2 cinv y
    # strictly outside [l, u]
    z = s.Ax + (op.E * op.E * op.cinv[:, None]) * s.y
    act_low = z < op.l
    act_up = z > op.u
    act = (act_low | act_up).to(op.dtype)
    bnd = torch.where(act_low, op.l,
                      torch.where(act_up, op.u, torch.zeros_like(op.l)))
    xp, yp = op.saddle_polish(act, bnd, settings)

    # verify with exact state-dtype matvecs (the residuals step() stops on)
    Qxp, Axp, Atyp = op.Qmv(xp), op.Amv(xp), op.Atmv(yp)
    _, _, rp, rd = outer_residuals(op, yp, Qxp, Axp, Atyp)
    meets = (rp <= eps_abs) & (rd <= eps_abs)
    cur = torch.maximum(s.res_prim_norm, s.res_dual_norm)
    running = s.status == _c.UNSOLVED
    solved = s.status == _c.SOLVED
    accept = meets & (running | (solved & (torch.maximum(rp, rd) < cur)))

    pick = lambda new, old: bwhere(accept, new, old)
    # on acceptance the prox centers move to the polished point and the
    # inner norms take the verified outer norms
    return s._replace(
        x=pick(xp, s.x), y=pick(yp, s.y),
        Qx=pick(Qxp, s.Qx), Ax=pick(Axp, s.Ax), Aty=pick(Atyp, s.Aty),
        xbar=pick(xp, s.xbar), ybar=pick(yp, s.ybar),
        status=torch.where(accept, torch.full_like(s.status, _c.SOLVED),
                           s.status),
        res_prim_norm=pick(rp, s.res_prim_norm),
        res_dual_norm=pick(rd, s.res_dual_norm),
        res_prim_in_norm=pick(rp, s.res_prim_in_norm),
        res_dual_in_norm=pick(rd, s.res_dual_in_norm))


def warmup_settings(settings: Settings) -> Settings:
    """Phase-1 settings of the hybrid solve: float32-safe tolerances, no
    infeasibility checks, the stall guard on (core.py:741-757)."""
    return settings.replace(
        eps_abs=settings.warmup_eps,
        mu_min=max(settings.mu_min, settings.warmup_mu_min),
        eps_prim_inf=0.0, eps_dual_inf=0.0,
        kkt_dtype=None, refine_steps=settings.warmup_refine_steps,
        hybrid_warmup=False,
        matmul_precision=settings.warmup_matmul_precision,
        stall_exit=settings.warmup_stall_exit)


def warmup_iter_cap(settings: Settings) -> int:
    """At least half the iteration budget stays with the accurate phase."""
    return max(1, settings.max_iter // 2)


@_with_matmul_precision
def upcast_state(op, settings: Settings, s: SolverState) -> SolverState:
    """Upcast a phase-1 state: exact caches in the target dtype, and a
    phase-1 SOLVED or WARMUP_STALLED reset to UNSOLVED.

    Like core.py:800-813, the new state is built without the KKT cache and
    ``rebuild_kkt_cache`` then returns early for an init-only ns inverse,
    so phase 2 of the bench configuration starts with no cache and runs
    the chol Newton solve (``newton_solve``), not the ns one."""
    op = as_operator(op)
    dt = op.dtype
    up = lambda a: a.to(dt)
    x, y = up(s.x), up(s.y)
    status = torch.where((s.status == _c.SOLVED)
                         | (s.status == _c.WARMUP_STALLED),
                         torch.full_like(s.status, _c.UNSOLVED), s.status)
    out = SolverState(
        x=x, y=y, Qx=op.Qmv(x), Ax=op.Amv(x), Aty=op.Atmv(y),
        dx_prev=up(s.dx_prev), xbar=up(s.xbar), ybar=up(s.ybar),
        mu=up(s.mu), sigma=up(s.sigma),
        eps_in=up(s.eps_in), res_prim_old=up(s.res_prim_old), tau=up(s.tau),
        iter=s.iter, iter_old=s.iter_old, oter=s.oter,
        status=status.to(torch.int32),
        res_prim_norm=up(s.res_prim_norm), res_dual_norm=up(s.res_dual_norm),
        res_prim_in_norm=up(s.res_prim_in_norm),
        res_dual_in_norm=up(s.res_dual_in_norm),
        warmup_iter=s.iter)  # phase boundary: everything so far was phase 1
    if s.kkt_cache is not None:
        out = rebuild_kkt_cache(op, settings, out)
    return out


def cast_warm_start(x0, y0, dtype):
    """The warm-start points in ``dtype`` (None stays None)."""
    return (None if x0 is None else x0.to(dtype),
            None if y0 is None else y0.to(dtype))


@_with_matmul_precision
def solve_scaled(op, settings: Settings, x0=None, y0=None) -> Result:
    """Run the main loop on scaled data and unscale the outputs; the batch
    runs in lock step without compaction.  ``x0``/``y0`` warm-start it
    (unscaled points, None for a cold start)."""
    op = as_operator(op)
    if settings.hybrid_warmup and op.dtype != torch.float32:
        stg1 = warmup_settings(settings)
        op32 = op.cast(torch.float32)
        s = init_state(op32, stg1, *cast_warm_start(x0, y0, torch.float32))
        s = run_loop(op32, stg1, s, warmup_iter_cap(settings))
        s0 = polish_state(op, settings, upcast_state(op, settings, s))
    else:
        s0 = init_state(op, settings, x0, y0)
        if x0 is not None and y0 is not None:
            # the warm-start polish of core.py:831-836 (nothing unless
            # settings.polish)
            s0 = polish_state(op, settings, s0)
    s = run_loop(op, settings, s0, settings.max_iter)
    s = polish_state(op, settings, s)
    return finalize(op, settings, s)
