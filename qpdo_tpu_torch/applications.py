"""Canonical QP formulations built on the solver: Lasso, SVM, portfolio,
condensed MPC, non-negative least squares, Huber fitting, and an SQP
method for smooth nonlinear programs.

Port of ``qpdo_tpu/applications.py``.  Each dense
constructor returns a ``Problem`` (a batch of one, as ``make_problem``
builds it; plus, where the QP variables are not the user's variables, the
place the user's sit in the QP solution) built from the same inputs as the
JAX package's, in the same operation order.  The reference library has no
such layer: its user-facing problem class is the raw (Q, q, A, l, u)
tuple (interfaces/mex/qpdo.m:50-160, examples/demo_mex.m), so these are
front-ends that reduce to that tuple and go through the ordinary
``solve`` path (scaling, certificates, warm starting all apply).

Every dense constructor takes ``dtype`` and ``device`` as
``make_problem`` does: the dtype defaults to that of the first array
argument, and ``device=None`` means "cuda".  The sparse constructors
(``lasso_sparse``, ``huber_sparse``) return scipy.sparse tuples for
``solve_sparse`` and ``solve_sparse_batch``, which take the device.
"""

from __future__ import annotations

import torch

from .api import make_problem, solve
from .types import Problem, Settings

__all__ = [
    "lasso", "lasso_sparse", "svm_dual", "svm_primal_from_dual",
    "portfolio", "mpc_condensed", "nonneg_ls", "huber_fit", "huber_sparse",
    "sqp_minimize",
]

_INF = float("inf")


def _tensors(*arrays, dtype=None, device=None):
    """The array arguments as tensors on ``device`` (None: "cuda"), all
    in ``dtype`` (None: the first argument's floating dtype)."""
    device = torch.device("cuda" if device is None else device)
    first = torch.as_tensor(arrays[0], dtype=dtype, device=device)
    if not first.is_floating_point():
        first = first.to(torch.get_default_dtype())
    rest = [torch.as_tensor(a, dtype=first.dtype, device=device)
            for a in arrays[1:]]
    return (first, *rest)


def _eye(k, like):
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _full(k, value, like):
    return torch.full((k,), value, dtype=like.dtype, device=like.device)


def lasso(F, b, lam, dtype=None, device=None) -> Problem:
    """L1-regularized least squares: min_x 0.5*||F x - b||^2 + lam*||x||_1.

    QP variables z = (x, t) with the standard epigraph split -t <= x <= t:

        min 0.5 z' blkdiag(F'F, 0) z + (-F'b, lam*1)' z + 0.5 b'b
        s.t.  x - t <= 0,  -x - t <= 0.

    The QP solution carries x in z[:p]; t converges to |x| row-wise.
    """
    F, b = _tensors(F, b, dtype=dtype, device=device)
    p = F.shape[1]
    Q = torch.zeros((2 * p, 2 * p), dtype=F.dtype, device=F.device)
    Q[:p, :p] = F.T @ F
    q = torch.cat([-F.T @ b, _full(p, lam, F)])
    eye = _eye(p, F)
    A = torch.cat([torch.cat([eye, -eye], 1), torch.cat([-eye, -eye], 1)])
    return make_problem(Q, q, A, _full(2 * p, -_INF, F),
                        torch.zeros_like(q), c=0.5 * b @ b, device=F.device)


def lasso_sparse(F, b, lam):
    """Large-scale Lasso for the sparse path: a scipy.sparse
    ``(Q, q, A, l, u, c)`` tuple for ``solve_sparse`` /
    ``solve_sparse_batch`` (applications.py:59-89 of the JAX package).

    The residual is lifted so that Q stays diagonal and every matrix
    inherits F's sparsity (no dense F'F Gram): variables z = (x, t, r) with

        min 0.5 r'r - b'r + lam*1't + 0.5 b'b
        s.t. F x - r = 0,   x - t <= 0,   -x - t <= 0

    x sits in z[:p]; at the optimum r = F x and t = |x|.
    """
    import numpy as np
    import scipy.sparse as sps

    F = sps.csr_matrix(F)
    b = np.asarray(b, float)
    N, p = F.shape
    Q = sps.diags(np.concatenate([np.zeros(2 * p), np.ones(N)])).tocsr()
    q = np.concatenate([np.zeros(p), np.full(p, float(lam)), -b])
    eye_p = sps.eye(p, format="csr")
    Z_pN = sps.csr_matrix((p, N))
    A = sps.vstack([
        sps.hstack([F, sps.csr_matrix((N, p)), -sps.eye(N, format="csr")]),
        sps.hstack([eye_p, -eye_p, Z_pN]),
        sps.hstack([-eye_p, -eye_p, Z_pN]),
    ]).tocsr()
    l = np.concatenate([np.zeros(N), np.full(2 * p, -np.inf)])
    u = np.concatenate([np.zeros(N), np.zeros(2 * p)])
    return Q, q, A, l, u, 0.5 * float(b @ b)


def huber_sparse(F, b, delta):
    """Large-scale Huber regression for the sparse path: the split of
    ``huber_fit`` with scipy.sparse matrices (diagonal Q, A inheriting F's
    sparsity; applications.py:92-115 of the JAX package).  Returns
    ``(Q, q, A, l, u)``; x sits in z[:p]."""
    import numpy as np
    import scipy.sparse as sps

    F = sps.csr_matrix(F)
    b = np.asarray(b, float)
    N, p = F.shape
    Q = sps.diags(np.concatenate([np.zeros(p), np.ones(N),
                                  np.zeros(2 * N)])).tocsr()
    q = np.concatenate([np.zeros(p + N), np.full(2 * N, float(delta))])
    eyeN = sps.eye(N, format="csr")
    A_eq = sps.hstack([F, -eyeN, -eyeN, eyeN])
    A_s = sps.hstack([sps.csr_matrix((2 * N, p + N)),
                      sps.eye(2 * N, format="csr")])
    A = sps.vstack([A_eq, A_s]).tocsr()
    l = np.concatenate([b, np.zeros(2 * N)])
    u = np.concatenate([b, np.full(2 * N, np.inf)])
    return Q, q, A, l, u


def svm_dual(X, labels, C, dtype=None, device=None) -> Problem:
    """Soft-margin linear SVM, dual form.

    min_a 0.5 a'(yy' * XX')a - 1'a   s.t. 0 <= a <= C,  y'a = 0.

    ``labels`` must be +-1.  Recover the primal with
    ``svm_primal_from_dual``.
    """
    X, y = _tensors(X, labels, dtype=dtype, device=device)
    N = X.shape[0]
    G = (X @ X.T) * torch.outer(y, y)
    A = torch.cat([_eye(N, X), y[None, :]], 0)
    u = torch.cat([_full(N, C, X), _full(1, 0.0, X)])
    return make_problem(G, _full(N, -1.0, X), A, _full(N + 1, 0.0, X), u,
                        device=X.device)


def svm_primal_from_dual(X, labels, C, alpha, dtype=None, device=None):
    """(w, bias) from the dual solution: w = X'(a*y); bias averaged over
    free support vectors (0 < a < C), the standard KKT recovery."""
    X, y, alpha = _tensors(X, labels, alpha, dtype=dtype, device=device)
    w = X.T @ (alpha * y)
    tol = 1e-6 * C
    free = (alpha > tol) & (alpha < C - tol)
    # bias from complementary slackness y_i (w'x_i + b) = 1 on free SVs
    resid = y - X @ w
    denom = torch.clamp(free.sum(), min=1)
    bias = torch.where(free, resid, torch.zeros_like(resid)).sum() / denom
    return w, bias


def portfolio(mu, Sigma, risk_aversion, w_min=0.0, w_max=None, budget=1.0,
              dtype=None, device=None) -> Problem:
    """Markowitz allocation: max mu'w - risk_aversion * w'Sigma w
    s.t. sum(w) = budget, w_min <= w <= w_max (long-only by default)."""
    mu, Sigma = _tensors(mu, Sigma, dtype=dtype, device=device)
    N = mu.shape[0]
    Q = 2.0 * risk_aversion * Sigma
    A = torch.cat([torch.ones((1, N), dtype=mu.dtype, device=mu.device),
                   _eye(N, mu)], 0)
    hi = _INF if w_max is None else w_max
    l = torch.cat([_full(1, budget, mu), _full(N, w_min, mu)])
    u = torch.cat([_full(1, budget, mu), _full(N, hi, mu)])
    return make_problem(Q, -mu, A, l, u, device=mu.device)


def mpc_condensed(Ad, Bd, Qx, Ru, x0, horizon, u_lo=None, u_hi=None,
                  x_lo=None, x_hi=None, QT=None, dtype=None,
                  device=None) -> Problem:
    """Condensed linear-MPC QP over the input sequence U = (u_0..u_{T-1}).

    Dynamics x_{k+1} = Ad x_k + Bd u_k eliminate the states:
    X = S x0 + M U with S_k = Ad^{k+1} and M the lower block-Toeplitz of
    Ad^{k-1-j} Bd, giving

        min 0.5 U'(M' Qbar M + Rbar) U + (M' Qbar S x0)' U  (+ const)
        s.t. u_lo <= u_k <= u_hi  (identity rows)
             x_lo <= (S x0 + M U)_k <= x_hi  (state rows, shifted bounds)

    where Qbar = blkdiag(Qx,...,Qx,QT) over x_1..x_T and Rbar = I_T (x) Ru.
    This is the dense analogue of the warm-started MPC workflow the
    reference demonstrates (examples/demo_mex.m:45-56): one QP per step,
    re-solved with update_q/update_bounds + warm_start as x0 moves.
    Bounds are scalars, one vector per stage ((nu,) or (nx,)) or all T
    stages' entries.
    """
    Bd, Ad, Qx, Ru, x0 = _tensors(Bd, Ad, Qx, Ru, x0, dtype=dtype,
                                  device=device)
    QT = Qx if QT is None else torch.as_tensor(QT, dtype=Qx.dtype,
                                               device=Qx.device)
    nx, nu = Bd.shape
    T = int(horizon)

    # powers[k] = Ad^k for k = 0..T
    powers = [_eye(nx, Ad)]
    for _ in range(T):
        powers.append(Ad @ powers[-1])
    S = torch.cat([powers[k + 1] for k in range(T)], 0)       # (T nx, nx)
    zero = torch.zeros((nx, nu), dtype=Bd.dtype, device=Bd.device)
    M = torch.cat([torch.cat([powers[k - j] @ Bd if j <= k else zero
                              for j in range(T)], 1)
                   for k in range(T)], 0)                      # (T nx, T nu)

    Qbar = torch.block_diag(*([Qx] * (T - 1) + [QT]))
    Rbar = torch.kron(_eye(T, Ru), Ru)

    H = M.T @ Qbar @ M + Rbar
    Sx0 = S @ x0
    g = M.T @ (Qbar @ Sx0)
    const = 0.5 * Sx0 @ (Qbar @ Sx0)

    def full(v, default, dim):
        if v is None:
            return _full(T * dim, default, Bd)
        v = torch.as_tensor(v, dtype=Bd.dtype, device=Bd.device)
        if v.dim() == 0:
            return _full(T * dim, float(v), Bd)
        if tuple(v.shape) == (dim,):
            return v.repeat(T)             # one bound per stage
        if v.numel() == T * dim:
            return v.reshape(-1)           # full per-stage bounds
        raise ValueError(
            f"bound must be a scalar, shape ({dim},), or {T}x{dim} "
            f"entries; got shape {tuple(v.shape)}")

    rows = [_eye(T * nu, Bd)]
    lo = [full(u_lo, -_INF, nu)]
    hi = [full(u_hi, _INF, nu)]
    if x_lo is not None or x_hi is not None:
        rows.append(M)
        lo.append(full(x_lo, -_INF, nx) - Sx0)
        hi.append(full(x_hi, _INF, nx) - Sx0)
    return make_problem(H, g, torch.cat(rows, 0), torch.cat(lo),
                        torch.cat(hi), c=const, device=Bd.device)


def nonneg_ls(F, b, dtype=None, device=None) -> Problem:
    """Non-negative least squares: min 0.5*||F x - b||^2  s.t. x >= 0."""
    F, b = _tensors(F, b, dtype=dtype, device=device)
    p = F.shape[1]
    return make_problem(F.T @ F, -F.T @ b, _eye(p, F), _full(p, 0.0, F),
                        _full(p, _INF, F), c=0.5 * b @ b, device=F.device)


def huber_fit(F, b, delta, dtype=None, device=None) -> Problem:
    """Huber regression: min_x sum_i phi_delta((F x - b)_i) with
    phi_delta(r) = 0.5 r^2 for |r| <= delta, delta(|r| - 0.5 delta) beyond.

    Standard QP split over z = (x, w, s+, s-):

        min 0.5 w'w + delta 1'(s+ + s-)
        s.t. F x - w - s+ + s- = b,   s+ >= 0,  s- >= 0

    so w carries the quadratic (small) part of each residual and s+/s- the
    linear tails.  x sits in z[:p].
    """
    F, b = _tensors(F, b, dtype=dtype, device=device)
    N, p = F.shape
    nz = p + 3 * N
    Q = torch.zeros((nz, nz), dtype=F.dtype, device=F.device)
    Q[p:p + N, p:p + N] = _eye(N, F)
    q = torch.cat([_full(p + N, 0.0, F), _full(2 * N, delta, F)])
    eyeN = _eye(N, F)
    A_s = torch.zeros((2 * N, nz), dtype=F.dtype, device=F.device)
    A_s[:, p + N:] = _eye(2 * N, F)
    A = torch.cat([torch.cat([F, -eyeN, -eyeN, eyeN], 1), A_s], 0)
    l = torch.cat([b, _full(2 * N, 0.0, F)])
    u = torch.cat([b, _full(2 * N, _INF, F)])
    return make_problem(Q, q, A, l, u, device=F.device)


def sqp_minimize(f, c, x0, l, u, max_outer: int = 50, tol: float = 1e-8,
                 tr0: float = 1.0, settings=None, device=None):
    """Sequential Quadratic Programming for smooth nonlinear programs
    min f(x) s.t. l <= c(x) <= u, built on this QP solver.

    Classic recipe: linearize c at the iterate, solve a convex QP over
    the step (damped-BFGS Hessian estimate, trust-region box), globalize
    with an l1-merit backtracking linesearch; derivatives by
    ``torch.func.grad`` and ``torch.func.jacfwd``, QP duals warm-start the
    next subproblem.  ``f`` and ``c`` are torch callables of a float64
    tensor (c returns a vector); the iterate and every QP live on
    ``device`` (None: "cuda").  Returns ``(x, iterations)``, x a float64
    tensor.

    Caveats (by design: a light SQP loop, not a hardened NLP solver): f and
    c must be smooth and traceable by ``torch.func``, the BFGS model
    assumes a locally convex Lagrangian, and there is no feasibility
    restoration.  The reference has no NLP layer.
    """
    f64 = torch.float64
    device = torch.device("cuda" if device is None else device)
    grad_f = torch.func.grad(f)
    jac_c = torch.func.jacfwd(c)
    x = torch.as_tensor(x0, dtype=f64, device=device)
    n = x.shape[0]
    B = torch.eye(n, dtype=f64, device=device)
    l = torch.as_tensor(l, dtype=f64, device=device)
    u = torch.as_tensor(u, dtype=f64, device=device)
    mu_merit = 10.0
    tr = tr0
    y_warm = None
    settings = settings or Settings(eps_abs=1e-9, verbose=False)

    def merit(x):
        cv = c(x)
        viol = torch.clamp(l - cv, min=0.0) + torch.clamp(cv - u, min=0.0)
        return f(x) + mu_merit * torch.sum(viol)

    for it in range(max_outer):
        g = grad_f(x)
        J = torch.atleast_2d(jac_c(x))
        cv = torch.atleast_1d(c(x))
        m = cv.shape[0]
        A = torch.cat([J, torch.eye(n, dtype=f64, device=device)], 0)
        lo = torch.cat([l - cv, torch.full((n,), -tr, dtype=f64,
                                           device=device)])
        hi = torch.cat([u - cv, torch.full((n,), tr, dtype=f64,
                                           device=device)])
        res = solve(make_problem(B, g, A, lo, hi, device=device), settings,
                    y0=y_warm)
        d = res.x[0]
        y_warm = res.y[0]
        if float(torch.max(torch.abs(d))) < tol:
            return x, it
        m0 = float(merit(x))
        t = 1.0
        while t > 1e-10 and float(merit(x + t * d)) > m0 - 1e-4 * t * float(
                d @ (B @ d)):
            t *= 0.5
        x_new = x + t * d
        # damped BFGS (Powell) on the Lagrangian gradient change
        yL = (grad_f(x_new) - g
              + (torch.atleast_2d(jac_c(x_new)) - J).T @ y_warm[:m])
        s = x_new - x
        sBs = float(s @ (B @ s))
        sy = float(s @ yL)
        if sBs > 1e-14:
            theta = 1.0 if sy >= 0.2 * sBs else (0.8 * sBs) / (sBs - sy)
            r = theta * yL + (1 - theta) * (B @ s)
            B = (B - torch.outer(B @ s, B @ s) / sBs
                 + torch.outer(r, r) / float(s @ r))
        x = x_new
        tr = min(2.0 * tr, 10.0) if t == 1.0 else max(0.5 * tr, 1e-6)
    return x, max_outer
