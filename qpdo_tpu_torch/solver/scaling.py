"""Ruiz equilibration and cost scaling, batched.

Port of ``qpdo_tpu/solver/scaling.py`` (itself the reference's
src/scaling.c:24-91).  The fixed count of Ruiz passes is a Python loop;
every norm is taken per problem (over its own rows or columns).  With a
comm (``parallel/comm.py``: the rows split over ranks, ``RowComm``) the
column norms of A, maxima over the rows, are reduced over the ranks.
"""

from __future__ import annotations

import torch

from .. import constants as _c
from ..types import Problem, Scaling, ScaledProblem
from ..utils import profiling


def limit_scaling(v):
    """Reset norms below MIN_SCALING to 1 (scaling.c:13-18)."""
    return torch.where(v < _c.MIN_SCALING, torch.ones_like(v), v)


def _col_max(A, comm):
    """max_i |A_ij| per problem and column, over every rank's rows."""
    c = torch.amax(torch.abs(A), dim=-2)
    return c if comm is None else comm.max((c,))[0]


def ruiz_equilibrate(A, iters: int, comm=None):
    """``iters`` Ruiz passes on A (B, m, n).  Returns (A_scaled, D, E) with
    A_scaled = diag(E) A diag(D) per problem."""
    B, m, n = A.shape
    D = torch.ones((B, n), dtype=A.dtype, device=A.device)
    E = torch.ones((B, m), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        d = torch.rsqrt(limit_scaling(_col_max(A, comm)))               # (B, n)
        e = torch.rsqrt(limit_scaling(torch.amax(torch.abs(A), dim=-1)))  # (B, m)
        A = A * e[..., :, None] * d[..., None, :]
        D, E = D * d, E * e
    return A, D, E


def ruiz_equilibrate_kkt(Q, A, iters: int, comm=None):
    """Ruiz passes on the full KKT structure [[Q, A'], [A, 0]] per problem.
    Returns (Q_scaled, A_scaled, D, E)."""
    B, m, n = A.shape
    D = torch.ones((B, n), dtype=A.dtype, device=A.device)
    E = torch.ones((B, m), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        colQ = torch.amax(torch.abs(Q), dim=-2)
        colA = _col_max(A, comm)
        d = torch.rsqrt(limit_scaling(torch.maximum(colQ, colA)))
        e = torch.rsqrt(limit_scaling(torch.amax(torch.abs(A), dim=-1)))
        Q = Q * d[..., :, None] * d[..., None, :]
        A = A * e[..., :, None] * d[..., None, :]
        D, E = D * d, E * e
    return Q, A, D, E


@profiling.spanned("qpdo.scale")
def scale_problem(problem: Problem, scaling_iters: int,
                  ruiz_kkt: bool = False, comm=None) -> ScaledProblem:
    """Scale a batch of problems (scale_data, scaling.c:24-91).  Bounds are
    clamped to +-QPDO_INFTY first; the finite-bound masks come from the
    clamped, unscaled bounds.  ``comm``: ``problem`` holds this rank's
    rows of A, l and u (the row-sharded solve)."""
    dt = problem.Q.dtype
    inf = _c.QPDO_INFTY
    l = torch.clamp(problem.l.to(dt), -inf, inf)
    u = torch.clamp(problem.u.to(dt), -inf, inf)
    l_finite = (l > -inf).to(dt)
    u_finite = (u < inf).to(dt)

    Q = problem.Q.to(dt)
    A = problem.A.to(dt)
    q = problem.q.to(dt)
    B, n = q.shape
    m = A.shape[-2]
    if scaling_iters == 0:
        D = torch.ones((B, n), dtype=dt, device=q.device)
        E = torch.ones((B, m), dtype=dt, device=q.device)
        cost = torch.ones((B,), dtype=dt, device=q.device)
    else:
        if ruiz_kkt:
            Q, A, D, E = ruiz_equilibrate_kkt(Q, A, scaling_iters, comm)
        else:
            A, D, E = ruiz_equilibrate(A, scaling_iters, comm)
            Q = Q * D[..., :, None] * D[..., None, :]
        q = q * D
        cost = 1.0 / torch.clamp(torch.amax(torch.abs(q), dim=-1), min=1.0)
        q = q * cost[:, None]
        Q = Q * cost[:, None, None]
        l = E * l
        u = E * u

    scaling = Scaling(D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E, c=cost,
                      cinv=1.0 / cost)
    norm_q = torch.amax(torch.abs(scaling.Dinv * q), dim=-1)
    data = Problem(Q=Q, q=q, A=A, l=l, u=u,
                   c=torch.as_tensor(problem.c, dtype=dt, device=q.device))
    return ScaledProblem(data=data, scaling=scaling, l_finite=l_finite,
                         u_finite=u_finite, norm_q=norm_q)
