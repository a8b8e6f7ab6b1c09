"""Row-sharded single-QP solving: the constraint rows of one problem split
over the ranks of a process group.

Port of ``qpdo_tpu/parallel/row_sharded.py``: the axis that grows without
bound in SVM, portfolio and scenario formulations is m (m >> n), so one
large QP's rows are split over the ranks.  The JAX package places the
arrays on a mesh and lets GSPMD insert the collectives; here every rank
calls ``solve_row_sharded`` on the whole problem, keeps its own block of
rows, and the reductions over the rows are explicit
(``operators.RowShardedOperator``, ``parallel/comm.RowComm``):

- the dual side (y, mu, Ax, the residuals, the active-set weights) lives
  on the local rows and is updated locally;
- the KKT formation A'(w A) and every A'v are local products and one
  all-reduce (SUM) each; Q and sigma*I enter K on one rank only;
- the n x n factorization and the primal vectors are replicated (n is
  the small axis by assumption), bit for bit the same on every rank;
- the norms over the rows are all-reduced (MAX), the linesearch's dots
  and hinge sums (SUM); the exact linesearch is the sort-free bisection
  (``ops/linesearch.pwa_root_bisect_split``), one all-reduce per
  iteration instead of a global sort;
- every host decision of the loop is made from reduced values, so all
  ranks take the same number of steps.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .. import constants as _c
from ..operators import RowShardedOperator
from ..solver.core import solve_scaled
from ..solver.driver import solve_driven
from ..solver.scaling import scale_problem
from ..types import Problem, Settings
from ..validate import validate_data, validate_settings
from .comm import RowComm
from .dtensor import dtensor_from_local, full_tensor, group_of, mesh_of


def pad_rows(problem: Problem, mult: int) -> Problem:
    """Pad the constraint rows of a batch of problems to a multiple of
    ``mult`` with inert free rows (A=0, l=-QPDO_INFTY, u=+QPDO_INFTY, the
    trick of ``utils/padding.pad_problem``)."""
    m = problem.m
    m_pad = -(-m // mult) * mult
    if m_pad == m:
        return problem
    A, l = problem.A, problem.l
    B, extra = A.shape[0], m_pad - m
    inf = _c.QPDO_INFTY
    full = lambda v: torch.full((B, extra), v, dtype=l.dtype, device=l.device)
    return problem._replace(
        A=torch.cat([A, A.new_zeros((B, extra, problem.n))], dim=1),
        l=torch.cat([l, full(-inf)], dim=1),
        u=torch.cat([problem.u, full(inf)], dim=1))


def pad_rows_vec(y, m_pad: int):
    """Zero-pad the last axis of ``y`` to ``m_pad`` entries."""
    m = y.shape[-1]
    if m_pad == m:
        return y
    return torch.cat([y, y.new_zeros(y.shape[:-1] + (m_pad - m,))], dim=-1)


def solve_row_sharded(problem: Problem, settings: Optional[Settings] = None,
                      x0=None, y0=None, mesh=None, axis_name: str = "rows"):
    """Solve one QP with its m constraint rows split over the ranks of
    ``mesh`` (a 1-D ``DeviceMesh``; None: a mesh named ``axis_name`` over
    every rank of the default process group).  Every rank calls it with the whole problem (a batch
    of one, as ``make_problem`` builds it, on the rank's device) and the
    same settings and warm start.

    The rows are padded to a multiple of the number of ranks with inert
    rows (the results are unaffected; the padded tail of ``y`` solves to
    0).  The linesearch is the bisection whatever ``settings.linesearch``
    says (the sort would gather the rows).  ``verbose`` and a finite
    ``max_time`` run the host-driven loop (``solver/driver.py``; rank 0
    prints, the clock's verdict is all-reduced), which the JAX package's
    row-sharded path ignores.  Returns ``(Result, m_orig)``
    on the padded shapes, as the JAX package does: ``x`` and the dual
    certificate are replicated plain tensors (the same on every rank),
    ``y`` and the primal certificate DTensors (1, m_pad) split over the
    rows (``Shard(1)``; ``.to_local()`` is this rank's block,
    ``parallel.full_tensor`` the whole)."""
    settings = settings or Settings()
    if settings.linesearch != "bisect":
        # the sorted scan would gather the row-split hinges
        settings = settings.replace(linesearch="bisect")
    validate_settings(settings)
    t0 = time.perf_counter()
    problem = Problem(*(full_tensor(a) for a in problem))
    validate_data(problem)
    if problem.Q.shape[0] != 1:
        raise ValueError("solve_row_sharded takes one problem (a batch of "
                         f"one), got a batch of {problem.Q.shape[0]}")
    mesh = mesh_of(mesh, problem.q.device, axis_name)
    comm = RowComm(group_of(mesh))
    m_orig = problem.m
    padded = pad_rows(problem, comm.size)
    m_local = padded.m // comm.size
    rows = slice(comm.rank * m_local, (comm.rank + 1) * m_local)
    local = padded._replace(A=padded.A[:, rows].contiguous(),
                            l=padded.l[:, rows].contiguous(),
                            u=padded.u[:, rows].contiguous())
    dt, dev = problem.q.dtype, problem.q.device
    if x0 is not None:
        x0 = torch.as_tensor(full_tensor(x0), dtype=dt,
                             device=dev).reshape(1, -1)
    if y0 is not None:
        y0 = torch.as_tensor(full_tensor(y0), dtype=dt,
                             device=dev).reshape(1, -1)
        y0 = pad_rows_vec(y0, padded.m)[:, rows]
    sp = scale_problem(local, settings.scaling, settings.ruiz_kkt, comm)
    op = RowShardedOperator(sp, comm)
    if settings.verbose or settings.max_time < _c.QPDO_INFTY:
        res = solve_driven(op, settings, x0, y0, t0)
    else:
        res = solve_scaled(op, settings, x0, y0)
    split = lambda v: dtensor_from_local(v, mesh, dim=1)
    return res._replace(y=split(res.y),
                        prim_inf_cert=split(res.prim_inf_cert)), m_orig
