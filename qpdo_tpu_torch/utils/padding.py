"""Problem padding and size-bucketing for batched solving.

Port of ``qpdo_tpu/utils/padding.py``.  A batch solves in lock step at one
(n, m), so problems of other sizes are padded to a common shape.  Padding
is *inert*: it never changes the solution, iterates, statuses or
certificates of the original problem.

- Padded variables get Q = 1 on the diagonal, q = 0 and a zero A column:
  they start at 0 and stay at 0 (their Newton equations are 1*dx = 0) and
  add nothing to any residual or objective.
- Padded constraint rows get a zero A row and bounds -+QPDO_INFTY: never
  active, their residuals are exactly 0, and their linesearch hinge terms
  carry delta = 0 (ignored, ``ops/linesearch.py``).

``bucket_problems`` groups problems of many sizes into shape buckets (n
and m rounded up to multiples) so that a stream of arbitrary QPs runs as
a few lock-step batches.  The port is batch-first: a problem here is a
``Problem`` with a leading batch axis (one problem is a batch of one, as
``make_problem`` builds it), and every tensor stays on its problem's
device.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch

from .. import constants as _c
from ..types import Problem, Result, tree_map


def pad_problem(problem: Problem, n_pad: int, m_pad: int) -> Problem:
    """Pad every problem of a batch to (n_pad, m_pad) variables and
    constraints, inertly."""
    n, m = problem.n, problem.m
    if n_pad < n or m_pad < m:
        raise ValueError(f"pad target ({n_pad},{m_pad}) smaller than ({n},{m})")
    B = problem.Q.shape[0]
    like = dict(dtype=problem.Q.dtype, device=problem.Q.device)
    inf = _c.QPDO_INFTY

    Q = torch.zeros((B, n_pad, n_pad), **like)
    Q[:, :n, :n] = problem.Q
    idx = torch.arange(n, n_pad, device=Q.device)
    Q[:, idx, idx] = 1.0
    q = torch.zeros((B, n_pad), **like)
    q[:, :n] = problem.q
    A = torch.zeros((B, m_pad, n_pad), **like)
    A[:, :m, :n] = problem.A
    l = torch.full((B, m_pad), -inf, **like)
    l[:, :m] = problem.l
    u = torch.full((B, m_pad), inf, **like)
    u[:, :m] = problem.u
    return Problem(Q=Q, q=q, A=A, l=l, u=u, c=problem.c)


def unpad_result(result: Result, n: int, m: int) -> Result:
    """Slice a Result of padded problems back to (n, m)."""
    return result._replace(
        x=result.x[..., :n], y=result.y[..., :m],
        prim_inf_cert=result.prim_inf_cert[..., :m],
        dual_inf_cert=result.dual_inf_cert[..., :n])


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def bucket_problems(problems: Sequence[Problem], n_mult: int = 32,
                    m_mult: int = 32
                    ) -> Dict[Tuple[int, int], Tuple[Problem, List[int]]]:
    """Group problems (each a batch of one, as ``make_problem`` gives
    them) into padded, stacked batches by rounded shape.

    Returns {(n_pad, m_pad): (Problem with one batch entry per member,
    original indices)}.  Solve each with ``parallel.solve_batch`` and map
    the results back with ``unpad_result`` and the index list."""
    groups: Dict[Tuple[int, int], List[int]] = defaultdict(list)
    for i, p in enumerate(problems):
        if p.Q.dim() != 3 or p.Q.shape[0] != 1:
            raise ValueError(f"problem {i}: expected a batch of one, got Q "
                             f"{tuple(p.Q.shape)}")
        groups[(_round_up(p.n, n_mult), _round_up(p.m, m_mult))].append(i)

    out = {}
    for (n_pad, m_pad), idxs in groups.items():
        padded = [pad_problem(problems[i], n_pad, m_pad) for i in idxs]
        out[(n_pad, m_pad)] = (tree_map(lambda *xs: torch.cat(xs), *padded),
                               idxs)
    return out


def solve_heterogeneous(problems: Sequence[Problem], settings=None,
                        n_mult: int = 32, m_mult: int = 32) -> List[Result]:
    """Solve a list of problems of any sizes by bucketed batched solves,
    on the device of their tensors.  Returns one Result per problem (a
    batch of one, as ``solve`` returns it), in input order."""
    from ..parallel.batch import solve_batch

    results: List = [None] * len(problems)
    for stacked, idxs in bucket_problems(problems, n_mult, m_mult).values():
        res = solve_batch(stacked, settings)
        for k, i in enumerate(idxs):
            one = tree_map(lambda a: a[k:k + 1], res)
            results[i] = unpad_result(one, problems[i].n, problems[i].m)
    return results
