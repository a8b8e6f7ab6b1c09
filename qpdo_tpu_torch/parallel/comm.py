"""The collectives of the distributed paths, on ``torch.distributed``.

A solve whose data is split over the ranks of a process group reduces
over the split axis explicitly: every rank computes its partial
reduction (a norm, a sum, a matvec over its own entries) and one
``all_reduce`` makes it global.  The solver core finds these
reductions through ``op.comm`` (None on every single-process operator,
where nothing changes): a comm says which entries of a problem's vectors
are split.

- ``RowComm``: the constraint rows of one problem are split (the
  row-sharded solve); dual vectors (B, m_local) are local, primal vectors
  (B, n) replicated.
- ``ScenarioComm``: the scenarios of a block-angular problem are split
  (the scenario-sharded structured solve); dual vectors are local, and a
  primal vector is the replicated x0 followed by the local scenarios' xs.

Only ``all_reduce`` (SUM, MAX), ``all_gather`` and ``broadcast`` are used:
the gloo backend takes these on CUDA tensors as well as on CPU tensors.
The result of an ``all_reduce`` is the same on every rank, so whatever is
computed from reduced values (the replicated iterate, every host
decision of the loop) is bit for bit the same on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.batched import dot


def all_reduce(tensors, op, group):
    """One ``all_reduce`` of a list of same-dtype tensors of one shape
    prefix (B,): stacked, reduced, split back.  Returns the list."""
    if not tensors:
        return []
    buf = torch.stack([t.to(tensors[0].dtype) for t in tensors])
    dist.all_reduce(buf, op=op, group=group)
    return list(buf.unbind(0))


def all_gather_cat(t, group, dim: int = -1):
    """The tensors ``t`` of every rank (equal shapes), concatenated along
    ``dim`` in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class RowComm:
    """The reductions of a problem whose constraint rows are split over
    ``group``, the same number of rows on each rank; its primal entries
    are replicated.  ``root`` is the one rank that adds replicated terms
    (Q and sigma I) into a sum that is reduced over the ranks."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.root = self.rank == 0

    def sum(self, t):
        """All-reduce (SUM) of the partial sums ``t`` over the local
        rows, in place; returns ``t``."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, dual=(), primal=()):
        """Global maxima of per-problem partial maxima: ``dual`` over the
        local rows, ``primal`` over replicated entries (returned as
        given).  One collective; returns dual + primal, in order."""
        return tuple(all_reduce(list(dual), dist.ReduceOp.MAX, self.group)
                     ) + tuple(primal)

    def dual_sum(self, *ts):
        """Global sums of per-problem partial sums over the local rows
        (one collective)."""
        return tuple(all_reduce(list(ts), dist.ReduceOp.SUM, self.group))

    def primal_dot(self, a, b):
        return dot(a, b)

    def gather_rows(self, t):
        """The rows of every rank, (B, m_local, ...) -> (B, m, ...)."""
        return all_gather_cat(t, self.group, dim=1)


class ScenarioComm(RowComm):
    """The reductions of a block-angular problem whose scenarios are
    split over ``group``: every dual entry is local, and a primal vector
    (B, n0 + S_local*ns) is the replicated x0 (its first ``n0`` entries)
    then the local scenarios' xs."""

    def __init__(self, group, n0: int):
        super().__init__(group)
        self.n0 = n0

    def max(self, dual=(), primal=()):
        return tuple(all_reduce(list(dual) + list(primal),
                                dist.ReduceOp.MAX, self.group))

    def primal_dot(self, a, b):
        """The global inner product: x0's part once (on the root), the
        scenarios' parts on every rank, one all-reduce."""
        n0 = self.n0
        part = dot(a[:, n0:], b[:, n0:])
        if self.root:
            part = part + dot(a[:, :n0], b[:, :n0])
        return self.sum(part)

    def primal_any_nonfinite(self, v):
        """Per problem: some entry of the primal vector ``v``, on any
        rank, is not finite."""
        bad = (~torch.isfinite(v).flatten(1).all(dim=1)).to(v.dtype)
        return self.max(dual=(bad,))[0] > 0
