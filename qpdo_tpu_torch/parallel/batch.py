"""Batched solving: a batch of dense QPs in lock step, on the device of
its tensors, and the batch split over the ranks of a process group.

Port of ``qpdo_tpu/parallel/batch.py``.  The JAX package's
``lax.while_loop``s become Python loops of masked steps with one host
check per chunk; the refresh cadence and the straggler compaction keep
the JAX semantics exactly (see ``_solve_batch_compact``).

Sharding.  A batch whose leaves are DTensors split along the batch axis
(``shard_problems``, ``multihost.distribute_batch``) is solved by every
rank on its own block: the problems are independent and a problem whose
status has latched is frozen, so the plain lock-step solve needs no
collective, and the results are DTensors of the global batch.  The
compacted solve decides when its full-batch phase ends from the global
count of active problems (one all-reduce per chunk, the JAX package's
"convergence all-reduce") against K = max(1, B // 4) of the global B, so
every problem takes the same chunks as in the unsharded solve.  Without
it, one thing would depend on the split: in the mixed-GEMM phase (and
with a carried KKT cache) a full-batch chunk ends with a refresh of EVERY
problem (``_run_compact``), and a problem that ended inside the chunk
then carries refreshed Qx, Ax and Aty caches; so the objective of such a
problem, computed from Qx, would differ in its last bits with the batch
around it.  The iterates, statuses and iteration counts do not depend on
it.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import constants as _c
from ..operators import cast_scaled_problem
from ..solver import core
from ..solver.scaling import scale_problem
from ..types import Problem, Result, ScaledProblem, Settings, SolverState, tree_map
from ..utils import debug as _debug
from .dtensor import dtensor_from_local, is_dtensor, local_block


def _solve_batch(problems: Problem, settings: Settings,
                 x0=None, y0=None) -> Result:
    """Plain lock-step batch: every problem runs until the slowest ends."""
    sps = scale_problem(problems, settings.scaling, settings.ruiz_kkt)
    return core.solve_scaled(sps, settings, x0, y0)


def solve_batch(problems: Problem, settings: Optional[Settings] = None,
                x0=None, y0=None, compact: bool = False) -> Result:
    """Solve a batch of QPs (leading batch axis on every Problem leaf) on
    the device of its tensors.

    ``compact=True`` enables straggler compaction (``_solve_batch_compact``).
    ``x0`` (B, n) and ``y0`` (B, m) warm-start every problem (unscaled
    points on the problems' device; None for a cold start).

    Leaves that are DTensors split along the batch axis (every rank calls
    this): each rank solves its own problems and the result's leaves are
    DTensors of the global batch (``.to_local()``: this rank's results).
    ``x0``/``y0`` are then DTensors split alike, or whole (B, .) tensors
    that every rank holds."""
    settings = settings or Settings()
    if is_dtensor(problems.Q):
        return _solve_split(problems, settings, x0, y0, compact)
    if compact:
        return _solve_batch_compact(problems, settings, x0, y0)
    return _solve_batch(problems, settings, x0, y0)


def _take(tree, idx):
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _put(tree, idx, sub):
    return tree_map(lambda a, b: a.index_copy(0, idx, b), tree, sub)


def _run_compact(sp_b: ScaledProblem, stg: Settings, state: SolverState,
                 iter_cap: int, group=None, K=None) -> SolverState:
    """One phase of the compacted solve (batch.py:80-143).

    Full-batch part, while more than K = max(1, B // 4) problems are
    active: chunks of masked steps, one host check per chunk.  With a
    mixed-GEMM phase or a carried KKT cache a chunk is exactly
    ``anchor_every`` masked steps followed by a refresh of EVERY problem,
    unmasked (batch.py:117-126); otherwise the refresh does not exist and
    the chunk length only sets how often the host checks.

    The states move whole, the carried KKT cache (an inverse or the
    incremental pair) included: ``_take`` and ``_put`` map over it.

    Compaction: the (at most K) active problems, first by index
    (``argsort(~active)`` is stable), are gathered into a sub-batch and
    run to completion by ``core.run_loop``, whose per-problem chunk ends
    and refresh masks follow the vmapped JAX loop (core.py:630-636).

    ``group``: the batch is this rank's block of a batch split over the
    ranks of ``group``, and ``K`` is the global batch's; the full-batch
    phase runs while the active count summed over the ranks is above K
    (one all-reduce per chunk).  The compaction rounds are local."""
    op = core.as_operator(sp_b)
    if K is None:
        K = max(1, state.x.shape[0] // 4)

    mixed = core.mixed_mode(stg, op)
    out = core.residual_outputs(state)

    def active_of(st):
        return (st.status == _c.UNSOLVED) & (st.iter < iter_cap)

    def global_active(st):
        n = active_of(st).sum().to(torch.int64)
        if group is not None:
            torch.distributed.all_reduce(n, group=group)
        return int(n)

    def masked_step(st):
        # problems at the iteration cap are frozen explicitly (core.step
        # only freezes status-latched ones)
        return core.masked(core.step(op, stg, st, out), st, active_of(st))

    refresh = None
    if mixed:
        refresh = core.reanchor
    elif state.kkt_cache is not None:
        refresh = core.rebuild_kkt_cache

    st = state
    with core.matmul_precision(stg.matmul_precision):
        while global_active(st) > K:
            for _ in range(stg.anchor_every):
                st = masked_step(st)
            if refresh is not None:
                st = refresh(op, stg, st)
            _debug.after_chunk(st)

        while bool(active_of(st).any()):
            order = torch.argsort((~active_of(st)).to(torch.int8), stable=True)
            idx = order[:K]
            sub = core.run_loop(_take(sp_b, idx), stg, _take(st, idx), iter_cap)
            st = _put(st, idx, sub)
    return st


def _solve_batch_compact(problems: Problem, settings: Settings,
                         x0=None, y0=None, group=None, K=None) -> Result:
    """Batched solve with straggler compaction (batch.py:55-174).  With
    ``hybrid_warmup`` on float64 data: a float32 phase to ``warmup_eps``
    (``core.warmup_settings``), ``core.upcast_state``, then the accurate
    phase; each phase runs ``_run_compact`` (``group``, ``K``: see
    there)."""
    sps = scale_problem(problems, settings.scaling, settings.ruiz_kkt)
    if settings.hybrid_warmup and sps.data.Q.dtype != torch.float32:
        stg1 = core.warmup_settings(settings)
        sp32 = cast_scaled_problem(sps, torch.float32)
        s = core.init_state(sp32, stg1,
                            *core.cast_warm_start(x0, y0, torch.float32))
        s = _run_compact(sp32, stg1, s, core.warmup_iter_cap(settings),
                         group, K)
        s = core.upcast_state(sps, settings, s)
        s = core.polish_state(sps, settings, s)
    else:
        s = core.init_state(sps, settings, x0, y0)
        if x0 is not None and y0 is not None:
            # warm-start pre-loop polish, matching core.solve_scaled
            s = core.polish_state(sps, settings, s)
    s = _run_compact(sps, settings, s, settings.max_iter, group, K)
    s = core.polish_state(sps, settings, s)
    return core.finalize(sps, settings, s)


def _solve_split(problems: Problem, settings: Settings, x0, y0,
                 compact: bool) -> Result:
    """``solve_batch`` of a batch split over the ranks of its leaves'
    mesh: each rank solves its block, the result is split alike."""
    mesh = problems.Q.device_mesh
    B = problems.Q.shape[0]
    local = Problem(*(local_block(a, mesh) for a in problems))
    if local.Q.shape[0] == 0:
        raise ValueError(f"solve_batch: {B} problems over {mesh.size()} "
                         "ranks leave a rank without a problem")
    warm = lambda v: None if v is None else torch.as_tensor(
        local_block(v, mesh), dtype=local.q.dtype, device=local.q.device)
    x0, y0 = warm(x0), warm(y0)
    if compact:
        res = _solve_batch_compact(local, settings, x0, y0,
                                   mesh.get_group(), max(1, B // 4))
    else:
        res = _solve_batch(local, settings, x0, y0)
    return tree_map(lambda a: dtensor_from_local(a, mesh, 0, B), res)


def shard_problems(problems: Problem, mesh, axis: str = "batch") -> Problem:
    """A batch that every rank holds whole, split over ``mesh`` along the
    batch axis: each leaf becomes a DTensor with ``Shard(0)`` whose local
    block is this rank's ``torch.chunk`` block (``axis`` names the mesh
    axis, as in the JAX package; the mesh is 1-D)."""
    return Problem(*(a if is_dtensor(a) else
                     dtensor_from_local(local_block(a, mesh), mesh, 0,
                                        a.shape[0])
                     for a in problems))


def solve_batch_sharded(problems: Problem, mesh,
                        settings: Optional[Settings] = None,
                        x0=None, y0=None, axis: str = "batch") -> Result:
    """Data-parallel batched solve: the batch split over the ranks of
    ``mesh`` (``shard_problems``) and solved by ``solve_batch``, every
    rank its own problems.  Every rank calls it with the same batch."""
    problems = shard_problems(problems, mesh, axis)
    return solve_batch(problems, settings, x0, y0)
