"""Batched solving: a batch of dense QPs in lock step, on the device of
its tensors.

Port of ``qpdo_tpu/parallel/batch.py`` (``_solve_batch``,
``_solve_batch_compact``, ``solve_batch``; no sharding).  The JAX
package's ``lax.while_loop``s become Python loops of masked steps with one
host check per chunk; the refresh cadence and the straggler compaction
keep the JAX semantics exactly (see ``_solve_batch_compact``).
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
from ..validate import validate_fused_kkt


def _solve_batch(problems: Problem, settings: Settings,
                 x0=None, y0=None) -> Result:
    """Plain lock-step batch: every problem runs until the slowest ends."""
    validate_fused_kkt(settings, problems.n, problems.Q.device,
                       problems.Q.dtype)
    sps = scale_problem(problems, settings.scaling, settings.ruiz_kkt)
    return core.solve_scaled(sps, settings, x0, y0)


def solve_batch(problems: Problem, settings: Optional[Settings] = None,
                x0=None, y0=None, compact: bool = False) -> Result:
    """Solve a batch of QPs (leading batch axis on every Problem leaf) on
    the device of its tensors.

    ``compact=True`` enables straggler compaction (``_solve_batch_compact``).
    ``x0`` (B, n) and ``y0`` (B, m) warm-start every problem (unscaled
    points on the problems' device; None for a cold start)."""
    settings = settings or Settings()
    if compact:
        return _solve_batch_compact(problems, settings, x0, y0)
    return _solve_batch(problems, settings, x0, y0)


def _take(tree, idx):
    return tree_map(lambda a: a.index_select(0, idx), tree)


def _put(tree, idx, sub):
    return tree_map(lambda a, b: a.index_copy(0, idx, b), tree, sub)


def _run_compact(sp_b: ScaledProblem, stg: Settings, state: SolverState,
                 iter_cap: int) -> SolverState:
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
    and refresh masks follow the vmapped JAX loop (core.py:630-636)."""
    op = core.as_operator(sp_b)
    B = state.x.shape[0]
    K = max(1, B // 4)
    mixed = core.mixed_mode(stg, op)
    out = core.residual_outputs(state)

    def active_of(st):
        return (st.status == _c.UNSOLVED) & (st.iter < iter_cap)

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
        while int(active_of(st).sum()) > K:
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
                         x0=None, y0=None) -> Result:
    """Batched solve with straggler compaction (batch.py:55-174).  With
    ``hybrid_warmup`` on float64 data: a float32 phase to ``warmup_eps``
    (``core.warmup_settings``), ``core.upcast_state``, then the accurate
    phase; each phase runs ``_run_compact``."""
    validate_fused_kkt(settings, problems.n, problems.Q.device,
                       problems.Q.dtype)
    sps = scale_problem(problems, settings.scaling, settings.ruiz_kkt)
    if settings.hybrid_warmup and sps.data.Q.dtype != torch.float32:
        stg1 = core.warmup_settings(settings)
        sp32 = cast_scaled_problem(sps, torch.float32)
        s = core.init_state(sp32, stg1,
                            *core.cast_warm_start(x0, y0, torch.float32))
        s = _run_compact(sp32, stg1, s, core.warmup_iter_cap(settings))
        s = core.upcast_state(sps, settings, s)
        s = core.polish_state(sps, settings, s)
    else:
        s = core.init_state(sps, settings, x0, y0)
        if x0 is not None and y0 is not None:
            # warm-start pre-loop polish, matching core.solve_scaled
            s = core.polish_state(sps, settings, s)
    s = _run_compact(sps, settings, s, settings.max_iter)
    s = core.polish_state(sps, settings, s)
    return core.finalize(sps, settings, s)
