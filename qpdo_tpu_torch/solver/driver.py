"""Host-driven solve: the verbose iteration table and ``max_time``.

Port of ``qpdo_tpu/solver/driver.py:solve_driven`` (l.175-322).  The
solver core runs from the host in pieces, so that the host can look at
the state between them:

- ``max_time`` (the reference's wall-clock check, qpdo.c:442-448): the
  loop runs in chunks of ``_TIME_CHUNK`` iterations; after each chunk the
  host reads the clock and, past the limit, ends the solve with
  MAX_TIME_REACHED.  The hybrid warmup's float32 phase is driven the same
  way, so the one clock bounds both phases.
- ``verbose`` (print_iteration each iteration, qpdo.c:353-358): the loop
  runs one step at a time and prints the table of ``utils/printing.py``;
  in the mixed-GEMM phase the host re-anchors the caches at every
  multiple of ``anchor_every`` iterations, as the JAX driver does
  (``run_loop`` counts ``anchor_every`` from the start of each chunk).

Each printed row and each clock check reads the state on the host, which
waits for the device: that is the price of the table.  One problem only
(a batch of one), like the JAX driver; batches take ``solve_batch``.  The
problem is a ``ScaledProblem`` (the dense path) or any operator of
``operators.py`` (``solve_sparse`` hands in a ``SparseOperator``).  The
JAX driver's crash snapshots and adaptive chunk sizes answer faults of
the TPU runtime and have no counterpart.

On a distributed operator (``op.comm``, the row-sharded solve) every rank
runs this loop: the clock's verdict is all-reduced, so that every rank
stops at the same chunk, and only the root rank prints.
"""

from __future__ import annotations

import time

import torch

from .. import constants as _c
from ..types import Result, Settings
from ..utils import debug, printing, profiling
from . import core

_TIME_CHUNK = 32  # iterations between wall-clock checks


def solve_driven(sp, settings: Settings, x0=None, y0=None,
                 t_start: float = None) -> Result:
    """``core.solve_scaled`` for one problem (a ``ScaledProblem`` or an
    operator), with the iteration table (``settings.verbose``) and the
    wall-clock limit (``settings.max_time``, counted from ``t_start``, a
    ``time.perf_counter()`` reading; now when None) layered on from the
    host."""
    op = core.as_operator(sp)
    if op.batch != 1:
        raise ValueError("the host-driven solve (verbose, max_time) takes a "
                         f"batch of one problem, got {op.batch}")
    t_start = time.perf_counter() if t_start is None else t_start
    timed_out = False
    comm = op.comm
    show = comm is None or comm.root

    def past_limit():
        late = time.perf_counter() - t_start > settings.max_time
        if comm is None:
            return late
        flag = torch.full((1,), float(late), dtype=op.dtype, device=op.device)
        return bool(comm.max((flag,))[0] > 0)

    if settings.hybrid_warmup and op.dtype != torch.float32:
        # the float32 phase in chunks too, under the same clock
        op32 = op.cast(torch.float32)
        stg1 = core.warmup_settings(settings)
        s = core.init_state(op32, stg1,
                            *core.cast_warm_start(x0, y0, torch.float32))
        wcap = core.warmup_iter_cap(settings)
        while int(s.status) == _c.UNSOLVED and int(s.iter) < wcap:
            s = core.run_loop(op32, stg1, s,
                              min(int(s.iter) + _TIME_CHUNK, wcap))
            if past_limit():
                timed_out = True
                break
        s = core.polish_state(op, settings, core.upcast_state(op, settings, s))
    else:
        s = core.init_state(op, settings, x0, y0)
        if x0 is not None and y0 is not None:
            # warm-start polish, as in core.solve_scaled
            s = core.polish_state(op, settings, s)

    def running():
        return (not timed_out and int(s.status) == _c.UNSOLVED
                and int(s.iter) < settings.max_iter)

    if settings.verbose:
        if show:
            printing.print_header("GPU" if op.device.type == "cuda"
                                  else "CPU")
        # the single-step loop bypasses run_loop's anchoring: re-anchor
        # from the host at the same cadence in the mixed-GEMM phase
        mixed = core.mixed_mode(settings, op)
        while running():
            prev = s
            with profiling.span("qpdo.step", op.batch):
                s = core.step(op, settings, s)
            debug.after_chunk(s)
            if mixed and int(s.iter) % settings.anchor_every == 0:
                s = core.reanchor(op, settings, s)
            it = int(prev.iter)
            if it % settings.print_interval == 0:
                objective = float(core.objective_value(op, prev.x, prev.Qx))
            if it % settings.print_interval == 0 and show:
                printing.print_iteration(
                    it, objective,
                    float(s.res_prim_norm), float(s.res_dual_norm),
                    float(s.res_prim_in_norm), float(s.res_dual_in_norm),
                    float(prev.tau))
                if int(s.oter) > int(prev.oter):
                    capped = (it - int(prev.iter_old)
                              == settings.inner_max_iter)
                    printing.print_subproblem_separator(it, capped)
            if past_limit():
                timed_out = True
    else:
        while running():
            s = core.run_loop(op, settings, s,
                              min(int(s.iter) + _TIME_CHUNK,
                                  settings.max_iter))
            if past_limit():
                timed_out = True

    unsolved = _c.MAX_TIME_REACHED if timed_out else _c.MAX_ITER_REACHED
    res = core.finalize(op, settings, core.polish_state(op, settings, s),
                        unsolved)
    if settings.verbose and show:
        printing.print_final_message(
            int(res.info.status_val), float(res.info.res_prim_norm),
            float(res.info.res_dual_norm), settings.eps_abs,
            float(res.info.objective),
            run_time=time.perf_counter() - t_start)
    return res
