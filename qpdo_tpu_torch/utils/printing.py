"""Iteration-table and final-message printing.

Port of ``qpdo_tpu/utils/printing.py`` (format parity with the reference's
print_header / print_iteration / print_final_message, src/util.c:97-175):
a 76-char table of iteration, objective, outer residual pair, inner
residual pair and stepsize, then a status box with residuals against
tolerances and the runtime.  Every line is the JAX package's, except that
the header names the device the solve runs on.
"""

from __future__ import annotations

from .. import constants as _c

_RULE = "=" * 76

_FINAL_LINES = {
    _c.SOLVED: "| QPDO finished successfully.                                              |",
    _c.PRIMAL_INFEASIBLE: "| QPDO detected a primal infeasible problem.                               |",
    _c.DUAL_INFEASIBLE: "| QPDO detected a dual infeasible problem.                                 |",
    _c.PRIMAL_DUAL_INFEASIBLE: "| QPDO detected a primal-dual infeasible problem.                          |",
    _c.MAX_ITER_REACHED: "| QPDO hit the maximum number of iterations.                               |",
    _c.MAX_TIME_REACHED: "| QPDO exceeded the specified time limit.                                  |",
    _c.NON_CVX: "| QPDO detected a likely non-convex problem.                               |",
}


def print_header(device: str = "GPU", out=print) -> None:
    """The table's header; ``device`` is a three-letter name ("GPU",
    "CPU")."""
    out(_RULE)
    out(f"===                            QPDO on {device:<3}                               ===")
    out(_RULE)
    out("  iter |  objective     r.prim     r.dual |  r.p. in    r.d. in   stepsize | ")
    out(_RULE)


def print_iteration(it, objective, rp, rd, rpin, rdin, tau, out=print) -> None:
    out(f"{it:6d} | {objective:<+.3e}   {rp:.2e}   {rd:.2e} | "
        f"{rpin:.2e}   {rdin:.2e}   {tau:.2e} | ")


def print_subproblem_separator(it, capped: bool, out=print) -> None:
    """qpdo.c:412-423: a solid rule when the subproblem converged, a dashed
    one when it was stopped by inner_max_iter."""
    if capped:
        out(f"{it:6d} |--  --  --  --  --  --  --  --  --  --  --  --  --  --  --  --  -- |")
    else:
        out(f"{it:6d} |-------------------------------------------------------------------|")


def print_final_message(status_val, rp, rd, eps_abs, objective,
                        run_time=None, out=print) -> None:
    out(_RULE)
    out(_FINAL_LINES.get(status_val,
                         "| QPDO returned an unrecognised status.                                    |"))
    out(f"| primal residual: {rp:5.4e},                primal tolerance: {eps_abs:5.4e} |")
    out(f"| dual residual  : {rd:5.4e},                dual tolerance  : {eps_abs:5.4e} |")
    out(f"| objective value: {objective:<+5.4e}                                             |")
    if run_time is not None:
        if run_time > 1.0:
            out(f"| runtime:         {run_time:4.2f} seconds" + " " * 42 + "|")
        else:
            out(f"| runtime:         {run_time * 1000:4.2f} milliseconds" + " " * 37 + "|")
    out(_RULE)
    out("")
