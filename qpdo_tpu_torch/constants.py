"""Solver status codes, defaults and numeric constants.

The same values as the JAX package's constants (qpdo_tpu/constants.py, itself
the reference's include/constants.h:17-69), so that statuses and stopping
behaviour match it exactly.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Status codes (reference: include/constants.h:17-26)
# ---------------------------------------------------------------------------
SOLVED = 1                  # problem solved to optimality, given the tolerance
DUAL_TERMINATED = 2         # dual objective above the specified bound (unused)
NON_CVX = -1                # problem likely non-convex (divergence)
PRIMAL_DUAL_INFEASIBLE = -2
PRIMAL_INFEASIBLE = -3
DUAL_INFEASIBLE = -4
MAX_ITER_REACHED = -5
MAX_TIME_REACHED = -6
UNSOLVED = -10              # only setup was performed
ERROR = -99
# Internal-only (TPU extension, never returned to users): latched inside
# the hybrid-warmup phase when the mu schedule stalls against the float32
# mu floor (primal residual plateau across outer updates); upcast_state
# resets it to UNSOLVED so the accurate phase takes over immediately
# instead of burning the warmup iteration cap.  See Settings.warmup_stall_exit.
WARMUP_STALLED = 90

STATUS_STRINGS = {
    SOLVED: "solved",
    DUAL_TERMINATED: "dual terminated",
    NON_CVX: "non-convex",
    PRIMAL_DUAL_INFEASIBLE: "primal-dual infeasible",
    PRIMAL_INFEASIBLE: "primal infeasible",
    DUAL_INFEASIBLE: "dual infeasible",
    MAX_ITER_REACHED: "maximum iterations reached",
    MAX_TIME_REACHED: "max time exceeded",
    UNSOLVED: "unsolved",
    ERROR: "error",
}

# ---------------------------------------------------------------------------
# Representation of infinity (reference: include/constants.h:38)
# ---------------------------------------------------------------------------
QPDO_INFTY = 1e20

# ---------------------------------------------------------------------------
# Default hyper-parameters (reference: include/constants.h:44-69)
# ---------------------------------------------------------------------------
MAX_TIME = QPDO_INFTY       # wall-clock limit in seconds
MAX_ITER = 10_000           # maximum (total Newton) iterations
INNER_MAX_ITER = 1_000      # maximum iterations per subproblem
EPS_ABS = 1e-6              # outer absolute tolerance
EPS_ABS_IN = 1.0            # initial inner absolute tolerance
EPS_PRIM_INF = 1e-6         # primal infeasibility tolerance
EPS_DUAL_INF = 1e-6         # dual infeasibility tolerance
RHO = 0.1                   # inner tolerance shrink factor
THETA = 0.25                # penalty update criterion parameter
DELTA = 1e-2                # penalty update factor
MU_MIN = 1e-9               # penalty floor

PROXIMAL = True             # use primal (proximal) regularization
SIGMA_INIT = 1e-3           # initial primal regularization
SIGMA_UPD = 1e-1            # primal regularization shrink factor
SIGMA_MIN = 1e-7            # primal regularization floor

SCALING = 10                # Ruiz equilibration iterations
MIN_SCALING = 1e-9          # norms below this are reset to 1
MAX_SCALING = 1e9

VERBOSE = False             # print iteration table (host callback)
PRINT_INTERVAL = 1

RESET_NEWTON_ITER = 1000    # kept for API parity; the TPU solver refactorizes
                            # the KKT matrix every Newton iteration, so this
                            # setting has no effect
MAX_RANK_UPDATE = 100       # ditto (no rank updates on TPU)
