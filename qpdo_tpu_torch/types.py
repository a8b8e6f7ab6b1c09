"""Core types of the PyTorch port: the JAX package's types
(qpdo_tpu/types.py) as plain containers of batch-first tensors.

* ``Problem``, ``Scaling``, ``ScaledProblem``, ``SolverState``, ``Info``
  and ``Result`` are NamedTuples of tensors.  Every leaf carries a leading
  batch axis B: a per-problem vector is (B, n) or (B, m), a per-problem
  matrix (B, n, n) or (B, m, n), and a per-problem scalar (B,).  Nothing
  is vmapped: every function of the port takes the whole batch.
* ``Settings`` is a frozen dataclass with every field and default of
  ``qpdo_tpu.types.Settings``, so that one settings object configures both
  packages (``qpdo_tpu_torch.convert.settings``).  The field comments of
  ``qpdo_tpu.types.Settings`` document each field; the notes below say
  only where the port reads a field differently.

Kernel flags.  ``pallas_formation``, ``pallas_residuals`` and
``pallas_kkt`` keep their names, but in the port they do not choose
between a kernel and plain tensor code.  The device does: a CUDA tensor
always goes through the hand-written CUDA kernel
(``ops/fused_formation.py``, ``ops/fused_residuals.py``,
``ops/fused_kkt.py``) and a CPU tensor through the kernel's plain PyTorch
version.  The flags keep only the
arithmetic the JAX package ties to them, so that both packages agree bit
for bit where they can: ``pallas_formation`` selects the order in which
the Newton solve computes the weights (``ops/linalg.newton_system_solve``)
and ``pallas_residuals`` selects how the step recovers the linesearch's
``df`` (``solver/core.step``).  ``pallas_kkt`` selects the fused Newton
solve: formation, Jacobi scaling, Cholesky and both substitutions in one
kernel, in float32 whatever ``kkt_dtype`` says
(``ops/linalg.newton_system_solve``).  As in the JAX package, a device
takes it only where the KKT dtype resolves to float32
(``ops/linalg.fused_kkt_route``), for any n: the kernel keeps K in
registers, shared memory, a thread-block cluster's shared memory or global
memory as B and n require (``ops/fused_kkt.kernel_route``).

Matmul precision.  ``matmul_precision`` and ``warmup_matmul_precision``
set PyTorch's TF32 switches for the phase they govern: "highest" (the
default) runs every float32 matmul in full float32
(``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``, set explicitly).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from . import constants as _c


class Problem(NamedTuple):
    """A batch of convex QPs: minimize 0.5 x'Qx + q'x + c s.t. l <= Ax <= u."""

    Q: torch.Tensor  # (B, n, n)
    q: torch.Tensor  # (B, n)
    A: torch.Tensor  # (B, m, n)
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)
    c: torch.Tensor  # (B,) constant cost term

    @property
    def n(self) -> int:
        return self.Q.shape[-1]

    @property
    def m(self) -> int:
        return self.A.shape[-2]


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings: the fields and defaults of ``qpdo_tpu.types.Settings``.

    Every field is read where the JAX package reads it, except
    ``crash_recovery`` (a workaround for the TPU worker's crashes, not
    ported)."""

    max_time: float = _c.MAX_TIME
    max_iter: int = _c.MAX_ITER
    inner_max_iter: int = _c.INNER_MAX_ITER
    eps_abs: float = _c.EPS_ABS
    eps_abs_in: float = _c.EPS_ABS_IN
    eps_prim_inf: float = _c.EPS_PRIM_INF
    eps_dual_inf: float = _c.EPS_DUAL_INF
    rho: float = _c.RHO
    theta: float = _c.THETA
    delta: float = _c.DELTA
    mu_min: float = _c.MU_MIN
    proximal: bool = _c.PROXIMAL
    sigma_init: float = _c.SIGMA_INIT
    sigma_upd: float = _c.SIGMA_UPD
    sigma_min: float = _c.SIGMA_MIN
    scaling: int = _c.SCALING
    verbose: bool = _c.VERBOSE
    print_interval: int = _c.PRINT_INTERVAL
    reset_newton_iter: int = _c.RESET_NEWTON_ITER
    refine_steps: int = 1
    kkt_dtype: Optional[str] = None
    hybrid_warmup: bool = False
    warmup_eps: float = 1e-3
    warmup_mu_min: float = 1e-4
    warmup_stall_exit: float = 0.9
    warmup_refine_steps: int = 1
    stall_exit: float = 0.0
    warm_mu_adapt: bool = True
    warm_mu_scale_min: float = 1e-2
    linesearch: str = "sort"
    cert_dtype: Optional[str] = None
    linesearch_dtype: Optional[str] = None
    phase2_gemm_dtype: Optional[str] = None
    hard_rows: int = 16
    anchor_every: int = 8
    cg_tol: float = 1e-8
    cg_max_iter: int = 500
    ruiz_kkt: bool = False
    cg_dtype: Optional[str] = None
    cg_refine_rounds: int = 4
    precond: str = "block_jacobi"
    precond_block: int = 64
    precond_dtype: Optional[str] = None
    newton_direct: bool = True
    banded_algo: str = "auto"
    banded_cr_levels: int = 0
    banded_cr_fallback_rtol: float = 1e-3
    banded_jacobi_scale: bool = True
    banded_pcg_refine: int = 32
    banded_escalate_rtol: float = 1e-6
    robust_gate_auto: bool = True
    kkt_solver: str = "chol"
    kkt_ns_steps: int = 2
    kkt_inv_refresh: bool = True
    kkt_cg_fixed: int = 0
    kkt_pcg_refine: int = -1
    kkt_escalate_rtol: float = 1e-6
    precond_two_level: bool = True
    # Kernel flags: see the module docstring (the device picks kernel or
    # plain version; the flags keep only their arithmetic).
    pallas_formation: bool = False
    pallas_residuals: bool = False
    pallas_kkt: bool = False
    crash_recovery: int = 2
    fused_newton_rhs: bool = False
    warmup_matmul_precision: str = "highest"
    newton_full_step: bool = True
    full_step_gamma: float = 0.9
    kkt_update_rows: int = 0
    polish: bool = False
    polish_delta: float = 1e-8
    polish_refine: int = 2
    accel_gamma: float = 0.0
    matmul_precision: str = "highest"

    def replace(self, **kw) -> "Settings":
        return dataclasses.replace(self, **kw)


class Scaling(NamedTuple):
    """Ruiz equilibration state; identity vectors when scaling is off."""

    D: torch.Tensor     # (B, n) primal scaling
    Dinv: torch.Tensor  # (B, n)
    E: torch.Tensor     # (B, m) dual scaling
    Einv: torch.Tensor  # (B, m)
    c: torch.Tensor     # (B,) cost scaling
    cinv: torch.Tensor  # (B,)


class ScaledProblem(NamedTuple):
    """Scaled problem data, its scaling, and the bound-finiteness masks."""

    data: Problem             # scaled: Q<-cDQD, q<-cDq, A<-EAD, l/u<-E*l/u
    scaling: Scaling
    l_finite: torch.Tensor    # (B, m) 1.0 where l > -inf
    u_finite: torch.Tensor    # (B, m) 1.0 where u < +inf
    norm_q: torch.Tensor      # (B,) ||Dinv*q_scaled||_inf


class SolverState(NamedTuple):
    """Loop-carried iterate of a batch (scaled space); scalars are (B,)."""

    x: torch.Tensor             # (B, n)
    y: torch.Tensor             # (B, m)
    Qx: torch.Tensor            # (B, n) cached Q @ x (without sigma*x)
    Ax: torch.Tensor            # (B, m) cached A @ x
    Aty: torch.Tensor           # (B, n) cached A' @ y
    dx_prev: torch.Tensor       # (B, n) previous Newton direction
    xbar: torch.Tensor          # (B, n) proximal center, primal
    ybar: torch.Tensor          # (B, m) proximal center, dual
    mu: torch.Tensor            # (B, m) per-constraint penalties
    sigma: torch.Tensor         # (B,) primal regularization
    eps_in: torch.Tensor        # (B,) inner tolerance
    res_prim_old: torch.Tensor  # (B, m) outer primal residual at last prox update
    tau: torch.Tensor           # (B,) last linesearch step
    iter: torch.Tensor          # (B,) int32 total iterations
    iter_old: torch.Tensor      # (B,) int32 iteration of the last subproblem end
    oter: torch.Tensor          # (B,) int32 outer iterations
    status: torch.Tensor        # (B,) int32 status; UNSOLVED while running
    res_prim_norm: torch.Tensor
    res_dual_norm: torch.Tensor
    res_prim_in_norm: torch.Tensor
    res_dual_in_norm: torch.Tensor
    # the carried KKT cache: the (B, n, n) explicit inverse (kkt_solver
    # "inv" and "ns"), the incremental pair (K_tilde (B, n, n), w_applied
    # (B, m)) of kkt_update_rows > 0, or None
    kkt_cache: Optional[object] = None
    # (B,) int32 iteration count at the hybrid-warmup phase boundary
    warmup_iter: Optional[torch.Tensor] = None


class Info(NamedTuple):
    """Solve diagnostics of a batch; every field is (B,)."""

    iterations: torch.Tensor
    oterations: torch.Tensor
    status_val: torch.Tensor
    res_prim_norm: torch.Tensor
    res_dual_norm: torch.Tensor
    res_prim_in_norm: torch.Tensor
    res_dual_in_norm: torch.Tensor
    objective: torch.Tensor
    setup_time: torch.Tensor
    solve_time: torch.Tensor
    run_time: torch.Tensor
    warmup_iterations: Optional[torch.Tensor] = None

    @property
    def status(self) -> list:
        """Status strings, one per problem (reads the tensor on the host)."""
        return [_c.STATUS_STRINGS.get(int(v), "unrecognised status value")
                for v in self.status_val.tolist()]


class Result(NamedTuple):
    """Solve output of a batch: x, y, the infeasibility certificates
    (NaN-filled according to status) and Info."""

    x: torch.Tensor              # (B, n)
    y: torch.Tensor              # (B, m)
    prim_inf_cert: torch.Tensor  # (B, m)
    dual_inf_cert: torch.Tensor  # (B, n)
    info: Info


def tree_map(fn, first, *rest):
    """Apply ``fn`` field by field over NamedTuples of tensors (nested
    NamedTuples and plain tuples recurse; a field that is None in
    ``first`` stays None)."""
    out = []
    for i, leaf in enumerate(first):
        others = [r[i] for r in rest]
        if leaf is None:
            out.append(None)
        elif isinstance(leaf, tuple):
            out.append(tree_map(fn, leaf, *others))
        else:
            out.append(fn(leaf, *others))
    return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
