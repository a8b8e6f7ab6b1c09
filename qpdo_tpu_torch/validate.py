"""Host-side validation of problem data and settings.

Port of ``qpdo_tpu/validate.py`` (itself the reference's guard layer,
src/validate.c:9-170): data validation checks the shapes and ``l <= u``
elementwise; settings validation range-checks every field and warns on
setting combinations that are documented to diverge.  Raises
``ValueError`` instead of returning FALSE.  The JAX package's
``warn_device_unsafe`` guards a crash of the TPU and has no counterpart.
"""

from __future__ import annotations

import warnings

import torch

from .types import Problem, Settings


class UnsafeSettingsWarning(UserWarning):
    """A settings combination documented to diverge."""


def validate_data(problem: Problem) -> None:
    """Reference: validate_data, src/validate.c:9-31 (plus the dimension
    normalization the MATLAB wrapper performs, interfaces/mex/qpdo.m:60-133).
    Reads the bounds on the host."""
    Q, q, A, l, u = problem.Q, problem.q, problem.A, problem.l, problem.u
    n = Q.shape[-1]
    m = A.shape[-2]
    if tuple(Q.shape[-2:]) != (n, n):
        raise ValueError(f"Q must be square, got {tuple(Q.shape)}")
    if q.shape[-1] != n:
        raise ValueError(f"q must have length n={n}, got {tuple(q.shape)}")
    if A.shape[-1] != n:
        raise ValueError(f"A must have n={n} columns, got {tuple(A.shape)}")
    if l.shape[-1] != m or u.shape[-1] != m:
        raise ValueError(f"l/u must have length m={m}, got "
                         f"{tuple(l.shape)}/{tuple(u.shape)}")
    if bool(torch.isnan(l).any()) or bool(torch.isnan(u).any()):
        raise ValueError("bounds must not contain NaN")
    bad = (l > u).flatten()
    if bool(bad.any()):
        j = int(torch.argmax(bad.to(torch.int8)))
        raise ValueError(
            f"Lower bound at index {j} is greater than upper bound: "
            f"{float(l.flatten()[j]):.4e} > {float(u.flatten()[j]):.4e}"
        )


def validate_settings(s: Settings) -> None:
    """Reference: validate_settings, src/validate.c:34-170."""
    if s.max_iter <= 0:
        raise ValueError("max_iter must be positive")
    if s.inner_max_iter <= 0:
        raise ValueError("inner_max_iter must be positive")
    if s.eps_abs <= 0:
        raise ValueError("eps_abs must be positive")
    if s.eps_abs_in <= 0:
        raise ValueError("eps_abs_in must be positive")
    if s.eps_prim_inf < 0:
        raise ValueError("eps_prim_inf must be nonnegative")
    if s.eps_dual_inf < 0:
        raise ValueError("eps_dual_inf must be nonnegative")
    if not (0 < s.rho < 1):
        raise ValueError("rho must be positive and smaller than 1")
    if not (0 < s.theta <= 1):
        raise ValueError("theta must be positive and smaller than or equal to 1")
    if not (0 < s.delta < 1):
        raise ValueError("delta must be positive and smaller than 1")
    if s.mu_min <= 0:
        raise ValueError("mu_min must be positive")
    if s.proximal not in (True, False, 0, 1):
        raise ValueError("proximal must be a boolean")
    if s.sigma_init <= 0:
        raise ValueError("sigma_init must be positive")
    if not (0 < s.sigma_upd <= 1):
        raise ValueError("sigma_upd must be positive and smaller than or equal to 1")
    if s.sigma_min > s.sigma_init:
        raise ValueError("sigma_min must be smaller than or equal to sigma_init")
    if s.scaling < 0:
        raise ValueError("scaling must be nonnegative")
    if s.print_interval < 0:
        raise ValueError("print_interval must be nonnegative")
    if s.reset_newton_iter < 0:
        raise ValueError("reset_newton_iter must be nonnegative")
    if s.refine_steps < 0:
        raise ValueError("refine_steps must be nonnegative")
    if s.cg_tol <= 0:
        raise ValueError("cg_tol must be positive")
    if s.cg_max_iter <= 0:
        raise ValueError("cg_max_iter must be positive")
    if s.cg_refine_rounds < 1:
        raise ValueError("cg_refine_rounds must be at least 1")
    if s.precond not in ("jacobi", "block_jacobi"):
        raise ValueError("precond must be 'jacobi' or 'block_jacobi'")
    if not 1 <= s.precond_block <= 512:
        raise ValueError("precond_block must be in [1, 512]")
    if s.precond_dtype is not None and s.precond_dtype not in (
            "float32", "float64", "bfloat16"):
        raise ValueError("precond_dtype must be None, 'bfloat16', "
                         "'float32', or 'float64'")
    if s.banded_algo not in ("auto", "scan", "cr"):
        raise ValueError("banded_algo must be 'auto', 'scan', or 'cr'")
    if s.banded_cr_levels < 0:
        raise ValueError("banded_cr_levels must be nonnegative (0 = full depth)")
    if s.banded_cr_fallback_rtol < 0:
        raise ValueError(
            "banded_cr_fallback_rtol must be nonnegative (0 disables)")
    if s.banded_escalate_rtol < 0:
        raise ValueError(
            "banded_escalate_rtol must be nonnegative (0 disables)")
    if s.kkt_escalate_rtol < 0:
        raise ValueError(
            "kkt_escalate_rtol must be nonnegative (0 disables)")
    if s.crash_recovery < 0:
        raise ValueError("crash_recovery must be nonnegative (0 disables)")
    if s.robust_gate_auto not in (True, False, 0, 1):
        raise ValueError("robust_gate_auto must be a boolean")
    if s.kkt_solver not in ("chol", "cg", "inv", "ns"):
        raise ValueError(
            "kkt_solver must be 'chol', 'cg', 'inv', or 'ns'")
    if s.kkt_inv_refresh not in (True, False, 0, 1):
        raise ValueError("kkt_inv_refresh must be a boolean")
    if s.kkt_ns_steps < 1:
        raise ValueError("kkt_ns_steps must be >= 1")
    if s.kkt_solver in ("inv", "ns") and s.kkt_update_rows > 0:
        raise ValueError(
            "kkt_solver='inv' and kkt_update_rows > 0 both claim the "
            "KKT cache slot — choose one")
    if s.kkt_cg_fixed < 0:
        raise ValueError("kkt_cg_fixed must be nonnegative (0 = while-PCG)")
    if s.linesearch not in ("sort", "bisect", "bisect_chunk"):
        raise ValueError(
            "linesearch must be 'sort', 'bisect', or 'bisect_chunk'")
    if s.warmup_stall_exit < 0 or s.warmup_stall_exit >= 1:
        raise ValueError("warmup_stall_exit must be in [0, 1) (0 disables)")
    if s.warmup_refine_steps < 0:
        raise ValueError("warmup_refine_steps must be nonnegative")
    if s.full_step_gamma <= 0:
        raise ValueError("full_step_gamma must be positive")
    if s.kkt_update_rows < 0:
        raise ValueError("kkt_update_rows must be nonnegative")
    if not (0 <= s.accel_gamma < 1):
        raise ValueError("accel_gamma must be in [0, 1)")
    if s.polish_delta <= 0:
        raise ValueError("polish_delta must be positive")
    if s.polish_refine < 0:
        raise ValueError("polish_refine must be nonnegative")
    _warn_unsafe_combos(s)


def _warn_unsafe_combos(s: Settings) -> None:
    """Warn on the combinations the JAX package measured to diverge
    (its RESULTS.md and docs/DEPLOY.md): the same rules and texts."""
    if (s.kkt_dtype == "float32" and s.mu_min < 1e-7
            and s.kkt_pcg_refine == 0):
        warnings.warn(
            "kkt_dtype='float32' with mu_min < 1e-7 and PCG refinement "
            "disabled (kkt_pcg_refine=0): a float32 factorization alone "
            "cannot carry cond(K) ~ 1/mu beyond ~1e7 — the dual step "
            "divides by mu and amplifies factor noise explosively "
            "(RESULTS.md 'level-704').  Leave kkt_pcg_refine at -1 "
            "(auto: Krylov refinement restores state-accuracy exactly "
            "in this regime), set mu_min >= 1e-7, or keep the "
            "factorization in float64 (kkt_dtype=None).",
            UnsafeSettingsWarning, stacklevel=3)
    if (s.kkt_dtype == "float32" and s.mu_min < 1e-7
            and s.banded_escalate_rtol == 0):
        warnings.warn(
            "kkt_dtype='float32' with mu_min < 1e-7 and the banded "
            "state-dtype escalation disabled (banded_escalate_rtol=0): "
            "below mu ~ 1e-7 the equilibrated KKT's spectral condition "
            "exceeds 1/eps32, the float32 block Cholesky breaks down "
            "(NaN factor), the NaN-guard zeroes the direction, and the "
            "dual update dy = w*(A dx) - ytilde staircases at rp/mu per "
            "step (round-4 LISWET mu_min<=1e-8 explosion).  Keep "
            "banded_escalate_rtol > 0 (state-dtype re-factorization "
            "exactly when the refined residual fails the gate) or set "
            "mu_min >= 1e-7.",
            UnsafeSettingsWarning, stacklevel=3)
    if (s.kkt_dtype == "float32" and s.banded_algo in ("cr", "auto")
            and s.banded_cr_fallback_rtol == 0 and s.mu_min < 1e-6
            and (not s.banded_jacobi_scale or s.banded_pcg_refine == 0)):
        warnings.warn(
            "banded_algo='cr' with the accuracy gate disabled "
            "(banded_cr_fallback_rtol=0), a float32 factorization, "
            "mu_min < 1e-6, and the round-4 stability defaults off "
            "(banded_jacobi_scale/banded_pcg_refine): float32 cyclic "
            "reduction suffers catastrophic Schur-update cancellation "
            "at cond(K) ~ 1e7 on specific active-set configurations, "
            "at any depth (RESULTS.md 'level-704').  Keep the defaults "
            "(Jacobi equilibration removes the cancellation class; PCG "
            "refinement restores state accuracy), keep the gate on, "
            "use banded_algo='scan', or raise mu_min.",
            UnsafeSettingsWarning, stacklevel=3)
