"""Numerical debugging aids.

Port of ``qpdo_tpu/utils/debug.py``.  The reference has no sanitizers (a
single-threaded C solver); its debug story is commented-out consistency
checks (newton.c:71-90, linesearch.c:53-66).  Here they are functions:

- ``debug_nans()``: a context manager under which the solver loop
  (``solver/core.run_loop`` and the full-batch chunks of
  ``parallel/batch.py:_run_compact`` after every chunk of steps, and the
  host-driven loop of ``solver/driver.py`` after every step) checks the
  state with ``check_state_finite`` and raises ``FloatingPointError`` at
  the first non-finite field.  PyTorch has no global NaN trap like
  ``jax_debug_nans``; the check reads the state on the host, and costs a
  flag test per chunk when off.
- ``newton_system_residual``: the reference's debug-mode verification of
  the semismooth Newton direction (newton.c:73-89), per problem.
- ``linesearch_residual``: psi'(tau) at the returned stepsize
  (linesearch.c:55-65), per problem.
- ``check_state_finite``: raise if a SolverState holds NaN or Inf.
"""

from __future__ import annotations

import contextlib

import torch

_check_nans = False


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Check the solver state for NaN and Inf after every chunk of the
    loop while the context is open (the previous setting is restored on
    exit)."""
    global _check_nans
    old = _check_nans
    _check_nans = enable
    try:
        yield
    finally:
        _check_nans = old


def after_chunk(state) -> None:
    """The loop's hook: ``check_state_finite`` under ``debug_nans``."""
    if _check_nans:
        check_state_finite(state)


def _leaves(value):
    if value is None:
        return []
    if isinstance(value, tuple):
        return [t for v in value for t in _leaves(v)]
    return [value]


def check_state_finite(state) -> None:
    """Raise ``FloatingPointError`` naming every field of ``state`` (a
    SolverState of any batch) that holds a NaN or an Inf."""
    bad = [name for name, v in state._asdict().items()
           if not all(bool(torch.isfinite(t).all()) for t in _leaves(v))]
    if bad:
        raise FloatingPointError(f"non-finite state fields: {bad}")


def newton_system_residual(op, state, settings, dx, dy, active,
                           res_prim_in, res_dual_in):
    """Per problem, ||(Q + sigma I) dx + A' dy + res_dual_in||_inf and the
    complementary primal piece (newton.c:73-89); both ~0 for a correct
    Newton direction.  ``op`` is a ScaledProblem or an operator; every
    vector is batch-first and the results are (B,)."""
    from ..solver.core import as_operator

    op = as_operator(op)
    r1 = op.Qmv(dx) + op.Atmv(dy) + res_dual_in
    if settings.proximal:
        r1 = r1 + state.sigma[:, None] * dx
    a1 = torch.amax(torch.abs(r1), dim=-1)
    Adx = op.Amv(dx)
    r2 = torch.where(active > 0, res_prim_in - dy * state.mu + Adx,
                     res_prim_in - 0.5 * dy * state.mu)
    return a1, torch.amax(torch.abs(r2), dim=-1)


def linesearch_residual(tau, eta, beta, delta, alpha):
    """psi'(tau)/2 at the returned stepsize (linesearch.c:55-65), ~0; tau,
    eta and beta are (B,), delta and alpha (B, k)."""
    hinge = torch.clamp(delta * tau[:, None] - alpha, min=0.0)
    return eta * tau + beta + torch.sum(delta * hinge, dim=-1)
