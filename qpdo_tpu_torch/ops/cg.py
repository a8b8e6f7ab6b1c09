"""Preconditioned conjugate gradients for the Newton system, batched.

Port of ``qpdo_tpu/ops/cg.py``: ``pcg`` (l.26-73), ``pcg_refined``
(l.76-128) and ``cg_fixed`` (l.130-171).  The JAX package writes each
iteration for one system with ``lax.while_loop`` (or ``fori_loop``) and
vmaps it, so that a batch runs in lock step and a converged member takes
no-op iterations.  Here the batch is explicit: every problem carries its
own mask and iteration count, a masked iteration leaves a finished problem
untouched, and the host asks "is any problem still iterating" once every
``_CHECK_EVERY`` iterations only (an extra masked iteration changes
nothing).  Tolerances may be floats or (B,) tensors, one per problem, as
the vmapped JAX modes compute them.
"""

from __future__ import annotations

from typing import Callable

import torch

from .batched import bwhere, dot, norm2

_CHECK_EVERY = 4


def pcg(matvec: Callable, rhs, precond, tol: float, max_iter: int, x0=None):
    """Solve K x = rhs per problem with preconditioned CG; rhs is (B, n).

    ``tol`` (a float or a (B,) tensor) is relative: a problem stops when
    ||r||_2 <= tol * ||rhs||_2 (a NaN residual stops it too, as in the
    JAX package) or after
    ``max_iter`` iterations.  ``precond`` is 1/diag(K) as a (B, n) tensor
    or a callable r -> M^-1 r.  Returns (x, iters, rel_res) with iters
    (B,) int32 and rel_res (B,)."""
    if not callable(precond):
        diag_inv = precond
        precond = lambda r: diag_inv * r
    rhs_norm = norm2(rhs)
    floor = torch.clamp(rhs_norm, min=1e-30)
    tol_abs = tol * floor

    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - matvec(x) if x0 is not None else rhs
    z = precond(r)
    p = z
    rz = dot(r, z)
    k = torch.zeros(rhs.shape[:1], dtype=torch.int32, device=rhs.device)
    one = torch.ones_like(rz)
    zero = torch.zeros_like(rz)

    for it in range(max_iter):
        active = (norm2(r) > tol_abs) & (k < max_iter)
        if it % _CHECK_EVERY == 0 and not bool(active.any()):
            break
        Kp = matvec(p)
        pKp = dot(p, Kp)
        # guard: pKp can only vanish at exact convergence (K SPD)
        alpha = rz / torch.where(pKp > 0, pKp, one)
        alpha = torch.where(pKp > 0, alpha, zero)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Kp
        z = precond(r_new)
        rz_new = dot(r_new, z)
        beta = rz_new / torch.where(rz > 0, rz, one)
        p_new = z + torch.where(rz > 0, beta, zero)[:, None] * p
        x = bwhere(active, x_new, x)
        r = bwhere(active, r_new, r)
        p = bwhere(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
        k = k + active.to(torch.int32)
    rel = norm2(r) / floor
    return x, k, rel


def pcg_refined(matvec_hi: Callable, matvec_lo: Callable, rhs, precond_lo,
                tol, max_iter: int, rounds: int, lo_dtype, x0=None):
    """Mixed-precision CG per problem: ``pcg`` in ``lo_dtype`` on the
    normalized correction system inside state-dtype refinement rounds
    (each round r = rhs - K_hi x, d = pcg_lo(r / ||r||), x += ||r|| d).
    A problem stops when ||r|| <= tol * ||rhs|| or after ``rounds``
    rounds; the inner solves run at tol clipped to [1e-6, 1e-2].  A
    finished problem's inner right-hand side is zero, so its inner solve
    takes no iteration.  Returns (x, rounds_done, rel_res)."""
    dt = rhs.dtype
    B = rhs.shape[0]
    tol = torch.as_tensor(tol, dtype=dt, device=rhs.device).expand(B)
    rhs_norm = norm2(rhs)
    floor = torch.clamp(rhs_norm, min=1e-30)
    tol_abs = tol * floor
    inner_tol = torch.clamp(tol.to(lo_dtype), 1e-6, 1e-2)

    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - matvec_hi(x) if x0 is not None else rhs
    k = torch.zeros((B,), dtype=torch.int32, device=rhs.device)
    for _ in range(rounds):
        active = norm2(r) > tol_abs
        if not bool(active.any()):
            break
        rn = torch.clamp(norm2(r), min=1e-300)
        b = torch.where(active[:, None], r / rn[:, None], torch.zeros_like(r))
        d, _, _ = pcg(matvec_lo, b.to(lo_dtype), precond_lo, inner_tol,
                      max_iter)
        x_new = x + rn[:, None] * d.to(dt)
        x = bwhere(active, x_new, x)
        r = bwhere(active, rhs - matvec_hi(x_new), r)
        k = k + active.to(torch.int32)
    return x, k, norm2(r) / floor


def cg_fixed(matvec: Callable, rhs, precond, iters: int, x0=None):
    """Preconditioned CG with a fixed iteration count per problem: no
    convergence test and no early exit; a converged (or broken-down)
    problem takes no-op steps through the same division guards as
    ``pcg``.  Returns x."""
    if not callable(precond):
        diag_inv = precond
        precond = lambda r: diag_inv * r
    x = torch.zeros_like(rhs) if x0 is None else x0
    r = rhs - matvec(x) if x0 is not None else rhs
    z = precond(r)
    p = z
    rz = dot(r, z)
    one = torch.ones_like(rz)
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Kp = matvec(p)
        pKp = dot(p, Kp)
        alpha = torch.where(pKp > 0, rz / torch.where(pKp > 0, pKp, one), zero)
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * Kp
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, one), zero)
        p = z + beta[:, None] * p
        rz = rz_new
    return x
