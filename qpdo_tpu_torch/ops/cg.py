"""Preconditioned conjugate gradients for the Newton system, batched.

Port of ``qpdo_tpu/ops/cg.py:pcg`` (l.26-73).  The JAX package writes the
iteration for one system with ``lax.while_loop`` and vmaps it, so that a
batch runs in lock step and a converged member takes no-op iterations.
Here the batch is explicit: every problem carries its own mask, a masked
iteration leaves a finished problem untouched, and the host asks "is any
problem still iterating" once every ``_CHECK_EVERY`` iterations only (an
extra masked iteration changes nothing).
"""

from __future__ import annotations

from typing import Callable

import torch

from .batched import bwhere, dot, norm2

_CHECK_EVERY = 4


def pcg(matvec: Callable, rhs, precond, tol: float, max_iter: int, x0=None):
    """Solve K x = rhs per problem with preconditioned CG; rhs is (B, n).

    ``tol`` is relative: a problem stops when ||r||_2 <= tol * ||rhs||_2
    (a NaN residual stops it too, as in the JAX package) or after
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
