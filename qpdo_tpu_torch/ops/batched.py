"""Batch-first helpers: the per-problem reductions and selections that the
JAX package gets from ``vmap``.

Every reduction here runs over the non-batch dims only, so no problem of a
batch sees another's numbers.
"""

from __future__ import annotations

import torch


def mv(M, v):
    """Batched matvec: (B, r, c) @ (B, c) -> (B, r)."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def mtv(M, v):
    """Batched transposed matvec: (B, r, c)' @ (B, r) -> (B, c)."""
    return torch.matmul(M.mT, v.unsqueeze(-1)).squeeze(-1)


def dot(a, b):
    """Per-problem inner product of (B, k) vectors -> (B,)."""
    return torch.sum(a * b, dim=-1)


def norm2(v):
    """Per-problem Euclidean norm sqrt(sum v^2) (the jnp.linalg.norm of a
    vector, written out so that both packages round alike) -> (B,)."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def norm_inf(v):
    """Per-problem infinity norm of (B, k) vectors -> (B,), NaN-propagating."""
    return torch.amax(torch.abs(v), dim=-1)


def all_finite(t):
    """Per-problem: every entry of (B, ...) finite -> (B,) bool."""
    return torch.isfinite(t).flatten(1).all(dim=1)


def bwhere(mask, a, b):
    """Select per problem: ``mask`` (B,) picks ``a`` over ``b`` for every
    entry of that problem's (B, ...) tensors."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)
