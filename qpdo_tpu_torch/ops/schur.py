"""Schur-complement solve of block-angular (arrow) KKT systems, batched.

Port of ``qpdo_tpu/ops/schur.py``.  When the constraint matrix is
block-angular (scenario-structured MPC, two-stage stochastic programs),
the Newton KKT matrix has the arrow form

    K = [[K00, B_1', ..., B_S'],
         [B_1, K_11,          ],
         [ .         .        ],
         [B_S,          K_SS ]]

with a small coupled block (the n0 first-stage variables) and S
independent scenario blocks.  The solve goes

  1. per scenario: factor K_ss and apply it to [B_s | r_s], giving
     B_s' K_ss^-1 B_s and B_s' K_ss^-1 r_s (one batched Cholesky over
     every problem and scenario);
  2. the reduction over the scenarios:
     S0 = K00 - sum_s B_s' K_ss^-1 B_s and its right-hand side;
  3. the dense n0 x n0 Schur system;
  4. back-substitution x_s = K_ss^-1 (r_s - B_s x0).

Every array is batch-first: K00 (B, n0, n0), Kss (B, S, ns, ns), Bs
(B, S, ns, n0), r0 (B, n0), rs (B, S, ns).  ``arrow_solve_sharded``
splits the scenarios over the ranks of a process group: steps 1 and 4
are local, step 2 is one all-reduce, step 3 runs on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed

from .linalg import cholesky_solve


class ArrowSystem(NamedTuple):
    """Arrow-structured SPD systems of a batch: the dense coupled block
    and the scenario blocks."""

    K00: torch.Tensor  # (B, n0, n0)     coupled block, SPD
    Kss: torch.Tensor  # (B, S, ns, ns)  scenario diagonal blocks, SPD
    Bs: torch.Tensor   # (B, S, ns, n0)  coupling blocks


def local_contribution(Kss, Bs, rs, refine_steps: int = 0):
    """Per scenario: K_ss^-1 [B_s | r_s] by one batched Cholesky solve,
    and the Schur contributions.  Returns (B_s' K_ss^-1 B_s
    (B, S, n0, n0), B_s' K_ss^-1 r_s (B, S, n0), K_ss^-1 B_s
    (B, S, ns, n0), K_ss^-1 r_s (B, S, ns))."""
    Bn, S, ns, n0 = Bs.shape
    rhs = torch.cat([Bs, rs[..., None]], dim=-1)            # (B, S, ns, n0+1)
    sol = cholesky_solve(Kss.reshape(Bn * S, ns, ns),
                         rhs.reshape(Bn * S, ns, n0 + 1),
                         refine_steps).reshape(Bn, S, ns, n0 + 1)
    KinvB, Kinvr = sol[..., :-1], sol[..., -1]
    return (Bs.mT @ KinvB, (Bs.mT @ Kinvr[..., None])[..., 0], KinvB,
            Kinvr)


def arrow_solve(system: ArrowSystem, r0, rs, refine_steps: int = 0):
    """Solve the arrow systems of a batch on one device.  Returns (x0
    (B, n0), xs (B, S, ns))."""
    SB, Sr, KinvB, Kinvr = local_contribution(system.Kss, system.Bs, rs,
                                              refine_steps)
    S0 = system.K00 - SB.sum(dim=1)
    rhs0 = r0 - Sr.sum(dim=1)
    x0 = cholesky_solve(S0, rhs0, refine_steps)
    xs = Kinvr - (KinvB @ x0[:, None, :, None])[..., 0]
    return x0, xs


def arrow_solve_sharded(system: ArrowSystem, r0, rs, mesh, axis="scenario"):
    """The arrow solve with the scenarios split over the ranks of ``mesh``
    (a 1-D ``DeviceMesh``; ``axis`` names its axis, as in the JAX
    package).  Every rank calls it.  ``Kss``, ``Bs`` and ``rs`` are
    DTensors split along the scenario axis (axis 1; ``Shard(1)``) or this
    rank's own scenarios (the same number on every rank); K00 and r0 are
    replicated.  Per rank the scenario factors and their Schur
    contributions; one all-reduce (SUM) of the contributions to S0 and its
    right-hand side; the n0 x n0 solve on every rank (the same x0
    everywhere); local back-substitution.  Returns (x0 (B, n0), a plain
    tensor, and xs, a DTensor (B, S, ns) split along the scenarios)."""
    from ..parallel.dtensor import (dtensor_from_local, group_of, is_dtensor,
                                    to_local)

    n_global = system.Kss.shape[1] if is_dtensor(system.Kss) else None
    K00, Kss, Bs, r0, rs = (to_local(a) for a in (*system, r0, rs))
    SB, Sr, KinvB, Kinvr = local_contribution(Kss, Bs, rs)
    part = torch.cat([SB.sum(dim=1), Sr.sum(dim=1)[..., None]], dim=-1)
    torch.distributed.all_reduce(part, group=group_of(mesh))
    x0 = cholesky_solve(K00 - part[..., :-1], r0 - part[..., -1])
    xs = Kinvr - (KinvB @ x0[:, None, :, None])[..., 0]
    return x0, dtensor_from_local(xs, mesh, dim=1, n_global=n_global)


def arrow_to_dense(system: ArrowSystem):
    """The dense K of each arrow system, (B, n0 + S*ns, n0 + S*ns)."""
    Bn, S, ns, n0 = system.Bs.shape
    n = n0 + S * ns
    K = torch.zeros((Bn, n, n), dtype=system.K00.dtype,
                    device=system.K00.device)
    K[:, :n0, :n0] = system.K00
    for s in range(S):
        lo = n0 + s * ns
        K[:, lo:lo + ns, lo:lo + ns] = system.Kss[:, s]
        K[:, lo:lo + ns, :n0] = system.Bs[:, s]
        K[:, :n0, lo:lo + ns] = system.Bs[:, s].mT
    return K
