"""The OSQP benchmark suite's Portfolio class as a fleet of independent
problems, and its plain reference check.

Stellato et al., "OSQP: an operator splitting solver for quadratic
programs", Math. Prog. Comp. 12:637-672 (2020), appendix (Portfolio
optimization); osqp_benchmarks, ``problem_classes/portfolio.py``:

    minimize    x'Dx + y'y - (1/gamma) mu'x
    subject to  y = F'x,   1'x = 1,   0 <= x <= 1

over (x, y): x the weights of n = 100 k assets, y the exposures to k
factors; F (n, k) with a share ``density`` of its entries nonzero and
normal, D diagonal with entries uniform on [0, sqrt(k)], mu normal.
As the solver's QP: variables z = (x, y), Q = blkdiag(2D, 2I),
q = (-mu/gamma, 0); rows A z = (1'x, F'x - y, x) with l = (1, 0, 0) and
u = (1, 0, 1).

A run solves fleets of the traffic's ``batch`` problems, each fleet drawn
afresh on the device from the run's seed and the fleet's index.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


def generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of fleet ``index`` of a run seeded ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B97F4A7C15 + 7919 * index + 1) % 2 ** 63)
    return g


def draw(cfg, batch: int, seed: int, index: int, device):
    """(F, D, mu) of ``batch`` problems drawn from (``seed``, ``index``):
    (batch, n, k), (batch, n), (batch, n), float64, in a few large draws
    on ``device``."""
    g = generator(seed, index, device)
    n, k = cfg["assets"], cfg["factors"]
    F = torch.randn((batch, n, k), generator=g, dtype=F64, device=device)
    keep = torch.rand((batch, n, k), generator=g, dtype=F64, device=device)
    F = torch.where(keep < cfg["density"], F, torch.zeros_like(F))
    D = torch.rand((batch, n), generator=g, dtype=F64, device=device) * math.sqrt(k)
    mu = torch.randn((batch, n), generator=g, dtype=F64, device=device)
    return F, D, mu


def bounds(batch: int, n: int, k: int, device):
    """(l, u) of the rows (1'x, F'x - y, x)."""
    one = torch.ones((batch, 1), dtype=F64, device=device)
    zk = torch.zeros((batch, k), dtype=F64, device=device)
    zn = torch.zeros((batch, n), dtype=F64, device=device)
    return (torch.cat([one, zk, zn], 1),
            torch.cat([one, zk, torch.ones_like(zn)], 1))


def factors(cfg, traffic, seed: int, index: int, device):
    """(F, D, mu) of fleet ``index`` in a run seeded ``seed``."""
    return draw(cfg, traffic["batch"], seed, index, device)


def make(cfg, traffic, seed: int, index: int, device):
    """Fleet ``index`` as dense float64 tensors (Q, q, A, l, u, c), the
    fields of the port's ``Problem``."""
    F, D, mu = factors(cfg, traffic, seed, index, device)
    batch = F.shape[0]
    n, k = cfg["assets"], cfg["factors"]
    N, M = n + k, 1 + k + n
    Q = torch.zeros((batch, N, N), dtype=F64, device=device)
    Q.diagonal(dim1=1, dim2=2).copy_(torch.cat([2 * D, torch.full_like(D[:, :k], 2.0)], 1))
    q = torch.cat([-mu / cfg["gamma"], torch.zeros_like(mu[:, :k])], 1)
    A = torch.zeros((batch, M, N), dtype=F64, device=device)
    A[:, 0, :n] = 1.0
    A[:, 1:1 + k, :n] = F.mT
    A[:, 1:1 + k, n:] = -torch.eye(k, dtype=F64, device=device)
    A[:, 1 + k:, :n] = torch.eye(n, dtype=F64, device=device)
    l, u = bounds(batch, n, k, device)
    c = torch.zeros((batch,), dtype=F64, device=device)
    return Q, q, A, l, u, c


def residuals(cfg, F, D, mu, z, lam):
    """Per problem, the KKT residuals of (z, lam) in float64 from the
    factors, without the dense matrices: rp = |Az - clip(Az + lam, l, u)|
    and rd = |Qz + q + A'lam|, maximum norms (NaN stays NaN)."""
    B, n, k = F.shape
    z, lam = z.to(F64), lam.to(F64)
    x, y = z[:, :n], z[:, n:]
    l0, lf, lx = lam[:, :1], lam[:, 1:1 + k], lam[:, 1 + k:]
    grad = torch.cat([2 * D * x - mu / cfg["gamma"] + l0
                      + (F @ lf[..., None])[..., 0] + lx,
                      2 * y - lf], 1)
    Az = torch.cat([x.sum(1, keepdim=True),
                    (F.mT @ x[..., None])[..., 0] - y, x], 1)
    l, u = bounds(B, n, k, F.device)
    rp = (Az - torch.clamp(Az + lam, l, u)).abs().amax(1)
    return rp, grad.abs().amax(1)


def judge(cfg, traffic, seed: int, device, units, state=None):
    """Each unit's (``key`` = its fleet index) answers against the
    reference, the fleet drawn again: per problem (status, rp, rd),
    concatenated over the units."""
    out = []
    for unit in units:
        F, D, mu = factors(cfg, traffic, seed, unit.key, device)
        rp, rd = residuals(cfg, F, D, mu, unit.x, unit.y)
        out.append((unit.status, rp, rd))
    return [torch.cat(parts) for parts in zip(*out)]
