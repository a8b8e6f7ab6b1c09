"""Exact (piecewise-linear) linesearch, batched.

Port of ``qpdo_tpu/ops/linesearch.py``: per problem the merit derivative

    0.5 * psi'(tau) = eta*tau + beta + delta' [delta*tau - alpha]_+

over 2m hinge terms, and its root by a safeguarded bisection
(``pwa_root_bisect``, sort-free) or by the sorted breakpoint scan
(``pwa_root``, the library default).  eta and beta are (B,), delta and
alpha (B, 2m); every sum runs over one problem's hinges.
"""

from __future__ import annotations

import torch

from .batched import dot
from .linalg import resolve_dtype


def exact_linesearch(dx, dy, Qdx, Adx, df, y, w, mu, l, u,
                     method: str = "sort", root_dtype=None):
    """The exact stepsize tau (B,) along (dx, dy).  ``Qdx`` already holds
    the sigma*dx term when proximal; the root is found in ``root_dtype``
    (None = the state dtype) and returned in the state dtype."""
    mu_dy_half = 0.5 * mu * dy
    eta = 0.5 * (dot(dx, Qdx) + dot(dy, mu_dy_half))
    beta = 0.5 * (dot(dx, df) + dot(y, mu_dy_half))
    rs = torch.rsqrt(mu)
    d_half = (Adx - mu_dy_half) * rs            # c0 ./ sqrt(mu)
    wl = (w - l) * rs
    uw = (u - w) * rs
    delta = torch.cat([-d_half, d_half], dim=-1)
    alpha = torch.cat([wl, uw], dim=-1)
    state_dt = delta.dtype
    rd = resolve_dtype(root_dtype, state_dt)
    if rd != state_dt:
        eta, beta = eta.to(rd), beta.to(rd)
        delta, alpha = delta.to(rd), alpha.to(rd)
    if method == "bisect":
        tau = pwa_root_bisect(eta, beta, delta, alpha)
    elif method == "sort":
        tau = pwa_root(eta, beta, delta, alpha)
    else:
        raise NotImplementedError(f"Settings.linesearch={method!r}: only "
                                  "'bisect' and 'sort' are ported")
    return tau.to(state_dt)


def pwa_root(eta, beta, delta, alpha):
    """Root of eta*tau + beta + delta'[delta*tau - alpha]_+ per problem by
    sorting the breakpoints and scanning the segments with prefix sums."""
    nz = delta != 0
    one = torch.ones_like(delta)
    zero = torch.zeros_like(delta)
    taus = torch.where(nz, alpha / torch.where(nz, delta, one), -one)
    L = taus > 0                      # breakpoints ahead of tau=0
    P = delta > 0                     # sign of the hinge slope
    J = torch.logical_xor(P, L)       # hinges already active at tau=0+

    dd = delta * delta
    da_mask = torch.where(nz, dd, zero)
    db_mask = torch.where(nz, delta * alpha, zero)

    a0 = eta + torch.sum(torch.where(J, da_mask, zero), dim=-1)
    b0 = beta - torch.sum(torch.where(J, db_mask, zero), dim=-1)

    sgn = torch.where(P, one, -one)
    da = torch.where(L, sgn * da_mask, zero)
    db = torch.where(L, -sgn * db_mask, zero)

    key = torch.where(L, taus, torch.full_like(taus, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    t_s = torch.gather(key, -1, order)
    da_s = torch.gather(da, -1, order)
    db_s = torch.gather(db, -1, order)

    # exclusive prefix sums via shift (not cumsum(x) - x: cancellation)
    zero1 = torch.zeros_like(da_s[..., :1])
    a_before = a0[:, None] + torch.cumsum(
        torch.cat([zero1, da_s[..., :-1]], dim=-1), dim=-1)
    b_before = b0[:, None] + torch.cumsum(
        torch.cat([zero1, db_s[..., :-1]], dim=-1), dim=-1)
    slope = b_before + a_before * t_s

    hit = torch.isfinite(t_s) & (slope > 0)
    any_hit = hit.any(dim=-1)
    k = torch.argmax(hit.to(torch.int32), dim=-1, keepdim=True)  # first hit

    a_fin = a0 + torch.sum(da_s, dim=-1)
    b_fin = b0 + torch.sum(db_s, dim=-1)
    a_star = torch.where(any_hit, torch.gather(a_before, -1, k)[:, 0], a_fin)
    b_star = torch.where(any_hit, torch.gather(b_before, -1, k)[:, 0], b_fin)
    ok = a_star != 0
    return torch.where(ok, -b_star / torch.where(ok, a_star,
                                                 torch.ones_like(a_star)),
                       torch.ones_like(a_star))


def pwa_root_bisect(eta, beta, delta, alpha, iters: int = 48):
    """Sort-free root per problem: a safeguarded segment iteration that
    falls back to bisection when the segment root leaves the bracket."""
    one = torch.ones_like(eta)

    def coeffs(t):
        act = delta * t[:, None] - alpha > 0
        a = eta + torch.sum(torch.where(act, delta * delta, 0.0), dim=-1)
        b = beta - torch.sum(torch.where(act, delta * alpha, 0.0), dim=-1)
        return a, b

    def phi(t):
        return eta * t + beta + torch.sum(
            delta * torch.clamp(delta * t[:, None] - alpha, min=0.0), dim=-1)

    # grow an upper bracket: phi is increasing with slope >= eta > 0
    hi = one
    for _ in range(40):
        hi = torch.where(phi(hi) < 0, hi * 4.0, hi)
    lo = torch.zeros_like(eta)
    t = 0.5 * hi
    for _ in range(iters):
        a, b = coeffs(t)
        cand = -b / torch.where(a != 0, a, one)
        t = torch.where((cand > lo) & (cand < hi), cand, 0.5 * (lo + hi))
        ph = phi(t)
        lo = torch.where(ph < 0, t, lo)
        hi = torch.where(ph >= 0, t, hi)
    a, b = coeffs(t)
    cand = -b / torch.where(a != 0, a, one)
    return torch.where(torch.isfinite(cand), cand, t)
