"""Exact (piecewise-linear) linesearch, batched.

Port of ``qpdo_tpu/ops/linesearch.py``: per problem the merit derivative

    0.5 * psi'(tau) = eta*tau + beta + delta' [delta*tau - alpha]_+

over 2m hinge terms, and its root by a safeguarded bisection
(``pwa_root_bisect``, sort-free), by its chunked variant
(``pwa_root_bisect_chunk``: vectors of candidates per sequential step) or
by the sorted breakpoint scan (``pwa_root``, the library default).  eta and beta are (B,), delta and
alpha (B, 2m); every sum runs over one problem's hinges.

With a comm (``parallel/comm.py``: the rows of the problem split over
ranks) each rank holds the hinges of its own rows: the sums over them are
reduced over the ranks.  The bisection then runs as
``pwa_root_bisect_split`` (one collective per iteration); the sorted scan
and the chunked bisection run on the hinges gathered from every rank.
"""

from __future__ import annotations

import torch

from .batched import dot
from .linalg import resolve_dtype


def exact_linesearch(dx, dy, Qdx, Adx, df, y, w, mu, l, u,
                     method: str = "sort", root_dtype=None, comm=None):
    """The exact stepsize tau (B,) along (dx, dy).  ``Qdx`` already holds
    the sigma*dx term when proximal; the root is found in ``root_dtype``
    (None = the state dtype) and returned in the state dtype.  ``comm``:
    the dual vectors hold the local rows of a problem split over ranks."""
    mu_dy_half = 0.5 * mu * dy
    if comm is None:
        eta = 0.5 * (dot(dx, Qdx) + dot(dy, mu_dy_half))
        beta = 0.5 * (dot(dx, df) + dot(y, mu_dy_half))
    else:
        # eta and beta hold dots over the rows: one collective for both
        dyy, yy = comm.dual_sum(dot(dy, mu_dy_half), dot(y, mu_dy_half))
        eta = 0.5 * (comm.primal_dot(dx, Qdx) + dyy)
        beta = 0.5 * (comm.primal_dot(dx, df) + yy)
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
    if comm is not None and method == "bisect":
        tau = pwa_root_bisect_split(eta, beta, delta, alpha, comm)
    elif comm is not None:
        # the sort and the chunked scan see every hinge: gather them
        delta, alpha = comm.gather_rows(delta), comm.gather_rows(alpha)
        tau = (pwa_root_bisect_chunk if method == "bisect_chunk"
               else pwa_root)(eta, beta, delta, alpha)
    elif method == "bisect":
        tau = pwa_root_bisect(eta, beta, delta, alpha)
    elif method == "bisect_chunk":
        tau = pwa_root_bisect_chunk(eta, beta, delta, alpha)
    else:
        tau = pwa_root(eta, beta, delta, alpha)
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


def pwa_root_bisect_split(eta, beta, delta, alpha, comm, iters: int = 48):
    """``pwa_root_bisect`` with the hinges split over the ranks of
    ``comm``: every sum over hinges is a local sum and an all-reduce.  The
    same iteration, arranged for few collectives: the 40 doublings of the
    upper bracket take phi at the 40 points 4^k in one reduction (phi is
    increasing, so the bracket is the first point where phi >= 0, as the
    sequential growth finds it), and phi(t) and the segment coefficients
    at t share one reduction, since the next iteration's coefficients are
    taken at the same t.  51 collectives per linesearch instead of 137."""
    one = torch.ones_like(eta)
    dd, da = delta * delta, delta * alpha

    def sums(t):
        """(phi(t), a(t), b(t)) with the hinge sums reduced."""
        z = delta * t[:, None] - alpha
        act = z > 0
        h, a, b = comm.dual_sum(
            torch.sum(delta * torch.clamp(z, min=0.0), dim=-1),
            torch.sum(torch.where(act, dd, 0.0), dim=-1),
            torch.sum(torch.where(act, da, 0.0), dim=-1))
        return eta * t + beta + h, eta + a, beta - b

    powers = torch.pow(torch.tensor(4.0, dtype=eta.dtype, device=eta.device),
                       torch.arange(40, dtype=eta.dtype, device=eta.device))
    hinge = torch.clamp(delta[:, None, :] * powers[:, None] - alpha[:, None, :],
                        min=0.0)
    h, = comm.dual_sum(torch.matmul(hinge, delta[:, :, None])[..., 0])
    below = eta[:, None] * powers + beta[:, None] + h < 0       # (B, 40)
    # hi = 4^(first k with phi(4^k) >= 0), 4^40 when there is none
    hi = torch.pow(torch.full_like(eta, 4.0),
                   torch.cumprod(below.to(torch.int32), dim=-1).sum(dim=-1)
                   .to(eta.dtype))
    lo = torch.zeros_like(eta)
    t = 0.5 * hi
    _, a, b = sums(t)
    for _ in range(iters):
        cand = -b / torch.where(a != 0, a, one)
        t = torch.where((cand > lo) & (cand < hi), cand, 0.5 * (lo + hi))
        ph, a, b = sums(t)
        lo = torch.where(ph < 0, t, lo)
        hi = torch.where(ph >= 0, t, hi)
    cand = -b / torch.where(a != 0, a, one)
    return torch.where(torch.isfinite(cand), cand, t)


def _first(mask):
    """Per problem: (any entry of the (B, T) mask holds, index of the first
    that does, 0 where none does)."""
    return mask.any(dim=-1), torch.argmax(mask.to(torch.int32), dim=-1)


def _at(v, k):
    """v[b, k[b]] for (B, T) v and (B,) indices."""
    return torch.gather(v, -1, k[:, None])[:, 0]


def pwa_root_bisect_chunk(eta, beta, delta, alpha, K: int = 32,
                          passes: int = 4):
    """Chunked ``pwa_root_bisect`` per problem (``linesearch.py:182-273``
    of the JAX package): each sequential step evaluates phi at a vector of
    candidates.  Two geometric tiers (4^0..4^20, then to 4^40) bracket the
    root, ``passes`` passes of K equispaced points shrink the bracket
    K-fold each, and three safeguarded segment-Newton steps make it exact
    once the bracket lies in one affine segment; otherwise the result is
    clamped to the bracket."""
    dt = delta.dtype
    one = torch.ones_like(eta)
    zero = torch.zeros_like(eta)

    def phis(ts):                               # (B, T) -> (B, T)
        hinge = torch.clamp(delta[:, None, :] * ts[:, :, None]
                            - alpha[:, None, :], min=0.0)
        return (eta[:, None] * ts + beta[:, None]
                + torch.matmul(hinge, delta[:, :, None])[..., 0])

    def coeffs(t):
        act = delta * t[:, None] - alpha > 0
        a = eta + torch.sum(torch.where(act, delta * delta, 0.0), dim=-1)
        b = beta - torch.sum(torch.where(act, delta * alpha, 0.0), dim=-1)
        return a, b

    powers = torch.pow(torch.tensor(4.0, dtype=dt, device=delta.device),
                       torch.arange(21, dtype=dt, device=delta.device))

    def tier(base):
        scales = (base * powers).expand(eta.shape[0], -1)
        hit, k = _first(phis(scales) >= 0)
        last = scales[:, -1]
        hi = torch.where(hit, _at(scales, k), last)
        lo = torch.where(hit & (k > 0),
                         _at(scales, torch.clamp(k - 1, min=0)),
                         torch.where(hit, zero, last))
        return hit, lo, hi

    hit1, lo1, hi1 = tier(1.0)
    _, lo2, hi2 = tier(float(4.0 ** 20))
    lo = torch.where(hit1, lo1, lo2)
    hi = torch.where(hit1, hi1, hi2)

    ks = torch.arange(1, K + 1, dtype=dt, device=delta.device) / K
    for _ in range(passes):
        ts = lo[:, None] + (hi - lo)[:, None] * ks
        any_nn, j = _first(phis(ts) >= 0)
        new_hi = torch.where(any_nn, _at(ts, j), hi)
        lo = torch.where(any_nn & (j > 0), _at(ts, torch.clamp(j - 1, min=0)),
                         lo)
        hi = new_hi

    t = 0.5 * (lo + hi)
    for _ in range(3):
        a, b = coeffs(t)
        cand = -b / torch.where(a != 0, a, one)
        t = torch.where((cand > lo) & (cand < hi), cand, 0.5 * (lo + hi))
        ph = phis(t[:, None])[:, 0]
        lo = torch.where(ph < 0, t, lo)
        hi = torch.where(ph >= 0, t, hi)
    a, b = coeffs(t)
    cand = -b / torch.where(a != 0, a, one)
    cand_ok = torch.isfinite(cand) & (cand >= lo) & (cand <= hi)
    return torch.where(cand_ok, cand, torch.minimum(torch.maximum(t, lo), hi))
