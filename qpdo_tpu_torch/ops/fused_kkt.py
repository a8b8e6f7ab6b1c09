"""Fused Newton KKT solve, and the Cholesky solve of a formed matrix,
batched and in float32.

Replaces the TPU kernels of ``qpdo_tpu/ops/pallas_kkt.py``:
``_kkt_kernel`` (l.40; entries ``pallas_kkt_solve`` l.116 and
``fused_kkt_solve`` l.180) and ``_stacked_chol_kernel`` (l.209, entry
``pallas_chol_solve_stacked`` l.299).  On a CUDA tensor each wrapper
launches its hand-written kernel (the headers of the sources say what
bounds the kernels on the H100 and how the design answers), on the route
that ``kernel_route`` picks from n alone: K factored in the registers of
one block up to n = 128 and in its shared memory up to 220 (239 for the
Cholesky solve), both in ``qpdo_tpu_torch/csrc/kkt_solve.cu``, and in
global memory above, formed by kernel 1 first
(``qpdo_tpu_torch/csrc/kkt_solve_large.cu``); so any n is solved, as the
TPU kernels' padded entries solve it.  On a CPU tensor a wrapper runs the
plain version below, which has the same semantics step for step:

    K    = Q + sigma*I + A' diag(w) A
    dinv = 1/sqrt(diag K) where diag K > 0, else 1
    Khat = dinv K dinv + 100*eps32*I
    R    = chol(Khat), upper, row by row, pivot max(d, 1e-30)
    R'z  = dinv * rhs;  R x = z;  dx = dinv * x

A NaN pivot stays NaN (``torch.clamp`` keeps it, as ``jnp.maximum`` does),
so a problem whose matrix cannot be factored comes back non-finite and the
caller's per-problem guard zeroes it alone.  ``fused_kkt_solve`` clamps
only the pivots, so a non-positive pivot leaves a non-positive diagonal
that the substitutions divide by; ``chol_solve_stacked`` also clamps the
substitutions' divisors (both as in the TPU kernels).  The TPU kernels'
padding to 128 lanes and the stacking of 8 problems per program have no
counterpart here.  Neither package calls ``chol_solve_stacked`` from a
solver; it is the second half of ``fused_kkt_solve`` on its own.
"""

from __future__ import annotations

import collections

import torch

from .. import kernels
from . import fused_formation

_TINY = 1e-30
_F32 = torch.float32


def _static_reg32() -> float:
    """100 * eps of float32: the shift of the Jacobi-scaled matrix."""
    return 100.0 * float(torch.finfo(_F32).eps)


def _chol_solve_plain(K, b, clamp_div: bool):
    """Right-looking Cholesky of K (B, n, n) to its upper factor, row by
    row, then R'z = b and R x = z: the recurrences of the kernels as
    batched tensor code (n rank-1 updates)."""
    K = K.clone()
    n = K.shape[-1]
    idx = torch.arange(n, device=K.device)
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    for j in range(n):
        rowj = K[:, j, :]
        r = torch.rsqrt(torch.clamp(rowj[:, j], min=_TINY))       # NaN kept
        Rrow = torch.where(idx >= j, rowj * r[:, None], zero)
        tail = torch.where(idx > j, Rrow, zero)
        K = K - torch.where(idx[:, None] > j,
                            tail[:, :, None] * tail[:, None, :], zero)
        K[:, j, :] = Rrow

    def diag_of(j):
        d = K[:, j, j]
        return torch.clamp(d, min=_TINY) if clamp_div else d

    z = b.clone()
    for j in range(n):                                   # R'z = b, by rows
        zj = z[:, j] / diag_of(j)
        z = torch.where(idx == j, zj[:, None],
                        z - zj[:, None] * torch.where(idx > j, K[:, j, :], zero))
    x = z.clone()
    for j in range(n - 1, -1, -1):                       # R x = z
        dotv = torch.sum(torch.where(idx > j, K[:, j, :] * x, zero), dim=-1)
        x[:, j] = (z[:, j] - dotv) / diag_of(j)
    return x


def reference_kkt_solve(Q, A, w, sigma, rhs):
    """Plain version of ``fused_kkt_solve`` (any device, computed in
    float32)."""
    Q, A, w, sigma, rhs = (t.to(_F32) for t in (Q, A, w, sigma, rhs))
    n = Q.shape[-1]
    eye = torch.eye(n, dtype=_F32, device=Q.device)
    K = torch.matmul(A.mT, w[..., None] * A) + (Q + sigma[:, None, None] * eye)
    diag = torch.diagonal(K, dim1=-2, dim2=-1)
    pos = diag > 0
    dinv = torch.where(pos, torch.rsqrt(torch.where(pos, diag,
                                                    torch.ones_like(diag))),
                       torch.ones_like(diag))
    Khat = K * dinv[:, :, None] * dinv[:, None, :] + _static_reg32() * eye
    x = _chol_solve_plain(Khat, rhs * dinv, clamp_div=False)
    return x * dinv


def reference_chol_solve(K, rhs):
    """Plain version of ``chol_solve_stacked`` (any device, computed in
    float32)."""
    return _chol_solve_plain(K.to(_F32), rhs.to(_F32), clamp_div=True)


def _check(name, tensors, shapes):
    first = next(iter(tensors.values()))
    for key, t in tensors.items():
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} must be {shapes[key]}, "
                             f"got {tuple(t.shape)}")
        if t.device != first.device:
            raise ValueError(f"{name}: {key} is on {t.device}, not on "
                             f"{first.device}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def kernel_route(name: str, n: int) -> str:
    """The route of kernel ``name`` ("kkt_solve" or "chol_solve") for n:
    "register", "shared" or "global"."""
    if n <= kernels.REGISTER_MAX_N:
        return "register"
    if n <= kernels.SHARED_MAX_N[name]:
        return "shared"
    return "global"


def _launch(name, wrapper, tensors, sizes):
    """Launch kernel ``name`` on float32 contiguous copies of ``tensors``,
    on its route for n, and return its (B, n) output; never the plain
    version.  The global route's workspace (K, then dinv and the
    right-hand side of every problem) and, for the fused solve, kernel 1's
    partial sums are allocated here."""
    args = [t.to(_F32).contiguous() for t in tensors]
    B, n = sizes[0], sizes[-1]
    device = args[0].device
    out = torch.empty((B, n), dtype=_F32, device=device)
    route = kernel_route(name, n)
    if route != "global":
        kernels.launch(name, _F32, (*args, out), sizes)
    else:
        work = torch.empty(B * n * (n + 2), dtype=_F32, device=device)
        if name == "kkt_solve":
            m = sizes[1]
            splits = fused_formation.formation_splits(
                B, m, n, fused_formation.sm_count(device.index))
            partial = (torch.empty((B, splits, n, n), dtype=_F32, device=device)
                       if splits > 1 else None)
            kernels.launch("kkt_solve_global", _F32,
                           (*args, out, work, partial), (B, m, n, splits))
        else:
            kernels.launch("chol_solve_global", _F32, (*args, out, work),
                           (B, n))
    wrapper.launches[_F32] += 1
    wrapper.routes[route] += 1
    return out


def fused_kkt_solve(Q, A, w, sigma, rhs):
    """dx with (Q + sigma*I + A' diag(w) A) dx = rhs per problem, through
    the Jacobi-prescaled, shifted Cholesky above.  Q (B, n, n), A
    (B, m, n), w (B, m), sigma (B,), rhs (B, n) on one device; inputs are
    cast to float32 and dx (B, n) is float32.  CUDA tensors launch the
    kernel (and count the launch, by dtype, in the Counter
    ``fused_kkt_solve.launches``, and by route in
    ``fused_kkt_solve.routes``); CPU tensors take the plain version."""
    if A.dim() != 3:
        raise ValueError(f"fused_kkt_solve: A must be (B, m, n), got "
                         f"{tuple(A.shape)}")
    B, m, n = A.shape
    _check("fused_kkt_solve", dict(Q=Q, A=A, w=w, sigma=sigma, rhs=rhs),
           dict(Q=(B, n, n), A=(B, m, n), w=(B, m), sigma=(B,), rhs=(B, n)))
    if Q.device.type == "cpu":
        return reference_kkt_solve(Q, A, w, sigma, rhs)
    return _launch("kkt_solve", fused_kkt_solve, (Q, A, w, sigma, rhs),
                   (B, m, n))


fused_kkt_solve.launches = collections.Counter()
fused_kkt_solve.routes = collections.Counter()


def chol_solve_stacked(K, rhs):
    """dx with K dx = rhs for symmetric positive definite K (B, n, n) (for
    instance a Jacobi-prescaled KKT matrix; only the upper triangle is
    read) and rhs (B, n), by the kernel's Cholesky and substitutions with
    pivots and divisors clamped at 1e-30.  Cast to float32, dx float32.
    CUDA tensors launch the kernel (counted, by dtype, in the Counter
    ``chol_solve_stacked.launches``, and by route in
    ``chol_solve_stacked.routes``); CPU tensors take the plain version."""
    if K.dim() != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"chol_solve_stacked: K must be (B, n, n), got "
                         f"{tuple(K.shape)}")
    B, n, _ = K.shape
    _check("chol_solve_stacked", dict(K=K, rhs=rhs),
           dict(K=(B, n, n), rhs=(B, n)))
    if K.device.type == "cpu":
        return reference_chol_solve(K, rhs)
    return _launch("chol_solve", chol_solve_stacked, (K, rhs), (B, n))


chol_solve_stacked.launches = collections.Counter()
chol_solve_stacked.routes = collections.Counter()
