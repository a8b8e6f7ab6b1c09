"""Fused Newton KKT solve, and the Cholesky solve of a formed matrix,
batched and in float32.

Replaces the TPU kernels of ``qpdo_tpu/ops/pallas_kkt.py``:
``_kkt_kernel`` (l.40; entries ``pallas_kkt_solve`` l.116 and
``fused_kkt_solve`` l.180) and ``_stacked_chol_kernel`` (l.209, entry
``pallas_chol_solve_stacked`` l.299).  On a CUDA tensor each wrapper
launches its hand-written kernel (the headers of the sources say what
bounds the kernels on the H100 and how the design answers), on the route
that ``kernel_route`` picks from B and n: K factored in the registers of
one block up to n = 128 and in its shared memory up to 220 (239 for the
Cholesky solve), both in ``qpdo_tpu_torch/csrc/kkt_solve.cu``; above,
for a few problems, in the shared memory of a thread-block cluster a
problem (``qpdo_tpu_torch/csrc/kkt_solve_cluster.cu``), else in global
memory (``qpdo_tpu_torch/csrc/kkt_solve_large.cu``), K formed by kernel 1
first on both; so any n is solved, as the TPU kernels' padded entries
solve it.  ``fused_kkt_solver`` serves many right-hand sides of one K (a
Newton solve and its refinement): on the global route it keeps the first
launch's factor and substitutes on it for the others
(``kkt_resolve_global``), with the bits of a launch each.  On a CPU
tensor a wrapper runs the
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
import functools

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


def kernel_route(name: str, B: int, n: int, device=None) -> str:
    """The route of kernel ``name`` ("kkt_solve" or "chol_solve") for B
    problems of n: "register", "shared", "cluster" or "global".  Above the
    shared-memory route, "cluster" where B is at most the number of
    clusters whose shared memory holds one problem's panels that the card
    (``device``, an index; the current one by default) holds at once
    (``kernels.max_active_clusters``, 0 where n has no cluster); else
    "global".  The choice is made here, before the launch: a refused
    cluster launch raises, it never takes another route.

    The card's count is also where the cluster route stops winning: on an
    NVIDIA H100 80GB HBM3 at 700 W (15 clusters of 8 blocks at once,
    7 of 16; ``scripts/time_kkt_global.py``, ``device_ms`` of
    fused_kkt_solve / chol_solve_stacked, the cluster route's trailing
    update on the TF32 tensor cores) the cluster route took 0.42645 /
    0.20689 ms at B=15, n=512 against the global route's 0.57543 /
    0.35766, but 0.63024 / 0.40090 at B=16, one cluster more than the
    card holds at once, against 0.57003 / 0.36598; at n=1024, 0.95011 /
    0.51004 at B=7 against 1.25377 / 0.80407, but 1.62978 / 1.00879 at
    B=8 against 1.45643 / 0.86065."""
    if n <= kernels.REGISTER_MAX_N:
        return "register"
    if n <= kernels.SHARED_MAX_N[name]:
        return "shared"
    if B <= kernels.max_active_clusters(n, device):
        return "cluster"
    return "global"


def global_work_floats(B: int, n: int) -> int:
    """The floats of the global route's workspace: K (B, n, n), then
    dinv, the right-hand side, the diagonal of R and z of every
    problem."""
    return B * n * (n + 4)


def cluster_work_floats(name: str, B: int, n: int) -> int:
    """The floats of the cluster route's workspace (the source's
    ``qpdo_cluster_work_floats``): for the fused solve K (B, n, n) as
    kernel 1 forms it, then for both kernels each problem's buffer of
    factored panels."""
    return int(kernels.library().qpdo_cluster_work_floats(
        B, n, int(name == "kkt_solve")))


def _launch(name, wrapper, tensors, sizes, route=None, work=None):
    """Launch kernel ``name`` on float32 contiguous copies of ``tensors``,
    on its route for (B, n) (or on ``route``, as a timing compares two
    routes), and return its (B, n) output; never the plain version.  The
    global and cluster routes' workspaces (``global_work_floats``,
    ``cluster_work_floats``) and, for the fused solve, kernel 1's partial
    sums are allocated here, unless ``work`` is given: the global route's
    workspace of a caller that keeps the factor there."""
    args = [t.to(_F32).contiguous() for t in tensors]
    B, n = sizes[0], sizes[-1]
    device = args[0].device
    out = torch.empty((B, n), dtype=_F32, device=device)
    if route is None:
        route = kernel_route(name, B, n, device.index)
    if route in ("register", "shared"):
        kernels.launch(name, _F32, (*args, out), sizes)
    else:
        if work is None:
            floats = (global_work_floats(B, n) if route == "global"
                      else cluster_work_floats(name, B, n))
            work = torch.empty(floats, dtype=_F32, device=device)
        # the cluster size follows from n in the source (0)
        extra = () if route == "global" else (0,)
        if name == "kkt_solve":
            m = sizes[1]
            splits = fused_formation.formation_splits(
                B, m, n, fused_formation.sm_count(device.index))
            partial = (torch.empty((B, splits, n, n), dtype=_F32, device=device)
                       if splits > 1 else None)
            kernels.launch(f"kkt_solve_{route}", _F32,
                           (*args, out, work, partial),
                           (B, m, n, splits, *extra))
        else:
            kernels.launch(f"chol_solve_{route}", _F32, (*args, out, work),
                           (B, n, *extra))
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


def fused_kkt_solver(Q, A, w, sigma):
    """rhs -> ``fused_kkt_solve(Q, A, w, sigma, rhs)``, the same bits, for
    the right-hand sides of one Newton solve, which share K (Q, A, w,
    sigma as there, unchanged while the function is in use).  Where a CUDA tensor's (B, n) takes the global route, the first
    call forms and factors K in a workspace that it keeps, and each later
    call only substitutes on that factor: one launch of
    ``kkt_resolve_global`` (counted, by dtype, in the Counter
    ``fused_kkt_solver.launches``).  On the other routes, which keep no
    float32 factor in global memory (the register and shared routes keep
    none there, the cluster route's is in TF32 bits), and on the CPU,
    every call is ``fused_kkt_solve``."""
    if A.dim() != 3:
        raise ValueError(f"fused_kkt_solver: A must be (B, m, n), got "
                         f"{tuple(A.shape)}")
    B, m, n = A.shape
    _check("fused_kkt_solver", dict(Q=Q, A=A, w=w, sigma=sigma),
           dict(Q=(B, n, n), A=(B, m, n), w=(B, m), sigma=(B,)))
    if (Q.device.type == "cpu"
            or kernel_route("kkt_solve", B, n, Q.device.index) != "global"):
        return functools.partial(fused_kkt_solve, Q, A, w, sigma)
    args = [t.to(_F32).contiguous() for t in (Q, A, w, sigma)]
    work = torch.empty(global_work_floats(B, n), dtype=_F32, device=Q.device)
    factored = False

    def solve(rhs):
        nonlocal factored
        _check("fused_kkt_solver", dict(Q=Q, rhs=rhs),
               dict(Q=(B, n, n), rhs=(B, n)))
        if not factored:
            dx = _launch("kkt_solve", fused_kkt_solve, (*args, rhs),
                         (B, m, n), "global", work)
            factored = True
            return dx
        dx = torch.empty((B, n), dtype=_F32, device=Q.device)
        kernels.launch("kkt_resolve_global", _F32,
                       (rhs.to(_F32).contiguous(), dx, work), (B, n))
        fused_kkt_solver.launches[_F32] += 1
        return dx

    return solve


fused_kkt_solver.launches = collections.Counter()


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
