"""Block-angular (scenario-structured) QPDO solver.

Port of ``qpdo_tpu/solver/structured.py``.  Problems

    minimize   0.5 x0'Q0 x0 + sum_s 0.5 xs'Qs xs + q0'x0 + sum_s qs'xs
    subject to l_s <= T_s x0 + W_s x_s <= u_s        s = 1..S

(two-stage stochastic programs, scenario MPC).  The semismooth Newton KKT
matrix is exactly arrow-structured, so every Newton solve is a Schur
complement over the scenarios (``operators.BlockAngularOperator``;
standalone algebra in ``ops/schur.py``).  The step logic is the generic
core (``solver/core.py``) on that operator, so the structured path has
Ruiz equilibration (``scale_block_angular``: the semantics of
src/scaling.c:24-91 on the block form) and the infeasibility
certificates (src/termination.c:97-216) of the dense one.

One problem per call, as in the JAX package (which batches with a
user-side ``vmap``); the operator and the core hold it as a batch of one,
and the results keep that leading axis: ``x`` is the pair (x0 (1, n0),
xs (1, S, ns)), ``y`` is (1, S, ms).  The problem's arrays may be numpy
arrays or tensors: they go to ``device`` (None: Q0's device when it is a
tensor, else "cuda") in Q0's floating dtype.

Scenario-sharded: a problem whose scenario-leading leaves (Qs, qs, T, W,
l, u) are DTensors split along the scenarios (``Shard(0)``) over a 1-D
``DeviceMesh`` is solved by every rank on its own scenarios, with Q0,
q0 and c replicated (the JAX package's placement of the S axis over a
mesh, structured.py:123).  Every rank calls the solve; the sums over the
scenarios are all-reduced (``operators.BlockAngularOperator``,
``parallel/comm.ScenarioComm``).  x0 comes back replicated; xs, y and
the scenario parts of the certificates are DTensors split along the
scenario axis (axis 1, after the batch axis of one).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import constants as _c
from ..operators import BlockAngularOperator
from ..types import Result, Settings
from .core import matmul_precision, solve_scaled
from .scaling import limit_scaling


class BlockAngularProblem(NamedTuple):
    Q0: torch.Tensor   # (n0, n0)
    Qs: torch.Tensor   # (S, ns, ns)
    q0: torch.Tensor   # (n0,)
    qs: torch.Tensor   # (S, ns)
    T: torch.Tensor    # (S, ms, n0)
    W: torch.Tensor    # (S, ms, ns)
    l: torch.Tensor    # (S, ms)
    u: torch.Tensor    # (S, ms)
    c: torch.Tensor    # scalar

    @property
    def shapes(self):
        S, ms, n0 = self.T.shape
        ns = self.W.shape[-1]
        return S, ms, n0, ns


def _batch_of_one(p: BlockAngularProblem, device) -> BlockAngularProblem:
    """The problem's arrays as tensors of one floating dtype on one
    device, each with a leading batch axis of 1."""
    if device is None:
        device = p.Q0.device if isinstance(p.Q0, torch.Tensor) else "cuda"
    Q0 = torch.as_tensor(p.Q0, device=device)
    if not Q0.is_floating_point():
        Q0 = Q0.to(torch.get_default_dtype())
    return BlockAngularProblem(*(
        torch.as_tensor(a, dtype=Q0.dtype, device=device)[None]
        for a in (Q0, *p[1:])))


def scale_block_angular(p: BlockAngularProblem, scaling_iters: int,
                        device=None, comm=None) -> BlockAngularOperator:
    """Ruiz equilibration + cost scaling on the block-angular form
    (structured.py:57-114 of the JAX package), as a batch of one.

    The semantics of the dense scale_problem (src/scaling.c:24-91):
    ``scaling_iters`` passes on A = [T W] only (column norms of the x0
    block reduce over all scenarios, those of the xs blocks are
    scenario-local, row norms combine both blocks), then Q <- c D Q D,
    q <- c D q with c = 1/max(1, ||D q||_inf), bounds <- E l/u.
    ``comm``: ``p`` holds this rank's scenarios; the maxima over the
    scenarios are reduced over the ranks."""
    gmax = (lambda t: t) if comm is None else (lambda t: comm.max((t,))[0])
    p = _batch_of_one(p, device)
    dt, dev = p.Q0.dtype, p.Q0.device
    Bn, S, ms, n0 = p.T.shape
    ns = p.W.shape[-1]
    inf = _c.QPDO_INFTY
    l = torch.clamp(p.l, -inf, inf)
    u = torch.clamp(p.u, -inf, inf)
    l_finite = (l > -inf).to(dt)
    u_finite = (u < inf).to(dt)

    T, W, Q0, Qs, q0, qs = p.T, p.W, p.Q0, p.Qs, p.q0, p.qs
    D0 = torch.ones((Bn, n0), dtype=dt, device=dev)
    Ds = torch.ones((Bn, S, ns), dtype=dt, device=dev)
    E = torch.ones((Bn, S, ms), dtype=dt, device=dev)
    cost = torch.ones((Bn,), dtype=dt, device=dev)
    if scaling_iters > 0:
        for _ in range(scaling_iters):
            aT, aW = torch.abs(T), torch.abs(W)
            c0 = gmax(torch.amax(aT, dim=(1, 2)))            # (B, n0)
            cs = torch.amax(aW, dim=2)                       # (B, S, ns)
            rn = torch.maximum(torch.amax(aT, dim=3),
                               torch.amax(aW, dim=3))        # (B, S, ms)
            d0 = torch.rsqrt(limit_scaling(c0))
            ds = torch.rsqrt(limit_scaling(cs))
            e = torch.rsqrt(limit_scaling(rn))
            T = e[..., None] * T * d0[:, None, None, :]
            W = e[..., None] * W * ds[:, :, None, :]
            D0, Ds, E = D0 * d0, Ds * ds, E * e
        q0 = q0 * D0
        qs = qs * Ds
        cost = 1.0 / torch.clamp(torch.maximum(
            torch.amax(torch.abs(q0), dim=1),
            gmax(torch.amax(torch.abs(qs), dim=(1, 2)))), min=1.0)
        q0, qs = cost[:, None] * q0, cost[:, None, None] * qs
        Q0 = cost[:, None, None] * (Q0 * D0[:, :, None] * D0[:, None, :])
        Qs = cost[:, None, None, None] * (Qs * Ds[..., :, None]
                                          * Ds[..., None, :])
        l, u = E * l, E * u

    D = torch.cat([D0, Ds.flatten(1)], dim=1)
    E = E.flatten(1)
    return BlockAngularOperator(
        comm=comm, Q0=Q0, Qs=Qs, T=T, W=W, q=torch.cat([q0, qs.flatten(1)], dim=1),
        l=l.flatten(1), u=u.flatten(1), c=p.c, D=D, Dinv=1.0 / D, E=E,
        Einv=1.0 / E, cost=cost, cinv=1.0 / cost,
        l_finite=l_finite.flatten(1), u_finite=u_finite.flatten(1))


def solve_block_angular_result(p: BlockAngularProblem,
                               settings: Optional[Settings] = None,
                               warm=None, device=None) -> Result:
    """The structured solve through the generic core; the whole
    ``Result``: x as the pair (x0 (1, n0), xs (1, S, ns)), y and the
    primal certificate (1, S, ms), the dual certificate a pair like x
    (certificates NaN-filled by status, per the MEX contract).  ``warm``
    is an (x0, xs, y) triple of unscaled points (with or without the
    batch axis)."""
    from ..parallel.dtensor import dtensor_from_local, is_dtensor, to_local

    settings = settings or Settings()
    mesh = next((a.device_mesh for a in p if is_dtensor(a)), None)
    comm = None
    if mesh is not None:
        from ..parallel.comm import ScenarioComm
        from ..parallel.dtensor import group_of

        S_global = p.T.shape[0]
        p = BlockAngularProblem(*(to_local(a) for a in p))
        comm = ScenarioComm(group_of(mesh), p.T.shape[-1])
    with matmul_precision(settings.matmul_precision):
        op = scale_block_angular(p, settings.scaling, device, comm)
    x0w = y0w = None
    if warm is not None:
        flat = lambda v: torch.as_tensor(to_local(v), dtype=op.dtype,
                                         device=op.device).reshape(1, -1)
        x0w = torch.cat([flat(warm[0]), flat(warm[1])], dim=1)
        y0w = flat(warm[2])
    res = solve_scaled(op, settings, x0w, y0w)
    S, ms, _, _ = op.shapes
    split = ((lambda v: v) if mesh is None else
             (lambda v: dtensor_from_local(v, mesh, dim=1, n_global=S_global)))
    dual = lambda v: split(v.reshape(v.shape[0], S, ms))

    def primal(v):
        v0, vs = op.split_primal(v)
        return v0, split(vs)

    return Result(x=primal(res.x), y=dual(res.y),
                  prim_inf_cert=dual(res.prim_inf_cert),
                  dual_inf_cert=primal(res.dual_inf_cert),
                  info=res.info)


def solve_block_angular(p: BlockAngularProblem,
                        settings: Optional[Settings] = None, warm=None,
                        device=None):
    """Compatibility wrapper returning (x0, xs, y, Info)."""
    res = solve_block_angular_result(p, settings, warm, device)
    x0, xs = res.x
    return x0, xs, res.y, res.info


def to_dense_problem(p: BlockAngularProblem, device=None):
    """The equivalent dense ``Problem`` (a batch of one), on the device
    the structured solve would use."""
    from ..api import make_problem

    p = BlockAngularProblem(*(a[0] for a in _batch_of_one(p, device)))
    S, ms, n0, ns = p.shapes
    n = n0 + S * ns
    dt, dev = p.Q0.dtype, p.Q0.device
    Q = torch.zeros((n, n), dtype=dt, device=dev)
    A = torch.zeros((S * ms, n), dtype=dt, device=dev)
    Q[:n0, :n0] = p.Q0
    for s in range(S):
        lo = n0 + s * ns
        Q[lo:lo + ns, lo:lo + ns] = p.Qs[s]
        A[s * ms:(s + 1) * ms, :n0] = p.T[s]
        A[s * ms:(s + 1) * ms, lo:lo + ns] = p.W[s]
    q = torch.cat([p.q0, p.qs.reshape(-1)])
    return make_problem(Q, q, A, p.l.reshape(-1), p.u.reshape(-1), p.c,
                        device=dev)
