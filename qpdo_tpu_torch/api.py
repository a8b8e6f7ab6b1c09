"""Public API: ``make_problem``, the functional ``solve``, the stateful
``QPDO`` class, and the sparse entry points ``solve_sparse``,
``solve_sparse_batch`` and ``solve_sparse_heterogeneous``.

Port of ``qpdo_tpu/api.py``.
The lifecycle mirrors the reference driver (include/qpdo.h:14-56): setup /
warm_start / solve / update_q / update_bounds / update_settings, with the
same in-place rescaling rules for parametric updates (qpdo.c:481-586).

The port is batch-first: ``make_problem`` and ``QPDO.setup`` take one
unbatched problem, as the JAX package does, and turn it into a batch of
one; results keep that leading axis (``res.x`` is (1, n)).  Both put
their tensors on ``device``, and ``device=None`` means ``"cuda"``: nothing
here looks for a GPU and carries on without one; pass ``device="cpu"`` to
run on the CPU.  ``Settings.verbose`` and a finite ``Settings.max_time``
route ``solve`` and ``QPDO.solve`` through the host-driven loop
(``solver/driver.py``: the iteration table, the wall-clock limit), which
takes one problem; every other setting of the dense path runs in
``solver/core.py`` on any batch.

The sparse entry points build a ``SparseOperator`` (``solver/sparse.py``)
from scipy.sparse, dense or triplet data and run the same core on it:
Newton steps by matrix-free preconditioned CG, or by the exact banded
factorization where the KKT pattern is banded.  They take ``device=`` as
``make_problem`` does (None is "cuda") and return batch-first results.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import constants as _c
from .solver.core import solve_scaled
from .solver.driver import solve_driven
from .solver.scaling import (ruiz_equilibrate, ruiz_equilibrate_kkt,
                             scale_problem)
from .types import Problem, Result, ScaledProblem, Scaling, Settings, tree_map
from .validate import validate_data, validate_settings


def _needs_host_driver(settings: Settings) -> bool:
    return settings.verbose or settings.max_time < _c.QPDO_INFTY


def _floating(a, dtype, device) -> torch.Tensor:
    t = torch.as_tensor(a, dtype=dtype, device=device)
    return t if t.is_floating_point() else t.to(torch.get_default_dtype())


def make_problem(Q, q, A, l, u, c=0.0, dtype=None, device=None) -> Problem:
    """Build a batch-of-one Problem from the array-likes of one QP (Q
    (n, n), q (n,), A (m, n), l and u (m,)), clamping +-inf bounds to
    +-QPDO_INFTY.  ``dtype`` defaults to Q's; ``device=None`` is "cuda"."""
    device = torch.device("cuda" if device is None else device)
    Q = _floating(Q, dtype, device)
    dt = Q.dtype
    if Q.dim() != 2:
        raise ValueError(f"Q must be (n, n), got {tuple(Q.shape)}")
    inf = _c.QPDO_INFTY
    n = Q.shape[-1]
    new = lambda a: torch.as_tensor(a, dtype=dt, device=device)
    A = new(A).reshape(-1, n)
    l = torch.clamp(new(l).reshape(-1), -inf, inf)
    u = torch.clamp(new(u).reshape(-1), -inf, inf)
    if A.shape[0] == 0:
        # unconstrained QP: one inert free row (the core assumes m >= 1)
        A = torch.zeros((1, n), dtype=dt, device=device)
        l = torch.full((1,), -inf, dtype=dt, device=device)
        u = torch.full((1,), inf, dtype=dt, device=device)
    return Problem(Q=Q[None], q=new(q).reshape(1, -1), A=A[None], l=l[None],
                   u=u[None], c=new(c).reshape(1))


def _warm(v, like: torch.Tensor):
    """A warm-start point as a (B, k) tensor beside ``like`` (None stays)."""
    if v is None:
        return None
    v = torch.as_tensor(v, dtype=like.dtype, device=like.device)
    return v.reshape(like.shape[0], -1)


def solve_sparse(Q, q, A, l, u, c=0.0, settings: Optional[Settings] = None,
                 x0=None, y0=None, dtype=None, device=None) -> Result:
    """Large-n solve with sparse data and matrix-free Newton steps.

    The algorithm and outputs of ``solve`` (one-shot setup and solve,
    qpdo.c:49-476), but Q/A stay sparse triplets and K is never formed,
    so memory is O(nnz + n + m), like the reference's CHOLMOD backend
    (src/cholmod_interface.c:35-52).  Accepts scipy.sparse, dense
    array-likes or ``(data, indices, shape)`` triples; ``Q`` must be the
    full symmetric matrix.  ``dtype`` defaults to float64 and
    ``device=None`` is "cuda".  ``verbose`` and a finite ``max_time`` go
    through the host-driven loop, as in ``solve``.  The result is a batch
    of one (``res.x`` is (1, n))."""
    from .solver.sparse import setup_sparse

    settings = settings or Settings()
    validate_settings(settings)
    t0 = time.perf_counter()
    op = setup_sparse(Q, q, A, l, u, c, settings.scaling, dtype,
                      precond=settings.precond,
                      precond_block=settings.precond_block,
                      ruiz_kkt=settings.ruiz_kkt, device=device)
    x0, y0 = _warm(x0, op.q), _warm(y0, op.l)
    if _needs_host_driver(settings):
        return solve_driven(op, settings, x0, y0, t0)
    return solve_scaled(op, settings, x0, y0)


def solve_sparse_batch(problems, settings: Optional[Settings] = None,
                       dtype=None, x0=None, y0=None, mesh=None,
                       axis: str = "batch", device=None) -> Result:
    """Lock-step batched solve of sparse QPs (sparse MPC fleets, scenario
    sweeps), the sparse counterpart of ``solve_batch``.

    ``problems`` is a sequence of ``(Q, q, A, l, u[, c])`` tuples of equal
    dimensions.  Instances that share one nonzero pattern batch directly;
    when the patterns differ, every instance is put on the UNION pattern
    with explicit zeros (``solver.sparse.union_triplets``), which leaves
    each result unchanged and costs nnz(union).  One ``SparseOperator``
    holds the fleet: float leaves stacked along the batch, index maps
    shared.  ``x0``/``y0`` ((B, n)/(B, m)) warm-start every instance.
    ``device=None`` is "cuda".

    ``mesh`` (a 1-D ``DeviceMesh``; every rank calls this with the whole
    fleet) splits the fleet over its ranks: the union pattern is built on
    every rank, each rank sets up and solves its ``torch.chunk`` block of
    the fleet (float leaves stacked, index maps the same everywhere), and
    the result's leaves are DTensors of the whole fleet split along the
    batch axis (``axis`` names the mesh axis, as in the JAX package)."""
    from .solver.sparse import (_as_triplets, _tensor, _torch_dtype,
                                setup_sparse_batch, union_triplets)

    settings = settings or Settings()
    validate_settings(settings)
    problems = [tuple(p) for p in problems]
    if not problems:
        raise ValueError("solve_sparse_batch: empty problem list")
    dt = _torch_dtype(dtype)
    # pattern check on the raw triplets, before any setup
    q_trips = [_as_triplets(p[0], dt) for p in problems]
    a_trips = [_as_triplets(p[2], dt) for p in problems]

    def same_pattern(trips):
        i0 = trips[0][1]
        return all(t[1].shape == i0.shape and np.array_equal(t[1], i0)
                   for t in trips[1:])

    if not (same_pattern(q_trips) and same_pattern(a_trips)):
        q_datas, q_idx, q_shape = union_triplets(q_trips, dt)
        a_datas, a_idx, a_shape = union_triplets(a_trips, dt)
        q_trips = [(d, q_idx, q_shape) for d in q_datas]
        a_trips = [(d, a_idx, a_shape) for d in a_datas]

    B = len(problems)
    if mesh is not None:
        from .parallel.dtensor import chunk_bounds, group_of, local_block

        group = group_of(mesh)
        lo, hi = chunk_bounds(B, torch.distributed.get_world_size(group),
                              torch.distributed.get_rank(group))
        if hi == lo:
            raise ValueError(f"solve_sparse_batch: {B} problems over "
                             f"{mesh.size()} ranks leave a rank without one")
        problems, q_trips, a_trips = (v[lo:hi] for v in (problems, q_trips,
                                                          a_trips))
        block = lambda v: None if v is None else local_block(
            v if isinstance(v, torch.Tensor) else torch.as_tensor(v), mesh)
        x0, y0 = block(x0), block(y0)

    def stack(values):
        return torch.stack([_tensor(v, dt, device).reshape(-1)
                            for v in values])

    op = setup_sparse_batch(
        stack([t[0] for t in q_trips]), q_trips[0][1],
        stack([t[0] for t in a_trips]), a_trips[0][1],
        stack([p[1] for p in problems]), stack([p[3] for p in problems]),
        stack([p[4] for p in problems]),
        stack([p[5] if len(p) > 5 else 0.0 for p in problems]),
        a_trips[0][2][0], settings.scaling, precond=settings.precond,
        precond_block=settings.precond_block, ruiz_kkt=settings.ruiz_kkt)
    res = solve_scaled(op, settings, _warm(x0, op.q), _warm(y0, op.l))
    if mesh is None:
        return res
    from .parallel.dtensor import dtensor_from_local

    return tree_map(lambda a: dtensor_from_local(a, mesh, 0, B), res)


def solve_sparse_heterogeneous(problems, settings: Optional[Settings] = None,
                               dtype=None, mesh=None, axis: str = "batch",
                               device=None) -> list:
    """A fleet of sparse problems of mixed SIZES: every instance is padded
    to the fleet's largest (n, m) with inert variables and rows
    (``solver.sparse.pad_sparse_problem``), the fleet is solved in one
    batch on the union pattern, and each result is sliced back to its
    problem's sizes.  Returns one Result per problem (a batch of one), in
    input order."""
    from .solver.sparse import _torch_dtype, pad_sparse_problem
    from .utils.padding import unpad_result

    problems = [tuple(p) for p in problems]
    if not problems:
        raise ValueError("solve_sparse_heterogeneous: empty problem list")
    dims = [(np.asarray(p[1]).reshape(-1).shape[0],
             np.asarray(p[3]).reshape(-1).shape[0]) for p in problems]
    n_pad = max(n for n, _ in dims)
    m_pad = max(m for _, m in dims)
    dt = _torch_dtype(dtype)
    padded = [pad_sparse_problem(p, n_pad, m_pad, dt) for p in problems]
    res = solve_sparse_batch(padded, settings, dtype, mesh=mesh, axis=axis,
                             device=device)
    if mesh is not None:
        from .parallel.dtensor import full_tensor

        res = tree_map(full_tensor, res)
    return [unpad_result(tree_map(lambda a, i=i: a[i:i + 1], res), n, m)
            for i, (n, m) in enumerate(dims)]


def solve(problem: Problem, settings: Optional[Settings] = None,
          x0=None, y0=None) -> Result:
    """One-shot functional solve (setup + optional warm start + solve) of
    a batch of problems, on the device of its tensors.  Equivalent to
    qpdo_setup + qpdo_warm_start + qpdo_solve (qpdo.c:49-476)."""
    settings = settings or Settings()
    validate_settings(settings)
    validate_data(problem)
    t0 = time.perf_counter()
    sp = scale_problem(problem, settings.scaling, settings.ruiz_kkt)
    x0, y0 = _warm(x0, problem.q), _warm(y0, problem.l)
    if _needs_host_driver(settings):
        return solve_driven(sp, settings, x0, y0, t0)
    return solve_scaled(sp, settings, x0, y0)


class QPDO:
    """Stateful solver handle: keeps the scaled data alive across solves
    for warm starting and MPC-style parametric updates."""

    def __init__(self):
        self._sp: Optional[ScaledProblem] = None
        self._settings = Settings()
        self._x0 = None
        self._y0 = None
        self._setup_time = 0.0
        self._last_x_scaled = None  # for update_q's cost-scalar recomputation

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    def default_settings() -> Settings:
        return Settings()

    @staticmethod
    def constant(name: str):
        """Solver constants by name (qpdo_mex.c:282-315)."""
        table = {
            "QPDO_INFTY": _c.QPDO_INFTY,
            "QPDO_NAN": float("nan"),
            "QPDO_SOLVED": _c.SOLVED,
            "QPDO_UNSOLVED": _c.UNSOLVED,
            "QPDO_PRIMAL_INFEASIBLE": _c.PRIMAL_INFEASIBLE,
            "QPDO_DUAL_INFEASIBLE": _c.DUAL_INFEASIBLE,
            "QPDO_MAX_ITER_REACHED": _c.MAX_ITER_REACHED,
        }
        if name not in table:
            raise ValueError(f"Constant not recognized: {name}")
        return table[name]

    def setup(self, Q, q, A, l, u, settings: Optional[Settings] = None,
              x0=None, y0=None, c=0.0, dtype=None, device=None) -> None:
        """qpdo_setup (qpdo.c:49-212): validate, scale, store, on
        ``device`` (None is "cuda")."""
        t0 = time.perf_counter()
        self._settings = settings or Settings()
        validate_settings(self._settings)
        problem = make_problem(Q, q, A, l, u, c, dtype, device)
        validate_data(problem)
        self._sp = scale_problem(problem, self._settings.scaling,
                                 self._settings.ruiz_kkt)
        self._x0 = _warm(x0, problem.q)
        self._y0 = _warm(y0, problem.l)
        self._last_x_scaled = None
        self._setup_time = time.perf_counter() - t0

    def warm_start(self, x=None, y=None) -> None:
        """qpdo_warm_start (qpdo.c:217-299): the points the next solve
        starts from (consumed by it)."""
        sp = self._require_setup()
        t0 = time.perf_counter()
        self._x0 = _warm(x, sp.data.q)
        self._y0 = _warm(y, sp.data.l)
        self._setup_time = time.perf_counter() - t0

    def solve(self) -> Result:
        """qpdo_solve (qpdo.c:304-476)."""
        sp = self._require_setup()
        t0 = time.perf_counter()
        if _needs_host_driver(self._settings):
            res = solve_driven(sp, self._settings, self._x0, self._y0, t0)
        else:
            res = solve_scaled(sp, self._settings, self._x0, self._y0)
        # reading the result on the host also waits for the device
        finite = bool(torch.isfinite(res.x).all())
        solve_time = time.perf_counter() - t0
        # keep the scaled iterate for update_q's cost rescaling (qpdo.c:556-559)
        if finite:
            self._last_x_scaled = sp.scaling.Dinv * res.x
        # the reference resets `initialized` after each solve (qpdo.c:459):
        # a new warm_start is needed before the next solve
        self._x0 = self._y0 = None
        like = res.info.objective
        info = res.info._replace(
            setup_time=torch.full_like(like, self._setup_time),
            solve_time=torch.full_like(like, solve_time),
            run_time=torch.full_like(like, self._setup_time + solve_time))
        return res._replace(info=info)

    # -- parametric updates (MPC workflow) ---------------------------------

    def update_bounds(self, l=None, u=None) -> None:
        """qpdo_update_bounds (qpdo.c:522-544): install new bounds, re-apply
        the stored E scaling in place."""
        sp = self._require_setup()
        d = sp.data
        dt = d.Q.dtype
        inf = _c.QPDO_INFTY
        new_l, new_u = d.l, d.u
        lf, uf = sp.l_finite, sp.u_finite

        def raw(v):
            v = _warm(v, d.l)
            if bool(torch.isnan(v).any()):
                raise ValueError("bounds must not contain NaN")
            return torch.clamp(v, -inf, inf)

        if l is not None:
            lr = raw(l)
            lf = (lr > -inf).to(dt)
            new_l = sp.scaling.E * lr
        if u is not None:
            ur = raw(u)
            uf = (ur < inf).to(dt)
            new_u = sp.scaling.E * ur
        if bool((new_l > new_u).any()):
            raise ValueError("lower bound greater than upper bound")
        self._sp = sp._replace(data=d._replace(l=new_l, u=new_u),
                               l_finite=lf, u_finite=uf)

    def update_q(self, q) -> None:
        """qpdo_update_q (qpdo.c:549-586): install a new linear cost,
        recompute the cost scalar c from the current gradient estimate, and
        rescale Q/q in place."""
        sp = self._require_setup()
        d = sp.data
        sc = sp.scaling
        q_new = _warm(q, d.q)
        if self._settings.scaling:
            qD = sc.D * q_new
            # gradient estimate at the last iterate: temp = D q_new + cinv*Qx
            # (qpdo.c:556-560); Qx here is the pure scaled product
            if self._last_x_scaled is not None:
                Qx = torch.matmul(d.Q, self._last_x_scaled[..., None])[..., 0]
            else:
                Qx = torch.zeros_like(qD)
            temp = qD + sc.cinv[:, None] * Qx
            c_new = 1.0 / torch.clamp(torch.amax(torch.abs(temp), dim=-1),
                                      min=1.0)
            ratio = c_new / sc.c
            q_scaled = c_new[:, None] * qD
            scaling = sc._replace(c=c_new, cinv=1.0 / c_new)
            self._sp = sp._replace(
                data=d._replace(Q=d.Q * ratio[:, None, None], q=q_scaled),
                scaling=scaling,
                norm_q=torch.amax(torch.abs(sc.Dinv * q_scaled), dim=-1))
        else:
            self._sp = sp._replace(
                data=d._replace(q=q_new),
                norm_q=torch.amax(torch.abs(q_new), dim=-1))

    def update_settings(self, settings: Settings) -> None:
        """qpdo_update_settings (qpdo.c:481-517).  Supports *increasing* the
        number of Ruiz iterations by running the residual passes on the
        already-scaled A and composing the scalings (qpdo.c:496-512)."""
        validate_settings(settings)
        sp = self._require_setup()
        old = self._settings
        if settings.scaling < old.scaling:
            raise ValueError(
                "Decreasing the number of scaling iterations is not allowed")
        if settings.scaling > old.scaling:
            extra = settings.scaling - old.scaling
            d = sp.data
            sc = sp.scaling
            if settings.ruiz_kkt:
                Q2, A2, dD, dE = ruiz_equilibrate_kkt(d.Q, d.A, extra)
            else:
                A2, dD, dE = ruiz_equilibrate(d.A, extra)
                Q2 = d.Q * dD[..., :, None] * dD[..., None, :]
            D = sc.D * dD
            E = sc.E * dE
            q2 = d.q * dD
            scaling = Scaling(D=D, Dinv=1.0 / D, E=E, Einv=1.0 / E,
                              c=sc.c, cinv=sc.cinv)
            self._sp = sp._replace(
                data=d._replace(Q=Q2, q=q2, A=A2, l=dE * d.l, u=dE * d.u),
                scaling=scaling,
                norm_q=torch.amax(torch.abs(scaling.Dinv * q2), dim=-1))
        self._settings = settings

    def delete(self) -> None:
        """qpdo_cleanup (qpdo.c:591-689); the tensors are freed with their
        last reference."""
        self._sp = None
        self._x0 = self._y0 = None
        self._last_x_scaled = None

    # -- helpers -----------------------------------------------------------

    def _require_setup(self) -> ScaledProblem:
        if self._sp is None:
            raise RuntimeError("setup() must be called first")
        return self._sp
