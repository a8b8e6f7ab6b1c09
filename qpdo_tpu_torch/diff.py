"""Differentiable QP solving: implicit differentiation through the KKT map.

Port of ``qpdo_tpu/diff.py``.  The *solution map* of the QP

    minimize    0.5 x' Q x + q' x
    subject to  l <= A x <= u

is one ``torch.autograd.Function``: ``qp_solve`` returns ``(x, y)``, its
``backward`` solves one adjoint KKT system (reverse mode: ``backward``,
``torch.autograd.grad``) and its ``jvp`` one tangent KKT system (forward
mode: ``torch.autograd.forward_ad``), so the solver is a layer in a
PyTorch model (the pattern of OptNet, Amos & Kolter 2017).

Derivation (``qpdo_tpu/diff.py:1-50``).  At a solution with strict
complementarity, ``(x, y)`` is the root of the piecewise-smooth KKT
residual the solver terminates on (src/iteration.c:37-59 and
src/termination.c:35-77 define the same map):

    F1(x, y) = Q x + q + A' y                      (stationarity)
    F2(x, y) = A x - clip(A x + y, l, u)           (prim. feas. + compl.)

Let ``z = A x + y`` and ``act_i = 1`` iff ``z_i < l_i`` or ``z_i > u_i``
(the activity test of newton.c:96-107 in the mu -> 0 limit).  On
inactive rows F2_i = -y_i (no data dependence); on active rows
F2_i = (A x)_i - b_i with b the touched bound.  Implicit differentiation
of F(z(theta), theta) = 0 is governed by the symmetric active-set saddle
matrix

    S = [[Q + sigma_d I,  (act*A)'                  ]]
        [[act*A,          diag(-mu_d*act + (1-act))]]

(``ops/linalg.saddle_solve``, the system the solution polish factors;
``mu_d``/``sigma_d`` are tiny regularizations in the roles of the
solver's own mu/sigma, types.h:164-169).  Forward mode: the solution
tangent solves  S [dx; dy] = [-(dQ x + dq + dA' y);  act*(db - dA x)]
with ``db = act_low*dl + act_up*du``, and the tangents are
``(dx, act*dy)``.  Reverse mode: since S is symmetric, the adjoint pair
solves  S [u; v] = [gx; gy]  and the parameter cotangents read off as

    dQ = -u x'          dq = -u           dA = -(y u' + (act*v) x')
    dl_i = v_i on active-at-lower rows    du_i = v_i on active-at-upper rows

``dQ`` is the raw (unsymmetrized) Jacobian: it matches finite differences
of a single entry.  For a symmetric parametrization of Q, symmetrize it
(``0.5 * (dQ + dQ.mT)``).

Caveats: gradients are meaningful only when the forward solve converged
(status SOLVED) at a solution with strict complementarity; at weakly
active constraints the map is nonsmooth and this returns one subgradient.

Where the port departs from the JAX package: it is batch-first, with no
vmap of a per-problem function.  Batched data (``Q`` (B, n, n), ``q``
(B, n), ``A`` (B, m, n), ``l``/``u`` (B, m)) is one batched solve and one
batched saddle solve per backward or tangent pass; unbatched data (``Q``
(n, n) and so on) gives unbatched outputs.  One Function carries both
rules, so ``mode`` only names the rule the caller means to use (JAX needs
a ``custom_vjp`` and a ``custom_jvp`` apart).

``sparse_qp_layer`` (``qpdo_tpu/diff.py:153-271``) is the large-n layer
of one problem with a fixed sparsity pattern: its forward pass is the
sparse solve, its backward pass the same adjoint solved matrix-free by
the sparse operator's Newton solve, with the Q and A cotangents as value
vectors on the pattern.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ops.linalg import saddle_solve
from .solver.core import solve_scaled
from .solver.scaling import scale_problem
from .types import Problem, Settings


def _activity(A, x, y, l, u):
    """Active set from the solution itself: z = Ax + y sits strictly
    outside [l, u] on active rows (displaced by the nonzero multiplier),
    strictly inside on inactive ones (the mu -> 0 limit of
    newton.c:96-107).  Returns (act_low, act_up, act as 0/1 in x's dtype)."""
    z = torch.matmul(A, x[..., None])[..., 0] + y
    act_low = z < l
    act_up = z > u
    return act_low, act_up, (act_low | act_up).to(x.dtype)


def _sigma_shift(Q, diff_sigma: float):
    if diff_sigma == 0.0:
        return Q
    return Q + diff_sigma * torch.eye(Q.shape[-1], dtype=Q.dtype,
                                      device=Q.device)


def _saddle(ctx, Q, A, act, r1, r2):
    s = ctx.settings
    return saddle_solve(_sigma_shift(Q, ctx.diff_sigma), A, act, r1, r2,
                        ctx.diff_mu, refine_steps=max(s.refine_steps, 2),
                        lu_dtype=s.kkt_dtype)


class _QPSolve(torch.autograd.Function):
    """(Q, q, A, l, u) -> (x, y) of a batch, with the implicit backward
    and jvp rules of the module docstring."""

    @staticmethod
    def forward(Q, q, A, l, u, settings: Settings, diff_mu: float,
                diff_sigma: float):
        # runs without recording (autograd is off inside forward), which
        # is what lets the solver loop reuse its buffers in place
        zero = torch.zeros(Q.shape[:1], dtype=Q.dtype, device=Q.device)
        sp = scale_problem(Problem(Q=Q, q=q, A=A, l=l, u=u, c=zero),
                           settings.scaling, settings.ruiz_kkt)
        res = solve_scaled(sp, settings)
        return res.x, res.y

    @staticmethod
    def setup_context(ctx, inputs, output):
        Q, q, A, l, u, settings, diff_mu, diff_sigma = inputs
        x, y = output
        ctx.settings, ctx.diff_mu, ctx.diff_sigma = settings, diff_mu, diff_sigma
        ctx.save_for_backward(Q, A, l, u, x, y)
        ctx.save_for_forward(Q, A, l, u, x, y)

    @staticmethod
    def backward(ctx, gx, gy):
        Q, A, l, u, x, y = ctx.saved_tensors
        gx = torch.zeros_like(x) if gx is None else gx.to(x.dtype)
        gy = torch.zeros_like(y) if gy is None else gy.to(y.dtype)
        act_low, act_up, act = _activity(A, x, y, l, u)
        # S is symmetric: S [u; v] = [gx; gy] gives the cotangent pair
        u_adj, v_adj = _saddle(ctx, Q, A, act, gx, gy)
        v_act = act * v_adj
        dQ = -(u_adj[..., :, None] * x[..., None, :])
        dA = -(y[..., :, None] * u_adj[..., None, :]
               + v_act[..., :, None] * x[..., None, :])
        zero = torch.zeros_like(v_adj)
        dl = torch.where(act_low, v_adj, zero)
        du = torch.where(act_up, v_adj, zero)
        return dQ, -u_adj, dA, dl, du, None, None, None

    @staticmethod
    def jvp(ctx, dQ, dq, dA, dl, du, *_):
        Q, A, l, u, x, y = ctx.saved_tensors
        act_low, act_up, act = _activity(A, x, y, l, u)
        zero_n, zero_m = torch.zeros_like(x), torch.zeros_like(y)
        r1 = -((zero_n if dQ is None else
                torch.matmul(dQ, x[..., None])[..., 0])
               + (zero_n if dq is None else dq)
               + (zero_n if dA is None else
                  torch.matmul(dA.mT, y[..., None])[..., 0]))
        db = torch.where(act_low, zero_m if dl is None else dl,
                         torch.where(act_up, zero_m if du is None else du,
                                     zero_m))
        dAx = zero_m if dA is None else torch.matmul(dA, x[..., None])[..., 0]
        dx, dy = _saddle(ctx, Q, A, act, r1, act * (db - dAx))
        return dx, act * dy


class _SparseQPSolve(torch.autograd.Function):
    """(q_data, a_data, q, l, u) -> (x, y) of one sparse problem on the
    pattern of a ``sparse_qp_layer``, with the adjoint backward rule."""

    @staticmethod
    def forward(q_data, a_data, q, l, u, layer):
        # unrecorded, as _QPSolve.forward: the loop reuses its buffers
        st = layer.settings
        op = layer._setup(q_data, a_data, q, l, u, st.scaling, st.ruiz_kkt)
        res = solve_scaled(op, st)
        return res.x[0], res.y[0]

    @staticmethod
    def setup_context(ctx, inputs, output):
        q_data, a_data, q, l, u, layer = inputs
        ctx.layer = layer
        ctx.save_for_backward(q_data, a_data, q, l, u, *output)

    @staticmethod
    def backward(ctx, gx, gy):
        q_data, a_data, q, l, u, x, y = ctx.saved_tensors
        layer = ctx.layer
        st = layer.settings
        dt, dev = x.dtype, x.device
        gx = torch.zeros_like(x) if gx is None else gx.to(dt)
        gy = torch.zeros_like(y) if gy is None else gy.to(dt)
        # the adjoint Newton solve through the whole sparse machinery
        # (block-Jacobi and coarse correction, or the exact banded solve
        # where the pattern allows) on the unscaled data: plain Jacobi CG
        # stagnates at the adjoint's 1/diff_mu conditioning
        op0 = layer._setup(q_data, a_data, q, l, u, 0, False)
        Amv = lambda v: op0.Amv(v[None])[0]
        Atmv = lambda v: op0.Atmv(v[None])[0]
        z = Amv(x) + y
        act_low = z < l
        act_up = z > u
        act = (act_low | act_up).to(dt)
        mu_d = torch.full_like(y, layer.diff_mu)
        W = act / mu_d
        st_adj = st.replace(cg_tol=min(st.cg_tol, 1e-10),
                            cg_max_iter=max(st.cg_max_iter, 2000))
        rhs = gx + Atmv(W * gy)
        sig_d = torch.full((1,), layer.diff_sigma, dtype=dt, device=dev)
        u_adj = op0.newton_solve(act[None], mu_d[None], sig_d, rhs[None],
                                 st_adj)[0]
        v = W * (Amv(u_adj) - gy)
        qi, qj = op0.q_idx[:, 0], op0.q_idx[:, 1]
        rows, cols = op0.a_idx[:, 0], op0.a_idx[:, 1]
        dq_data = -u_adj[qi] * x[qj]
        da_data = -(y[rows] * u_adj[cols] + v[rows] * x[cols])
        zero = torch.zeros_like(v)
        return (dq_data, da_data, -u_adj, torch.where(act_low, v, zero),
                torch.where(act_up, v, zero), None)


class sparse_qp_layer:
    """Differentiable large-n QP layer with a fixed sparsity pattern.

    Built once from pattern carriers (scipy.sparse or dense; only the
    nonzero patterns are kept), the layer maps the problem data of one
    QP to its solution:

        layer = sparse_qp_layer(Q0, A0, settings)
        x, y = layer(q_data, a_data, q, l, u)

    where ``q_data``/``a_data`` are the nonzero values of Q/A in the
    layer's row-sorted COO order (``layer.q_indices``/``layer.a_indices``,
    those of ``scipy.sparse.coo_matrix(M.tocsr())``).  All five arguments
    are differentiable: the backward pass solves the adjoint KKT system
    matrix-free (``SparseOperator.newton_solve`` at ``cg_tol`` <= 1e-10,
    ``cg_max_iter`` >= 2000, on the unscaled data), the sparse analogue
    of ``qp_solve``'s dense adjoint; Q/A cotangents are value vectors on
    the pattern (the gradient restricted to the pattern, which is the
    full gradient whenever the pattern is structural).

    ``dtype`` defaults to float64; ``diff_mu`` to ``max(mu_min, 1e-8)``.
    The data go to ``device``: None is ``q_data``'s device when it is a
    tensor, else "cuda".  ``x`` (n,) and ``y`` (m,) come back there."""

    def __init__(self, Q, A, settings: Optional[Settings] = None, *,
                 diff_mu: Optional[float] = None, diff_sigma: float = 0.0,
                 dtype=None, device=None):
        from .solver.sparse import _as_triplets, _torch_dtype

        self.settings = Settings() if settings is None else settings
        if diff_mu is None:
            diff_mu = max(float(self.settings.mu_min), 1e-8)
        self.diff_mu = float(diff_mu)
        self.diff_sigma = float(diff_sigma)
        self.dtype = _torch_dtype(dtype)
        self.device = device
        _, self.q_indices, self.q_shape = _as_triplets(Q, self.dtype)
        _, self.a_indices, self.a_shape = _as_triplets(A, self.dtype)

    def _setup(self, q_data, a_data, q, l, u, scaling_iters, ruiz_kkt):
        from .solver.sparse import setup_sparse

        st = self.settings
        return setup_sparse((q_data, self.q_indices, self.q_shape), q,
                            (a_data, self.a_indices, self.a_shape), l, u,
                            0.0, scaling_iters, self.dtype,
                            precond=st.precond,
                            precond_block=st.precond_block,
                            ruiz_kkt=ruiz_kkt, device=q.device)

    def __call__(self, q_data, a_data, q, l, u):
        device = self.device
        if device is None:
            device = (q_data.device if isinstance(q_data, torch.Tensor)
                      else "cuda")
        as_t = lambda a: torch.as_tensor(a, device=device).to(self.dtype)
        return _SparseQPSolve.apply(as_t(q_data), as_t(a_data), as_t(q),
                                    as_t(l), as_t(u), self)


def qp_solve(Q, q, A, l, u, settings: Optional[Settings] = None, *,
             diff_mu: Optional[float] = None, diff_sigma: float = 0.0,
             mode: str = "reverse", device=None):
    """Solve the QP and return ``(x, y)``, differentiable in all five data
    arguments by implicit differentiation (one saddle solve per backward
    or tangent pass; see the module docstring).

    ``Q`` (B, n, n), ``q`` (B, n), ``A`` (B, m, n), ``l``/``u`` (B, m) give
    ``x`` (B, n) and ``y`` (B, m); without the batch axis, unbatched
    outputs.  Everything is cast to Q's dtype and put on ``device``:
    None is Q's device when Q is a tensor, else "cuda".  ``mode``:
    ``"reverse"`` (``backward``, for ``torch.autograd.grad``) or
    ``"forward"`` (``jvp``, for ``torch.autograd.forward_ad``, the right
    choice for few-parameter sensitivities, e.g. MPC sensitivity
    analysis); the primal solve is the same, and the one Function here
    carries both rules.  ``diff_mu`` is the dual regularization of the
    sensitivity saddle system (default ``max(settings.mu_min, 1e-9)``),
    ``diff_sigma`` the primal one (default 0: the system is nonsingular
    whenever Q is positive definite on the active set's null space)."""
    settings = Settings() if settings is None else settings
    if diff_mu is None:
        diff_mu = max(float(settings.mu_min), 1e-9)
    if mode not in ("reverse", "forward"):
        raise ValueError("mode must be 'reverse' or 'forward'")
    if device is None:
        device = Q.device if isinstance(Q, torch.Tensor) else "cuda"
    Q = torch.as_tensor(Q, device=device)
    as_q = lambda a: torch.as_tensor(a, device=device).to(Q.dtype)
    q, A, l, u = as_q(q), as_q(A), as_q(l), as_q(u)
    single = Q.dim() == 2
    if single:
        Q, q, A, l, u = Q[None], q[None], A[None], l[None], u[None]
    x, y = _QPSolve.apply(Q, q, A, l, u, settings, float(diff_mu),
                          float(diff_sigma))
    return (x[0], y[0]) if single else (x, y)
