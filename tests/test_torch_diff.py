"""The PyTorch port's differentiable layer (``qpdo_tpu_torch.qp_solve``)
against the JAX package's (``qpdo_tpu.qp_solve``) and against finite
differences of the solved QP, on the CPU in float64.

The problems are those of tests/test_diff.py (``make_qp``, n=12, m=18,
eps_abs 1e-10).  Tolerances: x and y within 1e-8 of JAX's and the five
gradients within 1e-9 relative to max|gradient| (both solves run the
same iterations; 3.2e-14 found); finite differences at the reference
test's rtol 2e-3, atol 5e-4 (their noise is ~eps_abs / h); forward mode
against reverse mode at the reference test's rtol 1e-6, atol 1e-8.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert

from test_diff import H, SETTINGS, fd_grad, make_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TSETTINGS = convert.settings(SETTINGS)

# The JAX package's solution and gradients of one loss, computed in a
# child process: the XLA-CPU compiler has crashed compiling qp_solve's
# gradient in a process that had compiled many programs before it
# (ROADMAP.md, "Tier-1 verify"), and a worker of the parallel suite can
# come here straight from tests/test_fuzz.py.
_JAX_SIDE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import qpdo_tpu as qt
sys.path.insert(0, sys.argv[3])
from test_diff import SETTINGS
d = np.load(sys.argv[1])
theta = tuple(jnp.asarray(d[k]) for k in "Q q A l u".split())
def loss(th):
    x, y = qt.qp_solve(*th, SETTINGS)
    return jnp.dot(d["gx"], x) + jnp.dot(d["gy"], y)
x, y = qt.qp_solve(*theta, SETTINGS)
grads = jax.grad(loss)(theta)
np.savez(sys.argv[2], x=x, y=y, **{"g" + k: g for k, g in
                                   zip("Q q A l u".split(), grads)})
"""


def _tensors(theta, grad=False):
    return [torch.tensor(np.asarray(a, np.float64), requires_grad=grad)
            for a in theta]


def _loss(theta, gx, gy, settings=TSETTINGS):
    x, y = pt.qp_solve(*theta, settings)
    return (torch.as_tensor(gx) * x).sum() + (torch.as_tensor(gy) * y).sum()


def _grads(theta, gx, gy):
    ts = _tensors(theta, grad=True)
    return [g.numpy() for g in torch.autograd.grad(_loss(ts, gx, gy), ts)]


@pytest.fixture(scope="module")
def problem():
    Q, q, A, l, u = make_qp(0)
    x, y = pt.qp_solve(*_tensors((Q, q, A, l, u)), TSETTINGS)
    z = A @ x.numpy() + y.numpy()
    act = (z < l) | (z > u)
    assert 0 < act.sum() < len(l)
    assert np.min(np.abs(y.numpy()[act])) > 1e-3
    return Q, q, A, l, u


@pytest.fixture(scope="module")
def cotangents(problem):
    rng = np.random.default_rng(99)
    return rng.standard_normal(problem[0].shape[0]), \
        rng.standard_normal(problem[2].shape[0])


def test_solution_and_gradients_match_jax(problem, cotangents, tmp_path):
    gx, gy = cotangents
    names = "Q q A l u".split()
    np.savez(tmp_path / "in.npz", gx=gx, gy=gy, **dict(zip(names, problem)))
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz"), str(tests)],
                   env=env, check=True, timeout=600)
    jax_side = np.load(tmp_path / "out.npz")
    x, y = pt.qp_solve(*_tensors(problem), TSETTINGS)
    np.testing.assert_allclose(x.numpy(), jax_side["x"], rtol=0, atol=1e-8)
    np.testing.assert_allclose(y.numpy(), jax_side["y"], rtol=0, atol=1e-8)
    for name, g in zip(names, _grads(problem, gx, gy)):
        jg = jax_side["g" + name]
        assert np.abs(g - jg).max() <= 1e-9 * np.abs(jg).max(), name


@pytest.mark.parametrize("which,coords", [
    ((1,), lambda n, m: range(n)),                            # q
    ((3, 4), lambda n, m: range(m)),                          # l, u
    ((0,), lambda n, m: np.random.default_rng(3).choice(n * n, 8, False)),
    ((2,), lambda n, m: np.random.default_rng(4).choice(m * n, 8, False)),
], ids=["q", "bounds", "Q_entries", "A_entries"])
def test_gradients_match_finite_differences(problem, cotangents, which,
                                            coords):
    gx, gy = cotangents
    grads = _grads(problem, gx, gy)
    loss = lambda th: _loss(_tensors(th), gx, gy).item()
    n, m = problem[0].shape[0], problem[2].shape[0]
    for w in which:
        for c, val in fd_grad(loss, problem, w, coords(n, m)).items():
            np.testing.assert_allclose(grads[w].flat[c], val, rtol=2e-3,
                                       atol=5e-4, err_msg=f"{w} {c}")


def test_inactive_bounds_have_zero_gradient(problem, cotangents):
    Q, q, A, l, u = problem
    grads = _grads(problem, *cotangents)
    x, y = pt.qp_solve(*_tensors(problem), TSETTINGS)
    z = A @ x.numpy() + y.numpy()
    inactive = (z >= l) & (z <= u)
    assert inactive.any()
    assert np.all(grads[3][inactive] == 0) and np.all(grads[4][inactive] == 0)


def test_equality_constrained_gradient():
    """Equality rows (l == u) are always active; the gradient in b, with
    l and u moving together, matches finite differences (the case of
    tests/test_diff.py::test_equality_constrained_grad)."""
    rng = np.random.default_rng(11)
    n, m = 8, 4
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.5 * np.eye(n)
    q = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = rng.standard_normal(m) * 0.3
    gx = torch.tensor(rng.standard_normal(n))
    base = _tensors((Q, q, A))

    def loss_b(bv):
        x, _ = pt.qp_solve(*base, bv, bv, TSETTINGS)
        return (gx * x).sum()

    bt = torch.tensor(b, requires_grad=True)
    g = torch.autograd.grad(loss_b(bt), bt)[0].numpy()
    for c in range(m):
        bp, bm = b.copy(), b.copy()
        bp[c] += H
        bm[c] -= H
        fd = (loss_b(torch.tensor(bp)) - loss_b(torch.tensor(bm))).item() \
            / (2 * H)
        np.testing.assert_allclose(g[c], fd, rtol=2e-3, atol=5e-4)


def test_forward_mode_matches_reverse():
    """The Jacobian of q -> x by tangents (jvp, one per basis direction)
    equals the one by cotangents (backward, one per output), and
    <g, J t> = <J' g, t> for random g and t."""
    Q, q, A, l, u = make_qp(31)
    n = len(q)
    Qt, At, lt, ut = _tensors((Q, A, l, u))

    def x_of(qv, mode):
        return pt.qp_solve(Qt, qv, At, lt, ut, TSETTINGS, mode=mode)[0]

    def jvp(t):
        with fwAD.dual_level():
            x = x_of(fwAD.make_dual(torch.tensor(q), t), "forward")
            return fwAD.unpack_dual(x).tangent

    Jf = torch.stack([jvp(e) for e in torch.eye(n, dtype=torch.float64)], 1)
    qr = torch.tensor(q, requires_grad=True)
    x = x_of(qr, "reverse")
    Jr = torch.stack([torch.autograd.grad(x[i], qr, retain_graph=True)[0]
                      for i in range(n)])
    np.testing.assert_allclose(Jf.numpy(), Jr.numpy(), rtol=1e-6, atol=1e-8)
    rng = np.random.default_rng(5)
    g, t = (torch.tensor(rng.standard_normal(n)) for _ in range(2))
    lhs = (g * jvp(t)).sum().item()
    rhs = (torch.autograd.grad((g * x).sum(), qr)[0] * t).sum().item()
    assert abs(lhs - rhs) <= 1e-6 * max(1.0, abs(rhs))


def test_forward_mode_jvp_matches_finite_differences():
    """One jvp along a random direction in (q, l, u) against central
    differences of the solved QP (tests/test_diff.py, same tolerances)."""
    Q, q, A, l, u = make_qp(32)
    rng = np.random.default_rng(33)
    dq = rng.standard_normal(q.shape)
    dl = rng.standard_normal(l.shape) * 0.01
    du = rng.standard_normal(u.shape) * 0.01
    Qt, At = _tensors((Q, A))
    with fwAD.dual_level():
        x, y = pt.qp_solve(
            Qt, fwAD.make_dual(torch.tensor(q), torch.tensor(dq)), At,
            fwAD.make_dual(torch.tensor(l), torch.tensor(dl)),
            fwAD.make_dual(torch.tensor(u), torch.tensor(du)), TSETTINGS,
            mode="forward")
        dx, dy = fwAD.unpack_dual(x).tangent, fwAD.unpack_dual(y).tangent
    solve = lambda s: pt.qp_solve(Qt, *_tensors((q + s * H * dq,)), At,
                                  *_tensors((l + s * H * dl, u + s * H * du)),
                                  TSETTINGS)
    (xp, yp), (xm, ym) = solve(1), solve(-1)
    np.testing.assert_allclose(dx.numpy(), ((xp - xm) / (2 * H)).numpy(),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dy.numpy(), ((yp - ym) / (2 * H)).numpy(),
                               rtol=1e-3, atol=1e-4)


def test_mode_validation():
    theta = _tensors(make_qp(34))
    with pytest.raises(ValueError, match="mode must be"):
        pt.qp_solve(*theta, TSETTINGS, mode="banana")


def test_batched_call_equals_per_problem_calls(problem):
    """A batch of perturbed QPs in one call gives each problem's solution
    and gradient of the unbatched call (the counterpart of
    tests/test_diff.py::test_jit_and_vmap; the batched saddle solve runs
    the same operations per problem)."""
    Q, q, A, l, u = problem
    B = 4
    qs = q[None] + 0.1 * np.random.default_rng(7).standard_normal((B, len(q)))
    rep = lambda a: torch.tensor(np.repeat(a[None], B, axis=0))
    qb = torch.tensor(qs, requires_grad=True)
    x, _ = pt.qp_solve(rep(Q), qb, rep(A), rep(l), rep(u), TSETTINGS)
    assert x.shape == (B, len(q))
    g = torch.autograd.grad((x ** 2).sum(), qb)[0]
    for i in range(B):
        qi = torch.tensor(qs[i], requires_grad=True)
        xi, _ = pt.qp_solve(*_tensors((Q,)), qi, *_tensors((A, l, u)),
                            TSETTINGS)
        gi = torch.autograd.grad((xi ** 2).sum(), qi)[0]
        np.testing.assert_allclose(x[i].detach().numpy(), xi.detach().numpy(),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(g[i].numpy(), gi.numpy(), rtol=1e-6,
                                   atol=1e-9)
