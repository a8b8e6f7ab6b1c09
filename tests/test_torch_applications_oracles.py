"""The PyTorch port's applications (``qpdo_tpu_torch.applications``)
solved on the CPU in float64 and checked against independent oracles
(scipy.optimize, a Riccati recursion, strong duality, the problem's own
optimality conditions), never against the solver itself: the cases of
tests/test_applications.py, with their tolerances.  The SQP method takes
torch callables (``torch.func`` gives its derivatives).  The sparse
constructors (``lasso_sparse``, ``huber_sparse``) give the JAX package's
scipy.sparse tuples entry for entry, solve through ``solve_sparse`` in
JAX's status and iterations with x within 1e-8 of its x relative to
max(1, max|x|) (torch_parity.rel_err; a CG-route iterate moves with
rounding: 1.0e-8 absolute found on the Huber problem), meet the
subgradient or BFGS oracle, and reproduce the dense constructors'
solutions at the JAX tests' 1e-5.
"""

import numpy as np
import scipy.sparse as sps
import torch

import qpdo_tpu as qt
from qpdo_tpu import applications as japps

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import applications as apps
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

S = pt.Settings(verbose=False)


def _solve(problem, settings=S):
    res = pt.solve(problem, settings)
    assert res.info.status == ["solved"]
    return res


def _lasso_optimal(F, b, lam, x, tol=1e-5):
    g = F.T @ (F @ x - b)
    active = np.abs(x) > 1e-6
    assert np.all(np.abs(g[active] + lam * np.sign(x[active])) <= tol)
    assert np.all(np.abs(g[~active]) <= lam + tol)
    return active


def test_lasso_kkt_subgradient():
    rng = np.random.default_rng(0)
    F = rng.standard_normal((40, 15))
    xtrue = np.zeros(15)
    xtrue[:3] = [2.0, -1.5, 1.0]
    b = F @ xtrue + 0.05 * rng.standard_normal(40)
    x = _solve(apps.lasso(F, b, 2.0, device="cpu")).x.numpy()[0, :15]
    assert _lasso_optimal(F, b, 2.0, x).sum() <= 8


def test_nonneg_ls_matches_scipy():
    from scipy.optimize import nnls

    rng = np.random.default_rng(1)
    F = rng.standard_normal((30, 12))
    b = rng.standard_normal(30)
    res = _solve(apps.nonneg_ls(F, b, device="cpu"))
    np.testing.assert_allclose(res.x.numpy()[0], nnls(F, b)[0], atol=1e-6)


def test_svm_dual_strong_duality():
    rng = np.random.default_rng(2)
    N = 40
    X = np.concatenate([rng.standard_normal((N // 2, 2)) + 1.6,
                        rng.standard_normal((N // 2, 2)) - 1.6])
    y = np.concatenate([np.ones(N // 2), -np.ones(N // 2)])
    C = 1.0
    a = _solve(apps.svm_dual(X, y, C, device="cpu")).x.numpy()[0]
    assert np.all(a >= -1e-7) and np.all(a <= C + 1e-7)
    assert abs(y @ a) <= 1e-7
    w, bias = apps.svm_primal_from_dual(X, y, C, a, device="cpu")
    w, bias = w.numpy(), float(bias)
    margins = y * (X @ w + bias)
    primal = 0.5 * w @ w + C * np.maximum(0.0, 1.0 - margins).sum()
    dual = a.sum() - 0.5 * a @ ((X @ X.T) * np.outer(y, y)) @ a
    assert abs(primal - dual) <= 1e-4 * max(1.0, abs(primal))
    assert np.mean(np.sign(X @ w + bias) == y) >= 0.95


def test_portfolio_matches_slsqp():
    from scipy.optimize import minimize

    rng = np.random.default_rng(3)
    N = 8
    M = rng.standard_normal((N, N))
    Sigma = M @ M.T / N + 0.05 * np.eye(N)
    mu = rng.standard_normal(N) * 0.1
    gamma = 2.0
    w = _solve(apps.portfolio(mu, Sigma, gamma, device="cpu")).x.numpy()[0]
    assert abs(w.sum() - 1.0) <= 1e-7 and np.all(w >= -1e-8)
    obj = lambda v: gamma * v @ Sigma @ v - mu @ v
    ref = minimize(obj, np.full(N, 1.0 / N), method="SLSQP",
                   bounds=[(0, None)] * N,
                   constraints={"type": "eq", "fun": lambda v: v.sum() - 1.0},
                   options={"ftol": 1e-12, "maxiter": 500})
    assert obj(w) <= ref.fun + 1e-7


def test_mpc_condensed_unconstrained_matches_riccati():
    rng = np.random.default_rng(4)
    nx, nu, T = 3, 2, 8
    Ad = np.eye(nx) + 0.1 * rng.standard_normal((nx, nx))
    Bd = rng.standard_normal((nx, nu)) * 0.5
    Qx, Ru = np.eye(nx), 0.5 * np.eye(nu)
    x0 = rng.standard_normal(nx)
    U = _solve(apps.mpc_condensed(Ad, Bd, Qx, Ru, x0, T, device="cpu")
               ).x.numpy().reshape(T, nu)
    P, Ks = Qx.copy(), []
    for _ in range(T):
        K = np.linalg.solve(Ru + Bd.T @ P @ Bd, Bd.T @ P @ Ad)
        P = Qx + Ad.T @ P @ (Ad - Bd @ K)
        Ks.append(K)
    x = x0.copy()
    for k, K in enumerate(Ks[::-1]):
        np.testing.assert_allclose(U[k], -K @ x, atol=1e-6)
        x = Ad @ x + Bd @ (-K @ x)


def test_mpc_condensed_respects_bounds():
    nx, nu, T = 3, 1, 10
    Ad = np.array([[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.9]])
    Bd = np.array([[0.0], [0.05], [1.0]])
    x0 = np.array([1.5, 0.0, 0.0])
    U = _solve(apps.mpc_condensed(
        Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), x0, T, u_lo=np.array([-0.4]),
        u_hi=np.array([0.4]), x_lo=np.full(nx, -2.0), x_hi=np.full(nx, 2.0),
        device="cpu")).x.numpy().reshape(T, nu)
    assert np.all(np.abs(U) <= 0.4 + 2e-6)
    x = x0.copy()
    for k in range(T):
        x = Ad @ x + Bd @ U[k]
        assert np.all(np.abs(x) <= 2.0 + 2e-6)
    assert np.any(np.abs(U) >= 0.4 - 1e-7)


def test_huber_matches_bfgs():
    from scipy.optimize import minimize

    rng = np.random.default_rng(6)
    N, p = 50, 6
    F = rng.standard_normal((N, p))
    xtrue = rng.standard_normal(p)
    b = F @ xtrue + 0.1 * rng.standard_normal(N)
    b[::7] += 5.0
    delta = 0.5
    x = _solve(apps.huber_fit(F, b, delta, device="cpu")).x.numpy()[0, :p]

    def huber_obj(v):
        r = F @ v - b
        quad = np.abs(r) <= delta
        return (0.5 * np.sum(r[quad] ** 2)
                + np.sum(delta * (np.abs(r[~quad]) - 0.5 * delta)))

    ref = minimize(huber_obj, np.zeros(p), method="BFGS",
                   options={"gtol": 1e-10})
    np.testing.assert_allclose(huber_obj(x), ref.fun, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(x, ref.x, atol=1e-4)
    x_ls = np.linalg.lstsq(F, b, rcond=None)[0]
    assert np.linalg.norm(x - xtrue) < np.linalg.norm(x_ls - xtrue)


def test_lasso_batch():
    """A batch of Lasso instances, stacked, solves through the batched
    path (the counterpart of the JAX test's vmap of the constructor)."""
    rng = np.random.default_rng(7)
    Fb = rng.standard_normal((4, 20, 8))
    bb = rng.standard_normal((4, 20))
    ps = [apps.lasso(F, b, 0.5, device="cpu") for F, b in zip(Fb, bb)]
    res = pt.solve_batch(pt.Problem(*(torch.cat(f) for f in zip(*ps))), S)
    assert res.info.status == ["solved"] * 4
    for i in range(4):
        _lasso_optimal(Fb[i], bb[i], 0.5, res.x.numpy()[i, :8])


def test_sqp_minimize_classics():
    """sqp_minimize converges to the known optima of three classic NLPs
    (constrained Rosenbrock, HS6-style equality, entropy-simplex)."""
    inf = float("inf")
    f = lambda z: (1 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2
    c = lambda z: torch.stack([z[0] ** 2 + z[1] ** 2])
    x, its = apps.sqp_minimize(f, c, [0.0, 0.0], [-inf], [1.0], device="cpu")
    assert its < 50
    np.testing.assert_allclose(x.numpy(), [0.7864, 0.6177], atol=1e-3)

    f2 = lambda z: (1 - z[0]) ** 2
    c2 = lambda z: torch.stack([10.0 * (z[1] - z[0] ** 2)])
    x, _ = apps.sqp_minimize(f2, c2, [-1.2, 1.0], [0.0], [0.0], device="cpu")
    np.testing.assert_allclose(x.numpy(), [1.0, 1.0], atol=1e-5)

    f3 = lambda z: (torch.sum(z * torch.log(torch.clamp(z, min=1e-12)))
                    + z @ torch.arange(4.0, dtype=z.dtype))
    c3 = lambda z: torch.cat([torch.sum(z)[None], z])
    lo = [1.0] + [0.0] * 4
    hi = [1.0] + [inf] * 4
    x, _ = apps.sqp_minimize(f3, c3, [0.25] * 4, lo, hi, device="cpu")
    ref = np.exp(-np.arange(4.0))
    np.testing.assert_allclose(x.numpy(), ref / ref.sum(), atol=1e-4)


def _sparse_F(N, p, density, seed):
    rng = np.random.default_rng(seed)
    F = sps.random(N, p, density=density, random_state=seed, format="csr")
    F.data[:] = rng.standard_normal(F.nnz)
    return F, rng


def _same_tuple(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if sps.issparse(a):
            assert (a != b).nnz == 0 and a.shape == b.shape
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b))


def _sparse_solve_matches_jax(data):
    jr = qt.solve_sparse(*data)
    tr = pt.solve_sparse(*data, settings=S, device="cpu")
    assert tr.info.status == ["solved"]
    assert int(jr.info.status_val) == qt.SOLVED
    assert int(tr.info.iterations[0]) == int(jr.info.iterations)
    x, ref = tr.x.numpy()[0], np.asarray(jr.x)
    np.testing.assert_allclose(x, ref, rtol=0,
                               atol=1e-8 * max(1.0, np.abs(ref).max()))
    return x


def test_lasso_sparse_matches_jax_and_the_dense_lasso():
    F, rng = _sparse_F(50, 20, 0.3, 8)
    b = rng.standard_normal(50)
    data = apps.lasso_sparse(F, b, 1.0)
    _same_tuple(data, japps.lasso_sparse(F, b, 1.0))
    x = _sparse_solve_matches_jax(data)
    Fd = F.toarray()
    _lasso_optimal(Fd, b, 1.0, x[:20])
    dense = _solve(apps.lasso(Fd, b, 1.0, device="cpu")).x.numpy()[0]
    np.testing.assert_allclose(x[:20], dense[:20], atol=1e-5)
    # lifted consistency: r = F x at the optimum
    np.testing.assert_allclose(x[40:], F @ x[:20], atol=1e-6)


def test_huber_sparse_matches_jax_and_the_dense_huber():
    from scipy.optimize import minimize

    F, rng = _sparse_F(40, 10, 0.4, 9)
    b = rng.standard_normal(40)
    b[::6] += 3.0
    data = apps.huber_sparse(F, b, 0.4)
    _same_tuple(data, japps.huber_sparse(F, b, 0.4))
    x = _sparse_solve_matches_jax(data)[:10]
    Fd = F.toarray()
    dense = _solve(apps.huber_fit(Fd, b, 0.4, device="cpu")).x.numpy()[0]
    np.testing.assert_allclose(x, dense[:10], atol=1e-5)

    def huber_obj(v):
        r = np.abs(Fd @ v - b)
        return np.sum(np.where(r <= 0.4, 0.5 * r * r, 0.4 * (r - 0.2)))

    ref = minimize(huber_obj, np.zeros(10), method="BFGS",
                   options={"gtol": 1e-12})
    np.testing.assert_allclose(huber_obj(x), ref.fun, rtol=1e-8, atol=1e-8)
