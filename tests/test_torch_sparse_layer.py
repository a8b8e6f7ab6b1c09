"""The PyTorch port's sparse layer (``qpdo_tpu_torch.sparse_qp_layer``)
against the JAX package's (``qpdo_tpu.sparse_qp_layer``) on the CPU,
float64.

* Forward and reverse mode against JAX on the problem of
  tests/test_diff.py:test_sparse_layer_matches_dense (n=12, m=18, A
  sparsified; the CG route of the adjoint).  x and y within 1e-8; the
  five gradients at the tolerance the JAX package holds its own sparse
  layer to (tests/test_diff.py: rtol 1e-4, atol 1e-7): the adjoint's
  v = W (A u - gy) on an active row is a difference of size diff_mu =
  1e-9 times |v|, so the CG adjoint's rounding (a residual at cg_tol
  1e-10, summed in another order) is amplified by up to 1/diff_mu in the
  A cotangent (2.9e-7 of max|gradient| found).  The JAX side runs in a
  child process: the XLA-CPU compiler has crashed compiling a gradient in
  a worker that compiled many programs before (ROADMAP.md "Tier-1
  verify").
* The layer's gradients against the port's dense ``qp_solve`` restricted
  to the pattern, at the JAX test's rtol 1e-4, atol 1e-7, on that problem
  and on a banded second-difference problem (n=40; the banded direct
  route of the adjoint).
* The pattern order (row-sorted COO of ``M.tocsr()``, equal to JAX's
  layer's), the defaults (``diff_mu = max(mu_min, 1e-8)``, float64), and
  a larger CG-route layer (n=250) whose gradient is finite and nonzero
  with a forward solution inside the KKT oracle.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert

from test_diff import SETTINGS, make_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TSETTINGS = convert.settings(SETTINGS)
NAMES = ("q_data", "a_data", "q", "l", "u")

_JAX_SIDE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import scipy.sparse as sps
import qpdo_tpu as qt
sys.path.insert(0, sys.argv[3])
from test_diff import SETTINGS
d = np.load(sys.argv[1])
out = {}
for case in ("cg",):
    g = lambda k: d[case + "_" + k]
    layer = qt.sparse_qp_layer(sps.csr_matrix(g("Q")), sps.csr_matrix(g("A")),
                               SETTINGS, diff_mu=1e-9)
    args = tuple(jnp.asarray(g(k)) for k in
                 ("q_data", "a_data", "q", "l", "u"))
    def loss(*a):
        x, y = layer(*a)
        return jnp.dot(g("gx"), x) + jnp.dot(g("gy"), y), (x, y)
    (_, (x, y)), grads = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True)(*args)
    out[case + "_x"], out[case + "_y"] = x, y
    out[case + "_qi"] = np.asarray(layer.q_indices)
    out[case + "_ai"] = np.asarray(layer.a_indices)
    for k, v in zip(("q_data", "a_data", "q", "l", "u"), grads):
        out[case + "_g" + k] = v
np.savez(sys.argv[2], **out)
"""


def _cg_case():
    """tests/test_diff.py:test_sparse_layer_matches_dense's problem."""
    rng = np.random.default_rng(5)
    n, m = 12, 18
    Q, q, A, l, u = make_qp(5, n, m)
    A = np.where(rng.random((m, n)) < 0.4, A, 0.0)
    A[np.all(A == 0, axis=1), 0] = 1.0
    return Q, q, A, l, u, rng.standard_normal(n), rng.standard_normal(m)


def _banded_case(n=40):
    rng = np.random.default_rng(11)
    m = n - 2
    A = np.zeros((m, n))
    for i in range(m):
        A[i, i:i + 3] = (1.0, -2.0, 1.0)
    Q = np.eye(n) * 1.5
    q = -np.sin(4 * np.pi * np.linspace(0, 1, n))
    return (Q, q, A, np.zeros(m), np.full(m, np.inf), rng.standard_normal(n),
            rng.standard_normal(m))


def _values(Q, q, A, l, u):
    Qc, Ac = sps.csr_matrix(Q).tocoo(), sps.csr_matrix(A).tocoo()
    return Qc.data, Ac.data, q, l, u


CASES = {"cg": _cg_case, "banded": _banded_case}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sparse_layer")
    arrays = {}
    for case, make in (("cg", _cg_case),):
        Q, q, A, l, u, gx, gy = make()
        vals = _values(Q, q, A, l, u)
        arrays.update({f"{case}_{k}": v for k, v in zip(NAMES, vals)})
        arrays.update({f"{case}_Q": Q, f"{case}_A": A, f"{case}_gx": gx,
                       f"{case}_gy": gy})
    np.savez(tmp / "in.npz", **arrays)
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(tmp / "in.npz"),
                    str(tmp / "out.npz"), str(tests)],
                   env=env, check=True, timeout=600)
    return dict(np.load(tmp / "out.npz"))


def _layer_grads(layer, vals, gx, gy):
    ts = [torch.tensor(np.asarray(v, np.float64), requires_grad=True)
          for v in vals]
    x, y = layer(*ts)
    loss = (torch.as_tensor(gx) * x).sum() + (torch.as_tensor(gy) * y).sum()
    return x.detach(), y.detach(), torch.autograd.grad(loss, ts)


def test_forward_and_gradients_match_jax(jax_side):
    case = "cg"
    Q, q, A, l, u, gx, gy = _cg_case()
    layer = pt.sparse_qp_layer(sps.csr_matrix(Q), sps.csr_matrix(A),
                               TSETTINGS, diff_mu=1e-9, device="cpu")
    assert np.array_equal(layer.q_indices, jax_side[case + "_qi"])
    assert np.array_equal(layer.a_indices, jax_side[case + "_ai"])
    x, y, grads = _layer_grads(layer, _values(Q, q, A, l, u), gx, gy)
    np.testing.assert_allclose(x.numpy(), jax_side[case + "_x"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(y.numpy(), jax_side[case + "_y"], rtol=0,
                               atol=1e-8)
    for name, g in zip(NAMES, grads):
        np.testing.assert_allclose(g.numpy(), jax_side[case + "_g" + name],
                                   rtol=1e-4, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_dense_qp_solve_on_the_pattern(case):
    Q, q, A, l, u, gx, gy = CASES[case]()
    layer = pt.sparse_qp_layer(sps.csr_matrix(Q), sps.csr_matrix(A),
                               TSETTINGS, diff_mu=1e-9, device="cpu")
    _, _, grads = _layer_grads(layer, _values(Q, q, A, l, u), gx, gy)
    dense = [torch.tensor(v, requires_grad=True) for v in (Q, q, A, l, u)]
    x, y = pt.qp_solve(*dense, TSETTINGS, diff_mu=1e-9)
    loss = (torch.as_tensor(gx) * x).sum() + (torch.as_tensor(gy) * y).sum()
    dQ, dq, dA, dl, du = [g.numpy() for g in torch.autograd.grad(loss, dense)]
    Qc, Ac = sps.csr_matrix(Q).tocoo(), sps.csr_matrix(A).tocoo()
    for got, ref in zip(grads, (dQ[Qc.row, Qc.col], dA[Ac.row, Ac.col], dq,
                                dl, du)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-7)


def test_pattern_order_and_defaults():
    Q, q, A, l, u, _, _ = _cg_case()
    layer = pt.sparse_qp_layer(sps.csc_matrix(Q), A)
    Ac = sps.coo_matrix(sps.csr_matrix(A).tocsr())
    assert np.array_equal(layer.a_indices, np.stack([Ac.row, Ac.col], 1))
    assert layer.q_indices.shape == (Q.size, 2)
    assert layer.dtype == torch.float64
    assert layer.diff_mu == max(pt.Settings().mu_min, 1e-8)
    assert pt.sparse_qp_layer(Q, A, pt.Settings(mu_min=1e-5)).diff_mu == 1e-5


def test_larger_cg_layer_gradient_is_finite():
    rng = np.random.default_rng(7)
    n, m = 250, 180
    Bm = sps.random(n, n, density=4.0 / n, random_state=7, format="csr")
    Q = (Bm.T @ Bm + 0.5 * sps.eye(n)).tocsr()
    A = sps.random(m, n, density=6.0 / n, random_state=8, format="csr")
    q, l, u = rng.standard_normal(n), -rng.random(m), rng.random(m)
    layer = pt.sparse_qp_layer(
        Q, A, pt.Settings(eps_abs=1e-8, newton_direct=False), diff_mu=1e-7,
        device="cpu")
    qv = torch.tensor(q, requires_grad=True)
    x, y = layer(Q.tocoo().data, A.tocsr().tocoo().data, qv, l, u)
    xn, yn = x.detach().numpy(), y.detach().numpy()
    rp = np.abs(A @ xn - np.clip(A @ xn + yn, l, u)).max()
    rd = np.abs(Q @ xn + q + A.T @ yn).max()
    assert max(rp, rd) < 1e-7
    (g,) = torch.autograd.grad((x ** 2).sum(), [qv])
    assert torch.isfinite(g).all() and g.norm() > 0
