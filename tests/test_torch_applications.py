"""The PyTorch port's problem constructors (``qpdo_tpu_torch.applications``)
against the JAX package's on the same numpy inputs, on the CPU in
float64.  tests/test_torch_applications_oracles.py solves them against
independent oracles.

Every Problem array equals JAX's bit for bit where JAX computes it
without a sum (identity blocks, bounds, copies, elementwise products).
An entry that is a matrix product (F'F, F'b, b'b, and in the condensed
MPC every array but the identity rows) is a sum that XLA's and PyTorch's CPU kernels add
up in their own orders: those arrays are held to 8 units of float64
rounding relative to their largest entry (1.4e-14 absolute found on
entries near 45).
"""

import numpy as np
import pytest
import torch

from qpdo_tpu import applications as japps

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import applications as apps
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

EPS = np.finfo(np.float64).eps


def _lasso_data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((40, 15)), rng.standard_normal(40), 2.0)


def _svm_data():
    rng = np.random.default_rng(2)
    X = np.concatenate([rng.standard_normal((20, 2)) + 1.6,
                        rng.standard_normal((20, 2)) - 1.6])
    return X, np.concatenate([np.ones(20), -np.ones(20)]), 1.0


def _portfolio_data():
    rng = np.random.default_rng(3)
    M = rng.standard_normal((8, 8))
    return rng.standard_normal(8) * 0.1, M @ M.T / 8 + 0.05 * np.eye(8), 2.0


def _mpc_data():
    rng = np.random.default_rng(4)
    Ad = np.eye(3) + 0.1 * rng.standard_normal((3, 3))
    Bd = rng.standard_normal((3, 2)) * 0.5
    return (Ad, Bd, np.eye(3), 0.5 * np.eye(2), rng.standard_normal(3), 8)


# (constructor, data, keyword arguments, the fields that are matrix
# products in the JAX package's construction)
CASES = {
    "lasso": ("lasso", _lasso_data, {}, ("Q", "q", "c")),
    "nonneg_ls": ("nonneg_ls", lambda: _lasso_data()[:2], {},
                  ("Q", "q", "c")),
    "huber_fit": ("huber_fit", lambda: _lasso_data()[:2] + (0.5,), {}, ()),
    "svm_dual": ("svm_dual", _svm_data, {}, ("Q",)),
    "portfolio": ("portfolio", _portfolio_data, dict(w_max=0.4), ()),
    "mpc_condensed": ("mpc_condensed", _mpc_data,
                      dict(u_lo=-0.4, u_hi=np.array([0.4, 0.5]),
                           x_lo=np.full(3, -2.0), x_hi=2.0),
                      ("Q", "q", "A", "l", "u", "c")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_constructor_matches_jax(case):
    name, data, kw, products = CASES[case]
    args = data()
    tp = getattr(apps, name)(*args, **kw, device="cpu")
    jp = getattr(japps, name)(*args, **kw)
    assert tp.Q.device.type == "cpu" and tp.Q.dtype == torch.float64
    for field in pt.Problem._fields:
        got = getattr(tp, field).numpy()[0]
        want = np.asarray(getattr(jp, field))
        assert got.shape == want.shape, field
        if field in products:
            scale = max(1.0, np.abs(want).max())
            assert np.abs(got - want).max() <= 8 * EPS * scale, field
        else:
            np.testing.assert_array_equal(got, want, field)


def test_svm_primal_from_dual_matches_jax():
    X, y, C = _svm_data()
    alpha = np.random.default_rng(5).random(len(y)) * C
    alpha[:3] = 0.0
    w, bias = apps.svm_primal_from_dual(X, y, C, alpha, device="cpu")
    jw, jbias = japps.svm_primal_from_dual(X, y, C, alpha)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=8 * EPS)
    np.testing.assert_allclose(float(bias), float(jbias), rtol=1e-14)


def test_mpc_condensed_scalar_bounds():
    """Scalar bounds broadcast to every stage; a wrong-length vector
    raises at construction, not deep in the solver."""
    Ad = np.array([[1.0, 0.1], [0.0, 0.95]])
    Bd = np.array([[0.0], [0.1]])
    args = (Ad, Bd, np.eye(2), 0.1 * np.eye(1), np.array([1.2, 0.0]), 6)
    res = pt.solve(apps.mpc_condensed(*args, u_lo=-0.3, u_hi=0.3,
                                      device="cpu"))
    assert res.info.status == ["solved"]
    assert np.all(np.abs(res.x.numpy()) <= 0.3 + 2e-6)
    with pytest.raises(ValueError, match="bound must be"):
        apps.mpc_condensed(*args, u_lo=np.zeros(5), device="cpu")
