"""The PyTorch port's cyclic reduction, ELL matvecs, structured solve,
sparse layer and continuation ladders on the card (marker ``cuda``).

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX, so they also run without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_structured.py

* ``banded_algo="auto"`` takes cyclic reduction on a CUDA tensor: the
  scan's status (on the card), iterations within one and x within 1e-6.
* ``setup_sparse`` builds the ELL maps on the card; every matvec through
  them within 1e-13 of the scatter's, relative to the largest entry.
* The structured solve, the sparse layer (forward and backward) and a
  two-level ladder on the card: SOLVED, every result tensor on the card,
  and the structured solve against the CPU's within 1e-8.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import operators
from qpdo_tpu_torch.solver import structured
from qpdo_tpu_torch.solver.sparse import setup_sparse

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _banded(n=300, seed=0):
    rng = np.random.default_rng(seed)
    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.arange(3)[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    return (sps.eye(n, format="csr") * (1 + rng.random()),
            rng.standard_normal(n), A, np.zeros(m), np.full(m, np.inf))


def _bap(S=6, ms=10, n0=5, ns=7, seed=3):
    """tests/test_structured.py:_random_bap, in numpy."""
    rng = np.random.default_rng(seed)
    M0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
    Ms = rng.standard_normal((S, ns, ns)) / np.sqrt(ns)
    return structured.BlockAngularProblem(
        Q0=M0 @ M0.T + 0.5 * np.eye(n0),
        Qs=np.einsum("sij,skj->sik", Ms, Ms) + 0.5 * np.eye(ns),
        q0=rng.standard_normal(n0), qs=rng.standard_normal((S, ns)),
        T=rng.standard_normal((S, ms, n0)) * 0.5,
        W=rng.standard_normal((S, ms, ns)),
        l=-rng.random((S, ms)) - 0.1, u=rng.random((S, ms)) + 0.1,
        c=np.asarray(0.0))


def _all_on_card(*tensors):
    return all(t.is_cuda for t in tensors)


def test_auto_takes_cyclic_reduction_on_the_card(device, monkeypatch):
    data = _banded()
    calls = []
    factor = operators.SparseOperator._banded_factor_cr

    def counting(*args):
        calls.append(1)
        return factor(*args)

    monkeypatch.setattr(operators.SparseOperator, "_banded_factor_cr",
                        staticmethod(counting))
    cr = pt.solve_sparse(*data)
    assert calls and _all_on_card(cr.x, cr.y)
    scan = pt.solve_sparse(*data, settings=pt.Settings(banded_algo="scan"))
    assert cr.info.status == scan.info.status == ["solved"]
    assert abs(int(cr.info.iterations[0]) - int(scan.info.iterations[0])) <= 1
    np.testing.assert_allclose(cr.x[0].cpu().numpy(),
                               scan.x[0].cpu().numpy(), atol=1e-6)


def test_ell_matvecs_on_the_card(device):
    rng = np.random.default_rng(1)
    n, m = 400, 300
    Bm = sps.random(n, n, density=4.0 / n, random_state=1, format="csr")
    A = sps.random(m, n, density=6.0 / n, random_state=2, format="csr")
    op = setup_sparse((Bm.T @ Bm + sps.eye(n)).tocsr(), rng.standard_normal(n),
                      A, -np.ones(m), np.ones(m))
    assert op.ellQ is not None and op.ellA is not None
    assert op.ellAt is not None
    scatter = op._replace(ellQ=None, ellA=None, ellAt=None)
    x = torch.randn((1, n), dtype=torch.float64, device=device)
    y = torch.randn((1, m), dtype=torch.float64, device=device)
    for f, v in (("Qmv", x), ("Amv", x), ("Atmv", y)):
        a, b = getattr(op, f)(v), getattr(scatter, f)(v)
        assert (a - b).abs().max() <= 1e-13 * max(1.0, b.abs().max().item())


def test_structured_solve_on_the_card(device):
    p = _bap()
    card = structured.solve_block_angular_result(p)
    assert _all_on_card(*card.x, card.y, card.prim_inf_cert,
                        *card.dual_inf_cert, card.info.status_val)
    cpu = structured.solve_block_angular_result(p, device="cpu")
    assert card.info.status == cpu.info.status == ["solved"]
    for a, b in zip((*card.x, card.y), (*cpu.x, cpu.y)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-8)


def test_sparse_layer_on_the_card(device):
    rng = np.random.default_rng(7)
    n, m = 300, 200
    Bm = sps.random(n, n, density=4.0 / n, random_state=7, format="csr")
    Q = (Bm.T @ Bm + 0.5 * sps.eye(n)).tocsr()
    A = sps.random(m, n, density=6.0 / n, random_state=8, format="csr")
    layer = pt.sparse_qp_layer(Q, A, pt.Settings(newton_direct=False),
                               diff_mu=1e-7)
    q = torch.tensor(rng.standard_normal(n), device=device,
                     requires_grad=True)
    x, y = layer(Q.tocoo().data, A.tocsr().tocoo().data, q,
                 -rng.random(m), rng.random(m))
    (g,) = torch.autograd.grad((x ** 2).sum(), [q])
    assert _all_on_card(x, y, g) and torch.isfinite(g).all()


def test_continuation_on_the_card(device):
    fine = _banded(120, seed=4)
    coarse = _banded(60, seed=4)
    res = pt.solve_continuation(
        [coarse, fine], prolong=pt.grid1d_prolong(60, 120), return_all=True)
    assert all(r.info.status == ["solved"] for r in res)
    assert all(_all_on_card(r.x, r.y) for r in res)
