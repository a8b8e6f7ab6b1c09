"""The PyTorch port's sparse path, QPS files and command line on the card
(marker ``cuda``).

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX, so they also run without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_sparse.py

A CG-route solve may take other iterations on the card than on the CPU
(its matvecs sum in another order where they gather); it is held to the
CPU's status and to the KKT oracle.  The banded route is a direct solve:
held to the CPU's iterations within one and x within 1e-6.  Every sum
into a shared target adds in map order on the card too
(``ops/ordered_sum.py``), so two card solves of one problem, by CG or
banded, give the same bits: x, y, iterations and every CG count.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import operators
from qpdo_tpu_torch.io import QPSData, write_qps
from qpdo_tpu_torch.ops import fused_residuals as fr
from qpdo_tpu_torch.ops import ordered_sum as osum
from qpdo_tpu_torch.solver.sparse import setup_sparse

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _random(n=300, m_ineq=150, seed=0):
    rng = np.random.default_rng(seed)
    bands = [rng.standard_normal(n - k) for k in range(3)]
    Bm = sps.diags(bands, offsets=[0, 1, 2])
    Q = (Bm.T @ Bm + 0.1 * sps.eye(n)).tocsr()
    A = sps.vstack([sps.random(m_ineq, n, density=5.0 / n, random_state=1,
                               data_rvs=rng.standard_normal),
                    sps.eye(n)]).tocsr()
    return (Q, rng.standard_normal(n), A,
            np.concatenate([-rng.random(m_ineq) - 0.5, -2 * np.ones(n)]),
            np.concatenate([rng.random(m_ineq) + 0.5, 2 * np.ones(n)]))


def _banded(n=200):
    rng = np.random.default_rng(0)
    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.arange(3)[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    return (sps.eye(n, format="csr") * (1 + rng.random()),
            rng.standard_normal(n), A, np.zeros(m), np.full(m, np.inf))


def _oracle(Q, q, A, l, u, x, y):
    Ax = A @ x
    return max(np.abs(Ax - np.clip(Ax + y, l, u)).max(),
               np.abs(Q @ x + q + A.T @ y).max())


def test_cg_route_on_the_card(device):
    data = _random()
    before = fr.fused_residuals.launches[torch.float64]
    card = pt.solve_sparse(*data)
    assert card.x.is_cuda
    assert fr.fused_residuals.launches[torch.float64] > before
    cpu = pt.solve_sparse(*data, device="cpu")
    assert card.info.status == cpu.info.status == ["solved"]
    assert _oracle(*data, card.x[0].cpu().numpy(),
                   card.y[0].cpu().numpy()) <= 1.1e-6


def test_banded_route_on_the_card(device):
    data = _banded()
    assert setup_sparse(*data).newton_exact(pt.Settings())
    card = pt.solve_sparse(*data)
    cpu = pt.solve_sparse(*data, device="cpu")
    assert card.info.status == cpu.info.status == ["solved"]
    assert abs(int(card.info.iterations[0]) - int(cpu.info.iterations[0])) <= 1
    np.testing.assert_allclose(card.x[0].cpu().numpy(), cpu.x[0].numpy(),
                               atol=1e-6)


def _counted_solve(data, monkeypatch):
    """A card solve and the (iterations, residual) of every CG solve."""
    calls = []
    pcg = operators.pcg

    def recorded(*args, **kwargs):
        out = pcg(*args, **kwargs)
        calls.append((int(out[1][0]), float(out[2][0])))
        return out

    monkeypatch.setattr(operators, "pcg", recorded)
    res = pt.solve_sparse(*data)
    monkeypatch.setattr(operators, "pcg", pcg)
    return res, calls


@pytest.mark.parametrize("make,cg", [(lambda: _random(600, 300), True),
                                     (_banded, False)], ids=["cg", "banded"])
def test_two_card_solves_give_the_same_bits(device, monkeypatch, make, cg):
    data = make()
    op = setup_sparse(*data)
    assert op.newton_exact(pt.Settings()) != cg
    before = osum.ordered_segment_sum.launches[torch.float64]
    first, calls = _counted_solve(data, monkeypatch)
    assert osum.ordered_segment_sum.launches[torch.float64] > before
    again, calls_again = _counted_solve(data, monkeypatch)
    assert first.info.status == ["solved"]
    assert calls == calls_again and (calls or not cg)
    assert torch.equal(first.info.iterations, again.info.iterations)
    assert torch.equal(first.x, again.x) and torch.equal(first.y, again.y)


def test_fleet_on_the_card(device):
    probs = [_random(120, 60, seed=s) for s in range(4)]
    res = pt.solve_sparse_batch(probs)
    assert res.x.is_cuda and res.info.status == ["solved"] * 4
    for b, p in enumerate(probs):
        assert _oracle(*p, res.x[b].cpu().numpy(),
                       res.y[b].cpu().numpy()) <= 1.1e-6


def test_command_line_on_the_card(device, tmp_path):
    Q, q, A, l, u = _random(200, 100)
    path = str(tmp_path / "p.qps")
    write_qps(QPSData("P", Q, q, 0.0, A, l, u, A.shape[0]), path)
    for flags in ([], ["--sparse"]):
        proc = subprocess.run([sys.executable, "-m", "qpdo_tpu_torch", *flags,
                               "--print-solution", path],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr
        head, sol = [json.loads(ln) for ln in proc.stdout.splitlines()]
        assert head["status"] == "solved"
        assert head["path"] == ("sparse" if flags else "dense")
        assert _oracle(Q, q, A, l, u, np.array(sol["x"]),
                       np.array(sol["y"])) <= 1.1e-6
