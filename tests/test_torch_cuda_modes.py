"""The dense modes of the PyTorch port on the card (marker ``cuda``): the
"inv" and "cg" Newton solves, the incremental KKT cache, the fused
right-hand side, the inertial prox centers, the chunked bisection, the
polish and the host-driven loop.

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_modes.py

A small batch of the bench family is solved on the card and on the CPU
(the kernels' plain versions): statuses equal, iterations within 3 (the
card's and the CPU's float sums differ in order), the formation and
residual kernels launched on the card.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.ops import fused_formation as ff
from qpdo_tpu_torch.ops import fused_residuals as fr
from qpdo_tpu_torch.ops import linalg as tl

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _family(B=8, n=30, m=45, seed=11):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


VARIANTS = [dict(kkt_solver="inv"), dict(kkt_solver="cg"),
            dict(kkt_update_rows=8), dict(fused_newton_rhs=True),
            dict(accel_gamma=0.5), dict(linesearch="bisect_chunk"),
            dict(polish=True)]


@pytest.mark.parametrize("extra", VARIANTS)
def test_mode_on_the_card_matches_the_cpu(device, extra):
    d = _family()
    settings = pt.Settings(**extra)
    res = {}
    ff.fused_formation.launches.clear()
    fr.fused_residuals.launches.clear()
    for dev in (device, "cpu"):
        res[dev] = pt.solve_batch(pt.Problem(**{
            k: torch.as_tensor(v, device=dev) for k, v in d.items()}),
            settings, compact=True)
    assert ff.fused_formation.launches[torch.float64] > 0
    assert fr.fused_residuals.launches[torch.float64] > 0
    card, cpu = res[device], res["cpu"]
    assert card.x.is_cuda
    assert torch.equal(card.info.status_val.cpu(), cpu.info.status_val)
    assert bool((cpu.info.status_val == pt.SOLVED).all())
    diff = (card.info.iterations.cpu() - cpu.info.iterations).abs().max()
    assert int(diff) <= 3


def test_saddle_solve_on_the_card(device):
    rng = np.random.default_rng(12)
    d = _family(B=4)
    act = (rng.random((4, 45)) < 0.4).astype(np.float64)
    args = [d["Q"], d["A"], act, rng.standard_normal((4, 30)),
            rng.standard_normal((4, 45))]
    for lu in (None, "float32"):
        got = tl.saddle_solve(*[torch.as_tensor(a, device=device)
                                for a in args], 1e-8, 2, lu)
        ref = tl.saddle_solve(*[torch.as_tensor(a) for a in args],
                              1e-8, 2, lu)
        for g, r in zip(got, ref):
            assert ((g.cpu() - r).abs().max() / r.abs().max()) <= 1e-10


def test_driver_on_the_card(device):
    d = {k: v[0] for k, v in _family(B=1).items()}
    solver = pt.QPDO()
    solver.setup(d["Q"], d["q"], d["A"], d["l"], d["u"],
                 pt.Settings(verbose=True, print_interval=10))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loud = solver.solve()
    assert "QPDO on GPU" in buf.getvalue() and loud.x.is_cuda
    solver.update_settings(pt.Settings())
    silent = solver.solve()
    assert int(loud.info.iterations) == int(silent.info.iterations)
    solver.update_settings(pt.Settings(eps_abs=1e-14, max_time=1e-3))
    timed = solver.solve()
    assert int(timed.info.status_val) == pt.constants.MAX_TIME_REACHED
