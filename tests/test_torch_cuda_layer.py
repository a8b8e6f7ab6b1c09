"""The PyTorch port's differentiable layer, serving and the ``pallas_kkt``
rules on the card (marker ``cuda``).

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX, so they also run without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda*.py

Card and CPU sum in other orders (the kernels, cuBLAS and cuSOLVER
against the CPU's), so results are held to the oracle and to the CPU
within tolerances, except where the same route must give the same bits.
"""

import numpy as np
import pytest
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_formation as ff
from qpdo_tpu_torch.ops import fused_kkt as fk
from qpdo_tpu_torch.ops import fused_residuals as fr
from qpdo_tpu_torch.serve import SolverService

pytestmark = pytest.mark.cuda
F32, F64 = torch.float32, torch.float64


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _family(B, n, m, seed, device):
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((B, n, n))
    d = dict(Q=np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
             q=rng.standard_normal((B, n)), A=rng.standard_normal((B, m, n)),
             l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))
    return pt.Problem(**{k: torch.as_tensor(v, device=device)
                         for k, v in d.items()})


def _launches():
    return (sum(ff.fused_formation.launches.values()),
            sum(fr.fused_residuals.launches.values()),
            fk.fused_kkt_solve.launches[F32])


def test_route_limits_are_the_kernels_limits(device):
    assert kernels.SHARED_MAX_N == {
        name: kernels.shared_max_n(name) for name in kernels.SHARED_MAX_N}


def test_a_problem_above_the_shared_route_solves_through_every_entry(device):
    """n = 221 with pallas_kkt and a float32 KKT dtype, once refused at
    setup: every entry point solves it through a route of the fused
    kernel above its shared-memory route (global or cluster, counted),
    with the plain version's statuses on the CPU."""
    n = 221
    settings = pt.Settings(pallas_kkt=True, kkt_dtype="float32",
                           mu_min=1e-7, refine_steps=2)
    probs = _family(2, n, 332, 1, device)
    one = [t[0].cpu().numpy() for t in probs[:5]]
    cpu = pt.solve_batch(_family(2, n, 332, 1, torch.device("cpu")), settings)
    assert cpu.info.status == ["solved"] * 2

    def above():
        return (fk.fused_kkt_solve.routes["global"]
                + fk.fused_kkt_solve.routes["cluster"])

    def qpdo():
        s = pt.QPDO()
        s.setup(*one, settings=settings)
        return s.solve()

    for call in (lambda: pt.solve_batch(probs, settings),
                 lambda: pt.solve_batch(probs, settings, compact=True),
                 lambda: pt.solve(pt.make_problem(*one, device=device),
                                  settings),
                 qpdo):
        before = above()
        res = call()
        assert above() > before
        assert res.x.is_cuda and set(res.info.status) == {"solved"}
    before = above()
    x, y = pt.qp_solve(*(t[0] for t in probs[:5]), settings)
    assert above() > before
    assert x.is_cuda and torch.isfinite(x).all() and torch.isfinite(y).all()


def test_pallas_kkt_with_a_float64_kkt_dtype_is_the_chol_route(device):
    """At the library defaults (kkt_dtype None, float64 state) the flag
    takes the reference's route on a device: the chol solve, bit for bit
    the solve without the flag, and no launch of the fused kernel."""
    probs = _family(6, 30, 45, 2, device)
    before = fk.fused_kkt_solve.launches[F32]
    with_flag = pt.solve_batch(probs, pt.Settings(pallas_kkt=True))
    assert fk.fused_kkt_solve.launches[F32] == before
    without = pt.solve_batch(probs, pt.Settings())
    for a, b in ((with_flag.x, without.x), (with_flag.y, without.y),
                 (with_flag.info.iterations, without.info.iterations)):
        assert torch.equal(a, b)
    assert with_flag.info.status == ["solved"] * 6


def test_qp_solve_gradients_on_card_match_cpu(device):
    probs = _family(4, 12, 18, 3, device)
    rng = np.random.default_rng(4)
    gx, gy = rng.standard_normal((4, 12)), rng.standard_normal((4, 18))
    settings = pt.Settings(eps_abs=1e-10, max_iter=500)
    grads = {}
    for dev in (device, torch.device("cpu")):
        theta = [t.to(dev).requires_grad_() for t in probs[:5]]
        before = _launches()
        x, y = pt.qp_solve(*theta, settings)
        if dev.type == "cuda":
            assert x.is_cuda and _launches()[0] > before[0] \
                and _launches()[1] > before[1]
        loss = (torch.as_tensor(gx, device=dev) * x).sum() \
            + (torch.as_tensor(gy, device=dev) * y).sum()
        grads[dev.type] = [g.cpu() for g in torch.autograd.grad(loss, theta)]
    for g, c in zip(grads["cuda"], grads["cpu"]):
        assert ((g - c).abs().max() / c.abs().max()).item() <= 1e-6


def test_solver_service_on_card(device):
    svc = SolverService(max_batch=8, max_wait_ms=20)
    try:
        probs = _family(12, 20, 30, 5, device)
        futs = [svc.submit(pt.Problem(*(t[i:i + 1] for t in probs)))
                for i in range(12)]
        results = [f.result(timeout=600) for f in futs]
    finally:
        svc.shutdown()
    direct = pt.solve_batch(probs)
    for i, res in enumerate(results):
        assert res.x.is_cuda and res.info.status == ["solved"]
        np.testing.assert_allclose(res.x.cpu().numpy()[0],
                                   direct.x.cpu().numpy()[i], rtol=0,
                                   atol=1e-6)
