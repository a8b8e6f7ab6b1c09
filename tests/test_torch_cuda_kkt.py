"""The PyTorch port's KKT-solve kernels and its GPU-by-default entry points
on the card (marker ``cuda``).

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX, so they also run where JAX is not installed, without the suite's
conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda*.py

The fused KKT solve and the stacked Cholesky solve are held against their
plain PyTorch versions on the same CUDA tensors to 1e-4 of max|dx| (the
same recurrences summed in another order; 4e-6 found at the bench shape)
on each of their three routes, failed problems must stay in their place,
and solves through ``Settings.pallas_kkt`` and ``QPDO`` on the card must
agree with the CPU.  The formation kernel's split route is held to its
plain version at the row-sharded shapes.
"""

import numpy as np
import pytest
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_formation as ff
from qpdo_tpu_torch.ops import fused_kkt as fk

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _kkt_args(device, B, m, n, seed=3, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((B, n, n))
    arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
              rng.standard_normal((B, m, n)), rng.random((B, m)),
              np.full(B, 1e-3), rng.standard_normal((B, n)))
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


# n <= 128 takes the register route, up to 220 the shared-memory route,
# above it the global-memory route (m = 1.5 n, the bench family's ratio)
@pytest.mark.parametrize("B,m,n", [(8, 150, 100), (5, 45, 37), (3, 7, 3),
                                   (2, 300, 220), (4, 190, 128),
                                   (4, 190, 129), (3, 20, 16), (3, 30, 17),
                                   (260, 150, 100), (2, 332, 221),
                                   (2, 384, 256), (2, 450, 300),
                                   (2, 768, 512)])
def test_kkt_solve_kernel_matches_plain(device, B, m, n):
    args = _kkt_args(device, B, m, n)
    before = fk.fused_kkt_solve.launches[torch.float32]
    routes = fk.fused_kkt_solve.routes.copy()
    dx = fk.fused_kkt_solve(*args)
    ref = fk.reference_kkt_solve(*args)
    assert fk.fused_kkt_solve.launches[torch.float32] == before + 1
    route = fk.kernel_route("kkt_solve", n)
    assert fk.fused_kkt_solve.routes[route] == routes[route] + 1
    assert dx.is_cuda and dx.dtype == torch.float32 and dx.shape == (B, n)
    assert _rel(dx, ref) <= 1e-4
    # float64 inputs are cast, not refused
    # (and a second call gives the same bits)
    dx64 = fk.fused_kkt_solve(*[a.double() for a in args])
    assert dx64.dtype == torch.float32 and torch.equal(dx64, dx)


@pytest.mark.parametrize("B,n", [(8, 100), (5, 37), (2, 239), (4, 128),
                                 (4, 129), (3, 1), (2, 240), (2, 256),
                                 (2, 300), (2, 512)])
def test_chol_solve_kernel_matches_plain_and_the_fused_solve(device, B, n):
    Q, A, w, sigma, rhs = _kkt_args(device, B, n + n // 2, n)
    K = ff.fused_formation(A, w, Q, sigma)
    d = torch.diagonal(K, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(d)
    eye = torch.eye(n, device=device)
    Khat = (K * dinv[:, :, None] * dinv[:, None, :]
            + fk._static_reg32() * eye).contiguous()
    before = fk.chol_solve_stacked.launches[torch.float32]
    x = fk.chol_solve_stacked(Khat, rhs * dinv)
    assert fk.chol_solve_stacked.launches[torch.float32] == before + 1
    assert _rel(x, fk.reference_chol_solve(Khat, rhs * dinv)) <= 1e-4
    assert torch.equal(x, fk.chol_solve_stacked(Khat, rhs * dinv))
    assert _rel(x * dinv, fk.fused_kkt_solve(Q, A, w, sigma, rhs)) <= 1e-4


@pytest.mark.parametrize("n", [40, 240])
def test_kkt_kernels_keep_failures_in_their_problem(device, n):
    Q, A, w, sigma, rhs = _kkt_args(device, 6, 60, n)
    good = fk.fused_kkt_solve(Q, A, w, sigma, rhs)
    Q = Q.clone()
    Q[1] = -Q[1] - 10.0 * torch.eye(n, device=device)      # indefinite
    Q[4, 7, 7] = float("nan")                             # a NaN pivot
    rhs = rhs.clone()
    rhs[2, 3] = float("nan")
    dx = fk.fused_kkt_solve(Q, A, w, sigma, rhs)
    ref = fk.reference_kkt_solve(Q, A, w, sigma, rhs)
    finite = torch.isfinite(dx).all(dim=1)
    assert torch.equal(finite, torch.isfinite(ref).all(dim=1))
    assert finite.tolist() == [True, False, False, True, False, True] or \
        finite.tolist() == [True, True, False, True, False, True]
    keep = [0, 3, 5]
    assert torch.equal(dx[keep], good[keep])


def test_kkt_kernels_take_the_global_route_above_the_shared_limit(device):
    """The shared-memory route's limits are the kernels' own; one past
    them both kernels solve through global memory, counted by route."""
    assert {name: kernels.shared_max_n(name) for name in kernels.SHARED_MAX_N} \
        == kernels.SHARED_MAX_N == {"kkt_solve": 220, "chol_solve": 239}
    before = (fk.fused_kkt_solve.routes["global"],
              fk.chol_solve_stacked.routes["global"])
    args = _kkt_args(device, 1, 8, 221)
    dx = fk.fused_kkt_solve(*args)
    x = fk.chol_solve_stacked(torch.eye(240, device=device)[None],
                              torch.ones(1, 240, device=device))
    assert torch.isfinite(dx).all() and torch.equal(x, torch.ones_like(x))
    assert (fk.fused_kkt_solve.routes["global"],
            fk.chol_solve_stacked.routes["global"]) == (before[0] + 1,
                                                        before[1] + 1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m", [50_000, 100_000])
def test_formation_splits_the_rows_of_a_tall_problem(device, dtype, tol, m):
    """Kernel 1 at the row-sharded shapes (B=1, n=200): the rows split over
    blocks (counted), within the tolerance of max|K| of the plain version,
    and the same bits on a second call; the bench shape is not split."""
    rng = np.random.default_rng(m)
    n = 200
    A, w = rng.standard_normal((1, m, n)), rng.random((1, m))
    Mx = rng.standard_normal((1, n, n))
    args = [torch.as_tensor(a, dtype=dtype, device=device)
            for a in (A, w, Mx @ Mx.transpose(0, 2, 1) / n, rng.random(1))]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    assert ff.formation_splits(1, m, n, sms) > 1
    assert ff.formation_splits(256, 150, 100, sms) == 1
    before = ff.fused_formation.split_launches[dtype]
    K = ff.fused_formation(*args)
    assert ff.fused_formation.split_launches[dtype] == before + 1
    ref = ff.reference_formation(*args)
    assert ((K - ref).abs().max() / ref.abs().max()).item() <= tol
    assert torch.equal(K, ff.fused_formation(*args))


def test_pallas_kkt_solve_on_card_matches_cpu(device):
    rng = np.random.default_rng(5)
    B, n, m = 6, 30, 45
    Mx = rng.standard_normal((B, n, n))
    d = dict(Q=np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
             q=rng.standard_normal((B, n)), A=rng.standard_normal((B, m, n)),
             l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))
    settings = pt.Settings(kkt_dtype="float32", mu_min=1e-7, refine_steps=2,
                           pallas_kkt=True, pallas_residuals=True)
    before = fk.fused_kkt_solve.launches[torch.float32]
    res = {dev: pt.solve_batch(pt.Problem(**{
        k: torch.as_tensor(v, device=dev) for k, v in d.items()}),
        settings, compact=True) for dev in (device, torch.device("cpu"))}
    card, cpu = res[device], res[torch.device("cpu")]
    assert fk.fused_kkt_solve.launches[torch.float32] > before
    assert card.x.is_cuda
    assert torch.all(card.info.status_val == pt.SOLVED)
    assert torch.all(cpu.info.status_val == pt.SOLVED)
    diff = (card.info.iterations.cpu() - cpu.info.iterations).abs().max()
    assert int(diff) <= 5
    np.testing.assert_allclose(card.x.cpu().numpy(), cpu.x.numpy(), atol=1e-5)


def test_qpdo_defaults_to_the_card(device):
    rng = np.random.default_rng(6)
    n, m = 20, 30
    Mx = rng.standard_normal((n, n))
    Q = Mx @ Mx.T / n + 0.1 * np.eye(n)
    q, A = rng.standard_normal(n), rng.standard_normal((m, n))
    l, u = -rng.random(m), rng.random(m)
    assert pt.make_problem(Q, q, A, l, u).Q.is_cuda
    s = pt.QPDO()
    s.setup(Q, q, A, l, u)
    res = s.solve()
    assert res.x.is_cuda and res.info.status == ["solved"]
    s.warm_start(res.x, res.y)
    s.update_q(1.05 * q)
    s.update_bounds(l - 0.1, u + 0.1)
    res2 = s.solve()
    assert res2.info.status == ["solved"]
    assert int(res2.info.iterations) < int(res.info.iterations)
    cpu = pt.QPDO()
    cpu.setup(Q, q, A, l, u, device="cpu")
    ref = cpu.solve()
    assert int(ref.info.iterations) == int(res.info.iterations)
    np.testing.assert_allclose(res.x.cpu().numpy(), ref.x.numpy(), atol=1e-8)
