"""The PyTorch port's CUDA kernels on the card (marker ``cuda``).

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX, so they also run where JAX is not installed, without the suite's
conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda*.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (formation: 1e-5 f32 / 1e-12 f64 relative to max|K|; residuals:
bit for bit), and a small batch
solved on the card must agree with the same solve on the CPU.  The two KKT
kernels are held in tests/test_torch_cuda_kkt.py.
"""

import numpy as np
import pytest
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.ops import fused_formation as ff
from qpdo_tpu_torch.ops import fused_residuals as fr

pytestmark = pytest.mark.cuda

DTYPES = [(torch.float32, 1e-5, 1e-6), (torch.float64, 1e-12, 1e-13)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _formation_args(device, dtype, B=8, m=150, n=100, seed=0):
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((B, n, n))
    arrays = (rng.standard_normal((B, m, n)), rng.random((B, m)),
              np.einsum("bij,bkj->bik", Mx, Mx) / n, rng.random(B) * 0.1)
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


@pytest.mark.parametrize("dtype,ftol,rtol", DTYPES)
def test_formation_kernel_matches_plain(device, dtype, ftol, rtol):
    args = _formation_args(device, dtype)
    before = ff.fused_formation.launches[dtype]
    K = ff.fused_formation(*args)
    ref = ff.reference_formation(*args)
    assert ff.fused_formation.launches[dtype] == before + 1
    assert K.is_cuda and K.dtype == dtype
    assert ((K - ref).abs().max() / ref.abs().max()).item() <= ftol


@pytest.mark.parametrize("dtype,ftol,rtol", DTYPES)
@pytest.mark.parametrize("B,m,n", [(3, 37, 19), (5, 70, 100), (2, 9, 140),
                                   (2, 40, 300), (4, 0, 20)])
def test_formation_kernel_mirrors_with_a_nonsymmetric_q(device, dtype, ftol,
                                                        rtol, B, m, n):
    """Only the tiles on or above the diagonal are computed: the mirror
    must carry Q at its own position, at ragged shapes, over several
    128-wide tiles, and for n that 16-byte copies cannot take."""
    rng = np.random.default_rng(n)
    arrays = (rng.standard_normal((B, m, n)), rng.random((B, m)),
              rng.standard_normal((B, n, n)), rng.random(B) * 0.1)
    args = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
    K = ff.fused_formation(*args)
    ref = ff.reference_formation(*args)
    assert torch.isfinite(K).all()
    assert ((K - ref).abs().max() / ref.abs().max()).item() <= ftol
    # two calls give the same bits (no atomics, a fixed summation order)
    assert torch.equal(K, ff.fused_formation(*args))
    # a view that starts off the 16-byte grid takes the unaligned copies
    if m > 0:
        flat = torch.empty(args[0].numel() + 1, dtype=dtype, device=device)
        A1 = flat[1:].view(B, m, n)
        A1.copy_(args[0])
        K1 = ff.fused_formation(A1, *args[1:])
        assert ((K1 - ref).abs().max() / ref.abs().max()).item() <= ftol


_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.mark.parametrize("dtype,ftol,rtol", DTYPES)
@pytest.mark.parametrize("B,m,n", [(8, 150, 100), (1, 150, 100),
                                   (5, 37, 19), (3, 23, 301),
                                   (4096, 150, 100)])
def test_residual_kernel_matches_plain(device, dtype, ftol, rtol, B, m, n):
    """Bit for bit (the kernel rounds each operation as the plain version
    does, in the same order): one problem, ragged m and n (one entry a
    load, more entries than 256 threads take at once) and a batch large
    enough that the grid strides over groups of problems; also into
    buffers handed in, as the solver loop does."""
    rng = np.random.default_rng(B + m)
    E = rng.random((B, m)) + 0.5
    d = lambda *s: rng.standard_normal(s)
    arrays = (d(B, m), d(B, m), rng.random((B, m)) + 0.1, d(B, m),
              -(rng.random((B, m)) + 0.2), rng.random((B, m)) + 0.2, E,
              1.0 / E, d(B, n), d(B, n), d(B, n), d(B, n), d(B, n),
              rng.random((B, n)) + 0.5, rng.random(B) * 0.1,
              rng.random(B) + 0.5)
    args = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
    before = fr.fused_residuals.launches[dtype]
    out = fr.fused_residuals(*args)
    ref = fr.reference_residuals(*args)
    assert fr.fused_residuals.launches[dtype] == before + 1
    buffers = fr.kernel_outputs(B, m, n, dtype, device)
    into = fr.fused_residuals(*args, out=buffers)
    assert all(a is b for a, b in zip(into, buffers[1]))
    for a, c, b in zip(out, into, ref):
        assert a.is_cuda and a.is_contiguous() and a.shape == b.shape
        assert torch.equal(a.view(_BITS[dtype]), b.view(_BITS[dtype]))
        assert torch.equal(c.view(_BITS[dtype]), b.view(_BITS[dtype]))
    # a non-contiguous argument is refused, not read with the wrong strides
    args[11] = torch.zeros((B, 2 * n), dtype=dtype, device=device)[:, ::2]
    with pytest.raises(ValueError, match="x must be contiguous"):
        fr.fused_residuals(*args)


def test_residual_norms_propagate_nan_per_problem(device):
    B, m, n = 3, 40, 30
    args = [torch.ones(B, m, device=device, dtype=torch.float64)
            for _ in range(8)]
    args += [torch.ones(B, n, device=device, dtype=torch.float64)
             for _ in range(6)]
    args += [torch.ones(B, device=device, dtype=torch.float64)
             for _ in range(2)]
    args[0] = args[0].clone()
    args[0][1, 7] = float("nan")
    rp = fr.fused_residuals(*args)[5]
    assert torch.isnan(rp[1]) and torch.isfinite(rp[[0, 2]]).all()


def test_small_batch_on_card_matches_cpu(device):
    rng = np.random.default_rng(2)
    B, n, m = 8, 30, 45
    Mx = rng.standard_normal((B, n, n))
    d = dict(Q=np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
             q=rng.standard_normal((B, n)), A=rng.standard_normal((B, m, n)),
             l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))
    settings = pt.Settings(kkt_solver="ns", kkt_ns_steps=5,
                           kkt_inv_refresh=False, pallas_formation=True,
                           pallas_residuals=True)
    res = {dev: pt.solve_batch(pt.Problem(**{
        k: torch.as_tensor(v, device=dev) for k, v in d.items()}),
        settings, compact=True) for dev in (device, torch.device("cpu"))}
    card, cpu = res[device], res[torch.device("cpu")]
    assert card.x.is_cuda
    assert torch.equal(card.info.status_val.cpu(), cpu.info.status_val)
    assert torch.all(cpu.info.status_val == pt.SOLVED)
    np.testing.assert_array_equal(card.info.iterations.cpu().numpy(),
                                  cpu.info.iterations.numpy())
    np.testing.assert_allclose(card.x.cpu().numpy(), cpu.x.numpy(), atol=1e-8)
