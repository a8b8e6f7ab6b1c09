"""The residual kernel's CUDA source (``csrc/residuals.cu``), built with g++
against the stub runtime of tests/torch_cuda_stub and run on the CPU.

The kernel rounds every operation as the plain PyTorch version does, in the
same order, so it is held to ``reference_residuals`` bit for bit, in float32
and float64: the four dual outputs, res_dual_in and the four norms, with
``active`` equal.  The output is the buffer of
``fused_residuals.kernel_outputs`` (the layout the wrapper hands the kernel
on the card), filled with NaN first, so an entry the kernel never writes
shows.  The shapes reach each load width (16 bytes, 8 bytes, one entry),
ragged m and n on either side of each other, groups of 32 to 256 threads a
problem, and a B that leaves the last group of problems short while the
grid strides (the stub has 2 SMs).  Skipped where g++ is missing.
"""

import numpy as np
import pytest
import torch

from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_residuals as fr
from test_torch_kernel_emulation import build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DTYPES = (torch.float32, torch.float64)
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated_residuals"),
                 ("residuals.cu",))


def _inputs(B, m, n, dtype, seed):
    rng = np.random.default_rng(seed)
    d = lambda *s: rng.standard_normal(s)
    E = rng.random((B, m)) + 0.5
    arrays = (d(B, m), d(B, m), rng.random((B, m)) + 0.1, d(B, m),
              -(rng.random((B, m)) + 0.2), rng.random((B, m)) + 0.2, E,
              1.0 / E, d(B, n), d(B, n), d(B, n), d(B, n), d(B, n),
              rng.random((B, n)) + 0.5, rng.random(B) * 0.1,
              rng.random(B) + 0.5)
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _emulated(lib, args):
    B, m = args[0].shape
    n = args[8].shape[1]
    out, outputs = fr.kernel_outputs(B, m, n, args[0].dtype, "cpu")
    out.fill_(float("nan"))
    fn = getattr(lib, f"qpdo_residuals_{kernels._SUFFIX[args[0].dtype]}")
    err = fn(*[t.data_ptr() for t in (*args, out)], B, m, n, None)
    assert err == 0
    return outputs


def _assert_bitwise(out, ref):
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.is_contiguous()
        assert torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,m,n", [
    (3, 150, 100),     # the bench widths: 8-byte loads in float32, 16 in float64
    (2, 48, 36),       # rows of 16 bytes in float32 too
    (5, 37, 19),       # ragged: one entry a load
    (70, 20, 9),       # 32 threads a problem, 8 problems a block, grid strides
])
def test_residual_source_is_bitwise_the_plain_version(lib, dtype, B, m, n):
    args = _inputs(B, m, n, dtype, seed=B + m)
    _assert_bitwise(_emulated(lib, args), fr.reference_residuals(*args))


def test_residual_source_with_n_above_m_and_many_units(lib):
    """n > m, and more entries than 256 threads take in one pass."""
    args = _inputs(3, 23, 301, torch.float64, seed=5)
    _assert_bitwise(_emulated(lib, args), fr.reference_residuals(*args))


def test_residual_source_nan_stays_in_its_problem(lib):
    """A NaN in one problem's Ax and another's Dinv reaches those problems'
    norms only; every other entry is bit-identical to the clean run."""
    args = _inputs(5, 37, 19, torch.float32, seed=8)
    clean = _emulated(lib, args)
    args[0] = args[0].clone()
    args[0][1, 30] = float("nan")
    args[13] = args[13].clone()
    args[13][3, 2] = float("nan")
    out = _emulated(lib, args)
    ref = fr.reference_residuals(*args)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    rp, rd, rpi, rdi = out[5:]
    assert torch.isnan(rp[1]) and torch.isnan(rpi[1])
    assert torch.isnan(rd[3]) and torch.isnan(rdi[3])
    others = [0, 2, 4]
    for a, b in zip(out[5:], clean[5:]):
        assert torch.equal(a[others], b[others])
    assert torch.isfinite(torch.stack([rd[1], rdi[1], rp[3], rpi[3]])).all()


def test_residual_source_off_the_16_byte_grid(lib):
    """Inputs that start 4 bytes past a 16-byte boundary take a narrower
    load and give the same bits."""
    args = _inputs(4, 48, 36, torch.float32, seed=2)
    ref = fr.reference_residuals(*args)
    shifted = []
    for t in args[:14]:
        flat = torch.empty(t.numel() + 1, dtype=t.dtype)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        shifted.append(view)
    _assert_bitwise(_emulated(lib, shifted + args[14:]), ref)
