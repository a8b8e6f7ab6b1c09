"""The three TF32 passes of the cluster route's trailing update
(``csrc/tf32x3.cuh``, used by ``csrc/kkt_solve_cluster.cu``), on the CPU.

The header's ``QPDO_CUDA_STUB`` branch stands in for the tensor cores: the
split rounds as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, on the 13 low bits of the significand) and ``mma_tf32`` gathers the
fragments of ``mma.sync`` m16n8k8 .tf32 through the warp's exchange slots
and sums each output in k order in float32.  These tests hold that branch
to a numpy model of the same rounding bit for bit, the split to its
2^-22 bound, the route's two entry points (built with g++ as in
tests/test_torch_kkt_cluster_emulation.py) to the plain versions and to
the JAX package's kernel, and record, on phase 6b's n = 512 input, why
three passes are needed: a numpy model of the factor with the trailing
update in three passes stays within the 2e-5 contract of the plain float32
solve, in one pass it does not.  The card's tensor cores sum a fragment in
another order (``scripts/mma_tf32_probe.cu``); tests/test_torch_cuda_kkt.py
holds them to the plain version there.  Skipped where g++ is missing (but
the model's own test).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpdo_tpu.ops import pallas_kkt as jkkt
from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_kkt as fk
from test_torch_kernel_emulation import STUB, _kkt_args, _rel, _scaled, rewrite
from test_torch_kkt_cluster_emulation import _chol, _kkt
from test_torch_kkt_cluster_emulation import lib  # noqa: F401  (fixture)
from test_torch_kkt_cluster_emulation import emulated_library  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5

# one fragment product and the split, as the kernels call them
_PROBE = r"""
#include <cuda_runtime.h>
#include "tf32x3.cuh"

// D (16 x 8) += A (16 x 8) B (8 x 8), row-major: one pass on the raw
// operands (passes == 1) or three on their splits
__global__ void fragment_kernel(const float* A, const float* B, float* D,
                                int passes) {
  const int lane = threadIdx.x, gid = lane >> 2, tig = lane & 3;
  float a[4], b[2], d[4];
  for (int q = 0; q < 4; ++q) a[q] = A[(gid + 8 * (q & 1)) * 8 + tig + 4 * (q >> 1)];
  for (int q = 0; q < 2; ++q) b[q] = B[(tig + 4 * q) * 8 + gid];
  for (int c = 0; c < 4; ++c) d[c] = D[(gid + 8 * (c >> 1)) * 8 + 2 * tig + (c & 1)];
  if (passes == 1) {
    mma_tf32(d, a, b);
  } else {
    // as the route sums a tile: from 0, then added to the accumulator once
    float ahi[4], alo[4], bhi[2], blo[2], upd[4] = {};
    for (int q = 0; q < 4; ++q) split_tf32(a[q], ahi[q], alo[q]);
    for (int q = 0; q < 2; ++q) split_tf32(b[q], bhi[q], blo[q]);
    mma_tf32x3(upd, ahi, alo, bhi, blo);
    for (int c = 0; c < 4; ++c) d[c] = d[c] + upd[c];
  }
  for (int c = 0; c < 4; ++c) D[(gid + 8 * (c >> 1)) * 8 + 2 * tig + (c & 1)] = d[c];
}

__global__ void split_kernel(const float* x, float* hi, float* lo, int n) {
  for (int i = threadIdx.x; i < n; i += 32) split_tf32(x[i], hi[i], lo[i]);
}

extern "C" int fragment(const void* A, const void* B, void* D, int passes) {
  fragment_kernel<<<1, 32, 0, nullptr>>>(static_cast<const float*>(A),
      static_cast<const float*>(B), static_cast<float*>(D), passes);
  return 0;
}

extern "C" int split(const void* x, void* hi, void* lo, int n) {
  split_kernel<<<1, 32, 0, nullptr>>>(static_cast<const float*>(x),
      static_cast<float*>(hi), static_cast<float*>(lo), n);
  return 0;
}
"""


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA sources for the CPU")
    tmp = tmp_path_factory.mktemp("emulated_tf32")
    src = tmp / "probe.cpp"
    src.write_text(rewrite(_PROBE))
    so = tmp / "libprobe.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-pthread", f"-I{STUB}", f"-I{kernels.CSRC}", "-o", str(so),
           str(STUB / "stub_runtime.cpp"), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.fragment.argtypes = [ptr] * 3 + [i]
    lib.split.argtypes = [ptr] * 3 + [i]
    return lib


def tf32(x):
    """cvt.rna.tf32.f32 in numpy: float32 rounded to nearest, ties away
    from zero, on the 13 low significand bits (inf and NaN as they are)."""
    u = np.asarray(x, np.float32).view(np.uint32)
    special = (u & 0x7F800000) == 0x7F800000
    out = np.where((u & 0x1FFF) >= 0x1000, (u & ~np.uint32(0x1FFF)) + 0x2000,
                   u & ~np.uint32(0x1FFF)).astype(np.uint32)
    return np.where(special, u, out).view(np.float32)


def truncated(x):
    """The 19 high bits of a float32, as the card reads a .tf32 operand."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return (u & ~np.uint32(0x1FFF)).view(np.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(np.float32(x) - hi)


def model_pass(D, A, B):
    """One m16n8k8 pass as the stand-in sums it: each output from the
    accumulator, then the eight products (exact: TF32 times TF32) in k
    order, each sum rounded to float32."""
    out = D.copy()
    for i in range(16):
        for j in range(8):
            s = out[i, j]
            for k in range(8):
                s = np.float32(s + np.float32(A[i, k] * B[k, j]))
            out[i, j] = s
    return out


@pytest.mark.parametrize("passes", [1, 3])
def test_a_fragment_product_matches_its_numpy_model_bit_for_bit(probe, passes):
    rng = np.random.default_rng(passes)
    A = rng.standard_normal((16, 8)).astype(np.float32)
    B = rng.standard_normal((8, 8)).astype(np.float32)
    D0 = rng.standard_normal((16, 8)).astype(np.float32)
    D = D0.copy()
    assert probe.fragment(A.ctypes.data, B.ctypes.data, D.ctypes.data,
                          passes) == 0
    if passes == 1:
        want = model_pass(D0, truncated(A), truncated(B))
    else:
        (ahi, alo), (bhi, blo) = split(A), split(B)
        upd = model_pass(np.zeros_like(D0), alo, bhi)
        want = D0 + model_pass(model_pass(upd, ahi, blo), ahi, bhi)
    assert np.array_equal(D.view(np.uint32), want.view(np.uint32))
    exact = D0.astype(np.float64) + A.astype(np.float64) @ B
    scale = np.abs(D0) + np.abs(A) @ np.abs(B)
    err = (np.abs(D - exact) / scale).max()
    assert err <= (1e-6 if passes == 3 else 2e-2) and (passes == 3 or err > 1e-5)


def test_the_split_reconstructs_float32_to_2_to_the_minus_22(probe):
    """hi and lo are TF32 (13 low bits 0), hi is cvt.rna's rounding (ties
    included, bit for bit against the numpy model), and hi + lo holds x to
    within 2^-22 |x|."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000) * np.exp2(rng.integers(-60, 60, 4000)),
        # ties of the 13 dropped bits, both signs, and a carry into the
        # next binade
        np.array([0x3F801000, 0xBF801000, 0x3F803000, 0x3F7FF000,
                  0x3F7FFFFF], np.uint32).view(np.float32),
    ]).astype(np.float32)
    hi, lo = np.empty_like(x), np.empty_like(x)
    assert probe.split(x.ctypes.data, hi.ctypes.data, lo.ctypes.data,
                       x.size) == 0
    want_hi, want_lo = split(x)
    assert np.array_equal(hi.view(np.uint32), want_hi.view(np.uint32))
    assert np.array_equal(lo.view(np.uint32), want_lo.view(np.uint32))
    assert not ((hi.view(np.uint32) | lo.view(np.uint32)) & 0x1FFF).any()
    assert hi[-5:].view(np.uint32).tolist() == [0x3F802000, 0xBF802000,
                                                0x3F804000, 0x3F800000,
                                                0x3F800000]
    rel = np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22


@pytest.mark.parametrize("cluster,n", [(2, 100), (4, 140)],
                         ids=["c2_n100", "c4_n140"])
def test_both_entry_points_on_the_tensor_core_update(lib, cluster, n):  # noqa: F811
    """n = 100 on 2 blocks (4 panels, 13 column tiles of 8 in the widest
    update) and n = 140 on 4 (5 panels, the last 12 rows): within 2e-5 of
    max|dx| of the plain versions, and the same bits from a second call."""
    Q, A, w, sigma, rhs = _kkt_args(1, 3 * n // 2, n, seed=n + 1)
    dx = _kkt(lib, cluster, Q, A, w, sigma, rhs)
    assert _rel(dx, fk.reference_kkt_solve(Q, A, w, sigma, rhs)) <= TOL
    assert torch.equal(dx, _kkt(lib, cluster, Q, A, w, sigma, rhs))
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, cluster, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= TOL
    assert torch.equal(x, _chol(lib, cluster, Khat, bhat))


def test_the_cluster_source_matches_the_jax_kernel(lib):  # noqa: F811
    """One Newton system of n = 100 through the cluster source's fused
    solve (2 blocks) and the JAX package's Pallas kernel in interpret mode,
    within 5e-6 relative to max(1, max|dx|), the bound of
    tests/test_torch_kkt_routes_emulation.py for the global route."""
    B, n, m = 1, 100, 150
    rng = np.random.default_rng(n)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    args = ((np.einsum("bij,bkj->bik", M, M) / n
             + 0.1 * np.eye(n)).astype(np.float32),
            rng.standard_normal((B, m, n)).astype(np.float32),
            (rng.random((B, m)) * 10.0).astype(np.float32),
            np.full(B, 1e-3, np.float32),
            rng.standard_normal((B, n)).astype(np.float32))
    dx = _kkt(lib, 2, *[torch.from_numpy(a) for a in args]).numpy()
    jdx = np.asarray(jkkt.fused_kkt_solve(*[jnp.asarray(a) for a in args],
                                          interpret=True))
    err = np.abs(dx - jdx).max() / max(1.0, np.abs(jdx).max())
    assert err <= 5e-6


def _blocked_chol_solve(K, b, passes):
    """The route's factor in numpy float32: panels of 32 rows, each
    diagonal block and strip as the plain recurrence, the trailing update
    in ``passes`` TF32 passes (3: lo hi + hi lo + hi hi; 1: hi hi) summed
    in float32; then R'z = b and R x = z."""
    n = K.shape[0]
    R = np.triu(K).astype(np.float32)
    for k0 in range(0, n, 32):
        k1 = min(k0 + 32, n)
        for p in range(k0, k1):                      # the diagonal block
            R[p, p:] /= np.sqrt(R[p, p])
            R[p + 1:k1, p + 1:] -= np.outer(R[p, p + 1:k1], R[p, p + 1:])
        X = R[k0:k1, k1:]                            # panel k's strip
        hi, lo = split(X)
        upd = hi.T @ hi
        if passes == 3:
            upd = (lo.T @ hi + hi.T @ lo) + upd
        R[k1:, k1:] -= np.triu(upd.astype(np.float32))
    z = np.zeros(n, np.float32)
    for j in range(n):
        z[j] = (b[j] - R[:j, j] @ z[:j]) / R[j, j]
    x = np.zeros(n, np.float32)
    for j in range(n - 1, -1, -1):
        x[j] = (z[j] - R[j, j + 1:] @ x[j + 1:]) / R[j, j]
    return x


def test_three_passes_keep_the_contract_one_pass_breaks_it():
    """Phase 6b's (1, 768, 512) input (chip_smoke.kkt_inputs, seed 512),
    Jacobi-scaled and shifted: the numpy model of the factor with its
    trailing update in three TF32 passes is within 2e-5 of max|dx| of the
    plain float32 solve; with one pass (TF32 alone) it is not."""
    b, m, n = 1, 768, 512
    rng = np.random.default_rng(n)
    Mx = rng.standard_normal((b, n, n))
    Q, A, w, sigma, rhs = [torch.as_tensor(a, dtype=torch.float32) for a in (
        np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
        rng.standard_normal((b, m, n)), rng.random((b, m)), np.full(b, 1e-3),
        rng.standard_normal((b, n)))]
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    plain = fk.reference_chol_solve(Khat, bhat)[0].numpy()
    K, rb = Khat[0].numpy(), bhat[0].numpy()
    errs = {p: np.abs(_blocked_chol_solve(K, rb, p) - plain).max()
            / np.abs(plain).max() for p in (1, 3)}
    assert errs[3] <= TOL < errs[1]


def test_the_update_is_on_the_tensor_cores_in_three_passes():
    """The source's trailing update and diagonal-block update call the
    three-pass product and nothing calls a single pass; the header issues
    mma.sync m16n8k8 .tf32 on the card."""
    src = (kernels.CSRC / "kkt_solve_cluster.cu").read_text()
    header = (kernels.CSRC / "tf32x3.cuh").read_text()
    assert "tf32x3.cuh" in kernels.HEADERS
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert "cvt.rna.tf32.f32" in header
    calls = re.findall(r"\bmma_tf32(\w*)\(", src)
    assert calls and set(calls) == {"x3"}
    for fn in ("update_panel", "update_diagonal"):
        body = src[src.index(f"void {fn}("):]
        body = body[:body.index("\n}\n")]
        assert "mma_tf32x3(" in body
    # the helper issues the three passes: lo hi, hi lo and hi hi
    body = header[header.index("void mma_tf32x3("):]
    body = body[:body.index("\n}\n")]
    assert [m.groups() for m in re.finditer(r"mma_tf32\(d, (\w+), (\w+)\)",
                                            body)] == [
        ("alo", "bhi"), ("ahi", "blo"), ("ahi", "bhi")]
