#!/usr/bin/env python3
"""Time the formation, fused KKT-solve and Cholesky-solve kernels of
qpdo_tpu_torch for several settings of their compile-time knobs on one
NVIDIA GPU.

    python3 scripts/tune_kkt_solve.py [MACRO=value[,MACRO=value...] ...]

The knobs of the register route of qpdo_tpu_torch/csrc/kkt_solve.cu
(n <= 128): QPDO_KKT_STAGE_ROWS (rows of A per shared stage) and
QPDO_KKT_UNROLL (rows of A per body of the formation loop).  Those of
csrc/formation.cu: QPDO_FORMATION_STAGES (at least 2) and
QPDO_FORMATION_STAGE_ROWS.  QPDO_KKT_THREADS and
QPDO_KKT_ROWS belong to the shared-memory route (128 < n): pass them with
``--shape B,m,n`` for such an n to time that route.

Each argument is one variant; "default" is the sources as they are.  The
script builds one library per variant with nvcc into build/tune_kkt_solve/,
runs the three kernels at the bench shape (B=256, m=150, n=100, float32) on
the same inputs, holds every variant's output against the plain versions
(1e-5 of max|K|, 1e-4 of max|dx|), and prints the time per call on the card
alone (replays of a CUDA graph of 100 launches), the variants timed in
turns, twice, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from qpdo_tpu_torch import kernels  # noqa: E402
from qpdo_tpu_torch.ops import fused_formation as ff  # noqa: E402
from qpdo_tpu_torch.ops import fused_kkt as fk  # noqa: E402

DEFAULT_VARIANTS = (
    "default",
    "QPDO_FORMATION_STAGES=3",
    "QPDO_FORMATION_STAGES=3,QPDO_FORMATION_STAGE_ROWS=16",
    "QPDO_KKT_STAGE_ROWS=8,QPDO_FORMATION_STAGE_ROWS=8",
    "QPDO_KKT_STAGE_ROWS=32,QPDO_FORMATION_STAGE_ROWS=16",
    "QPDO_KKT_UNROLL=1",
    "QPDO_KKT_UNROLL=2",
)


def build(nvcc: str, variant: str, index: int) -> ctypes.CDLL:
    defines = [] if variant == "default" else [f"-D{d}" for d in variant.split(",")]
    out = REPO / "build" / "tune_kkt_solve" / f"libtune_{index}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *kernels.NVCC_FLAGS, *defines, "-shared", "-o", str(out),
           str(kernels.CSRC / "kkt_solve.cu"), str(kernels.CSRC / "formation.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr[-4000:])
    spills = [l for l in (proc.stdout + proc.stderr).splitlines()
              if "spill" in l and "0 bytes spill stores, 0 bytes spill loads" not in l]
    print(f"  {variant}: built, {len(spills)} kernels with spills")
    lib = ctypes.CDLL(str(out))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.qpdo_kkt_solve_f32.argtypes = [ptr] * 6 + [i] * 3 + [ptr]
    lib.qpdo_chol_solve_f32.argtypes = [ptr] * 3 + [i] * 2 + [ptr]
    lib.qpdo_formation_f32.argtypes = [ptr] * 6 + [i] * 4 + [ptr]
    return lib


def device_ms(fn, calls=100, replays=5):
    """Time per call on the card alone: replays of a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(calls):
            fn(stream)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_kkt_solve: needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    B, M, N = 256, 150, 100
    if "--shape" in args:
        at = args.index("--shape")
        B, M, N = (int(v) for v in args[at + 1].split(","))
        del args[at:at + 2]
    variants = args or list(DEFAULT_VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    print(f"B={B} m={M} n={N} float32")
    dev = "cuda:0"
    rng = np.random.default_rng(6)
    Mx = rng.standard_normal((B, N, N))
    arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / N + 0.1 * np.eye(N),
              rng.standard_normal((B, M, N)), rng.random((B, M)),
              np.full(B, 1e-3), rng.standard_normal((B, N)))
    Q, A, w, sigma, rhs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                           for a in arrays]
    K = ff.reference_formation(A, w, Q, sigma)
    d = torch.diagonal(K, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(d)
    Khat = (K * dinv[:, :, None] * dinv[:, None, :]
            + fk._static_reg32() * torch.eye(N, device=dev)).contiguous()
    bhat = (rhs * dinv).contiguous()
    ref3 = fk.reference_kkt_solve(Q, A, w, sigma, rhs)
    ref4 = fk.reference_chol_solve(Khat, bhat)
    nvcc = kernels.find_nvcc()
    calls = {}
    for index, t in enumerate(variants):
        lib = build(nvcc, t, index)
        out1 = torch.empty_like(K)
        out3, out4 = torch.empty_like(rhs), torch.empty_like(rhs)

        def check(err, what):
            if err:
                raise RuntimeError(f"{what} launch: CUDA error {err}")

        def form(stream=None, lib=lib, out=out1):
            stream = stream or torch.cuda.current_stream().cuda_stream
            check(lib.qpdo_formation_f32(
                A.data_ptr(), w.data_ptr(), Q.data_ptr(), sigma.data_ptr(),
                out.data_ptr(), None, B, M, N, 1, stream), "formation")

        def kkt(stream=None, lib=lib, out=out3):
            stream = stream or torch.cuda.current_stream().cuda_stream
            check(lib.qpdo_kkt_solve_f32(
                Q.data_ptr(), A.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                rhs.data_ptr(), out.data_ptr(), B, M, N, stream), "kkt_solve")

        def chol(stream=None, lib=lib, out=out4):
            stream = stream or torch.cuda.current_stream().cuda_stream
            check(lib.qpdo_chol_solve_f32(Khat.data_ptr(), bhat.data_ptr(),
                                          out.data_ptr(), B, N, stream),
                  "chol_solve")

        form()
        kkt()
        chol()
        torch.cuda.synchronize()
        e1 = ((out1 - K).abs().max() / K.abs().max()).item()
        e3 = ((out3 - ref3).abs().max() / ref3.abs().max()).item()
        e4 = ((out4 - ref4).abs().max() / ref4.abs().max()).item()
        if not (e1 <= 1e-5 and e3 <= 1e-4 and e4 <= 1e-4):
            raise AssertionError(f"{t}: errors {e1:.2e}, {e3:.2e}, {e4:.2e}")
        calls[t] = (form, kkt, chol)
    times = {t: ([], [], []) for t in variants}
    for order in (variants, variants[::-1]):
        for t in order:
            for slot, fn in zip(times[t], calls[t]):
                slot.append(round(device_ms(fn), 5))
    for t in variants:
        k1, k3, k4 = times[t]
        print(f"{t}: formation {min(k1):.4f} ms {k1}, kkt_solve {min(k3):.4f} "
              f"ms {k3}, chol_solve {min(k4):.4f} ms {k4}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
