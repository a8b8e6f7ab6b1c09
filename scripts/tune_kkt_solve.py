#!/usr/bin/env python3
"""Time the fused KKT-solve and Cholesky-solve kernels of qpdo_tpu_torch
for several block sizes and row blockings on one NVIDIA GPU.

    python3 scripts/tune_kkt_solve.py [threads:rows ...]

qpdo_tpu_torch/csrc/kkt_solve.cu takes its block size from the macro
QPDO_KKT_THREADS and the rows a warp updates per pass of the factor from
QPDO_KKT_ROWS.  This script builds one library per pair with nvcc
into build/tune_kkt_solve/, runs both kernels at the bench shape (B=256,
m=150, n=100, float32) on the same inputs, holds every variant's output
against the plain versions (1e-4 of max|dx|), and prints the mean time per
call over 200 back-to-back calls (CUDA events), the variants timed in
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
from qpdo_tpu_torch.ops import fused_kkt as fk  # noqa: E402

B, M, N = 256, 150, 100


DEFAULT_VARIANTS = ("256:1", "256:2", "256:4", "256:8", "128:4", "512:4",
                    "512:8", "1024:4")


def build(nvcc: str, variant: str) -> ctypes.CDLL:
    threads, rows = variant.split(":")
    out = REPO / "build" / "tune_kkt_solve" / f"libkkt_{threads}_{rows}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [nvcc, *kernels.NVCC_FLAGS, f"-DQPDO_KKT_THREADS={threads}",
           f"-DQPDO_KKT_ROWS={rows}", "-shared", "-o", str(out),
           str(kernels.CSRC / "kkt_solve.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line:
            print(f"  {variant}: {line.strip()}")
    lib = ctypes.CDLL(str(out))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.qpdo_kkt_solve_f32.argtypes = [ptr] * 6 + [i] * 3 + [ptr]
    lib.qpdo_chol_solve_f32.argtypes = [ptr] * 3 + [i] * 2 + [ptr]
    return lib


def time_ms(fn, reps=200, warmup=20):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_kkt_solve: needs a CUDA device", file=sys.stderr)
        return 2
    variants = sys.argv[1:] or list(DEFAULT_VARIANTS)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    dev = "cuda:0"
    rng = np.random.default_rng(6)
    Mx = rng.standard_normal((B, N, N))
    arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / N + 0.1 * np.eye(N),
              rng.standard_normal((B, M, N)), rng.random((B, M)),
              np.full(B, 1e-3), rng.standard_normal((B, N)))
    Q, A, w, sigma, rhs = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                           for a in arrays]
    K = torch.matmul(A.mT, w[..., None] * A) + Q
    d = torch.diagonal(K, dim1=-2, dim2=-1)
    dinv = torch.rsqrt(d)
    Khat = (K * dinv[:, :, None] * dinv[:, None, :]
            + fk._static_reg32() * torch.eye(N, device=dev)).contiguous()
    bhat = (rhs * dinv).contiguous()
    ref3 = fk.reference_kkt_solve(Q, A, w, sigma, rhs)
    ref4 = fk.reference_chol_solve(Khat, bhat)
    stream = torch.cuda.current_stream().cuda_stream
    nvcc = kernels.find_nvcc()
    calls = {}
    for t in variants:
        lib = build(nvcc, t)
        out3, out4 = torch.empty_like(rhs), torch.empty_like(rhs)

        def kkt(lib=lib, out=out3):
            err = lib.qpdo_kkt_solve_f32(
                Q.data_ptr(), A.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                rhs.data_ptr(), out.data_ptr(), B, M, N, stream)
            if err:
                raise RuntimeError(f"kkt_solve launch: CUDA error {err}")

        def chol(lib=lib, out=out4):
            err = lib.qpdo_chol_solve_f32(Khat.data_ptr(), bhat.data_ptr(),
                                          out.data_ptr(), B, N, stream)
            if err:
                raise RuntimeError(f"chol_solve launch: CUDA error {err}")

        kkt()
        chol()
        torch.cuda.synchronize()
        e3 = ((out3 - ref3).abs().max() / ref3.abs().max()).item()
        e4 = ((out4 - ref4).abs().max() / ref4.abs().max()).item()
        if not (e3 <= 1e-4 and e4 <= 1e-4):
            raise AssertionError(f"{t}: errors {e3:.2e}, {e4:.2e}")
        calls[t] = (kkt, chol, e3, e4)
    times = {t: ([], []) for t in variants}
    for order in (variants, variants[::-1]):
        for t in order:
            times[t][0].append(time_ms(calls[t][0]))
            times[t][1].append(time_ms(calls[t][1]))
    for t in variants:
        k3, k4 = times[t]
        print(f"{t:>7s} (threads:rows): kkt_solve {min(k3):.4f} ms {k3}, chol_solve "
              f"{min(k4):.4f} ms {k4}; errors {calls[t][2]:.2e}, "
              f"{calls[t][3]:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
