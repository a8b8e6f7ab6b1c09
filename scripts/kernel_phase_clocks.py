#!/usr/bin/env python3
"""Where the cycles of the fused KKT-solve kernel and of the formation
kernel go, phase by phase, on one NVIDIA GPU (which has no profiler at
hand: this stands in for one).

    python3 scripts/kernel_phase_clocks.py

The marks live in the sources behind ``-DQPDO_PHASE_CLOCKS``
(qpdo_tpu_torch/csrc/phase_clocks.cuh: empty macros otherwise).  The script
builds kkt_solve.cu and formation.cu with that macro into
build/kernel_phase_clocks/, runs each kernel at the bench shape (B=256,
m=150, n=100, float32) and with one block alone (B=1), and prints the cycles
that thread 0 of block 0 took between the marks, with the SM clock.  The
marked kernels compute the same values; their times are not those of the
shipped kernels (the marks cost a few cycles each and hold instructions in
place).
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

WORK = REPO / "build" / "kernel_phase_clocks"
SLOTS = 16                     # kPhaseClocks of csrc/phase_clocks.cuh

KKT_PHASES = ("prologue (Q into registers, first stage of A)",
              "formation loop", "Jacobi scale", "factor", "scaling pass",
              "back-substitution", "last barrier")
FORMATION_PHASES = ("prologue", "waiting for cp.async", "barriers",
                    "issuing the next stage", "multiplication",
                    "epilogue (thread 0: a micro-tile on the diagonal)")


def marked_library(name: str) -> ctypes.CDLL:
    """One source built alone with the marks compiled in."""
    WORK.mkdir(parents=True, exist_ok=True)
    out = WORK / f"lib{Path(name).stem}_clocks.so"
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-DQPDO_PHASE_CLOCKS",
           "-shared", "-o", str(out), str(kernels.CSRC / name)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    return ctypes.CDLL(str(out))


def read_clocks(reader):
    buf = (ctypes.c_longlong * SLOTS)()
    err = reader(ctypes.c_void_p(ctypes.addressof(buf)))
    if err:
        raise RuntimeError(f"cudaMemcpyFromSymbol: CUDA error {err}")
    return list(buf)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phase_clocks: needs a CUDA device", file=sys.stderr)
        return 2
    kkt = marked_library("kkt_solve.cu")
    form = marked_library("formation.cu")
    ptr, i = ctypes.c_void_p, ctypes.c_int
    kkt.qpdo_kkt_solve_f32.argtypes = [ptr] * 6 + [i] * 3 + [ptr]
    form.qpdo_formation_f32.argtypes = [ptr] * 6 + [i] * 4 + [ptr]
    print(smi("name,power.limit"))
    M, N = 150, 100
    for B in (1, 256):
        rng = np.random.default_rng(6)
        Mx = rng.standard_normal((B, N, N))
        arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / N + 0.1 * np.eye(N),
                  rng.standard_normal((B, M, N)), rng.random((B, M)),
                  np.full(B, 1e-3), rng.standard_normal((B, N)))
        Q, A, w, sigma, rhs = [
            torch.as_tensor(a, dtype=torch.float32, device="cuda:0")
            for a in arrays]
        dx, K = torch.empty_like(rhs), torch.empty_like(Q)
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):          # the last of three runs is printed
            err = kkt.qpdo_kkt_solve_f32(
                Q.data_ptr(), A.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                rhs.data_ptr(), dx.data_ptr(), B, M, N, stream)
            torch.cuda.synchronize()
            t = read_clocks(kkt.qpdo_kkt_phase_clocks)
        assert err == 0 and torch.isfinite(dx).all()
        print(f"kkt_solve, block 0 of {B}, n={N}, m={M}: "
              + "; ".join(f"{name} {t[k + 1] - t[k]}"
                          for k, name in enumerate(KKT_PHASES))
              + f"; total {t[7] - t[0]} cycles at SM clock {smi('clocks.sm')}")
        for _ in range(3):
            err = form.qpdo_formation_f32(
                A.data_ptr(), w.data_ptr(), Q.data_ptr(), sigma.data_ptr(),
                K.data_ptr(), None, B, M, N, 1, stream)
            torch.cuda.synchronize()
            t = read_clocks(form.qpdo_formation_phase_clocks)
        assert err == 0 and torch.isfinite(K).all()
        print(f"formation, block 0 of {B}: "
              + "; ".join(f"{name} {t[k]}"
                          for k, name in enumerate(FORMATION_PHASES))
              + f"; total {sum(t[:len(FORMATION_PHASES)])} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
