#!/usr/bin/env python3
"""Where the cycles of the fused KKT-solve kernel, of the formation
kernel and of the global-memory route of the two KKT kernels go, phase by
phase, on one NVIDIA GPU (which has no profiler at hand: this stands in
for one).

    python3 scripts/kernel_phase_clocks.py

The marks live in the sources behind ``-DQPDO_PHASE_CLOCKS``
(qpdo_tpu_torch/csrc/phase_clocks.cuh: empty macros otherwise).  The script
builds kkt_solve.cu and formation.cu with that macro into
build/kernel_phase_clocks/, runs each kernel at the bench shape (B=256,
m=150, n=100, float32) and with one block alone (B=1), and prints the cycles
that thread 0 of block 0 took between the marks, with the SM clock.  Then
it builds kkt_solve_large.cu (with formation.cu, which forms its K) and
runs both of its entry points at the shapes of chip_smoke.py's phase 6b
(``GLOBAL_SHAPES``), with the time of a call (CUDA events).  Last it
builds kkt_solve_cluster.cu (with formation.cu) and runs both of its entry
points at ``CLUSTER_SHAPES``: thread 0 of every block of problem 0's
cluster adds its spans into ``CLUSTER_PHASES`` (the owner of a panel its
owner-only phases), and the script prints them with their averages over
the cluster's blocks and per pivot; then, for the phases of a step
(``STEP_PHASES``), the maximum over the blocks at each step (the busiest
block is the critical path) and which block it was, and the sum of those
maxima.  The marked kernels compute the same values; their times are not
those of the shipped kernels (the marks cost a few cycles each and hold
instructions in place).

    python3 scripts/kernel_phase_clocks.py cluster

runs the cluster route alone.
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
# kkt_solve_large.cu: spans of thread 0 of block (0, 0) of each launch
# (problem 0: the panel kernel's first column range, the trailing update's
# first tile pair), summed over the panels
GLOBAL_PHASES = ("panel: loads (warp 0)", "panel: diagonal block (warp 0)",
                 "panel: the strip's end after the block's", "panel: stores",
                 "trailing: loads", "trailing: update and stores",
                 "back substitution")
# (B, m, n) of chip_smoke.py's LARGE_KKT_SHAPES
GLOBAL_SHAPES = ((8, 384, 256), (8, 768, 512), (64, 450, 300),
                 (1, 1536, 1024))
# kkt_solve_cluster.cu: spans of thread 0 of the blocks of problem 0's
# cluster, summed over the blocks named and the panels (slot, name, who)
CLUSTER_PHASES = (
    (0, "load", "block 0"),
    (1, "panel 0: factor, strip, two barriers", "block 0"),
    (2, "staging the row operands", "every block"),
    (3, "the diagonal block: its update and pivot chain", "the owner's warp 0"),
    (4, "the trailing update", "the other blocks"),
    (5, "the step's first cluster barrier", "every block"),
    (6, "the strip", "every block"),
    (7, "the step's second cluster barrier", "every block"),
    (8, "R x = z: a panel's solve and the next columns' loads", "every block"),
    (9, "R x = z: the cluster barriers", "every block"),
    (10, "R x = z: the sums", "every block"),
    (11, "the diagonal block's update", "the owner"),
    (12, "R x = z: a panel's operands", "its owner's warp 0"),
    (13, "R x = z: the 32-step chain", "its owner's warp 0"),
    (14, "the owner's update (warp 1)", "the owner"))
# the slots kept per block and step (csrc/phase_clocks.cuh, QPDO_SPAN_STEP):
# those of a factor step, then those of a panel of R x = z
STEP_PHASES = (2, 11, 3, 14, 4, 5, 6, 7)
BACK_PHASES = (12, 13, 8, 9, 10)
STEP_BLOCKS, STEPS = 16, 64    # kStepClockBlocks, kStepClockSteps
CLUSTER_SHAPES = ((1, 1536, 1024), (1, 768, 512))


def marked_library(*names: str) -> ctypes.CDLL:
    """The sources built together with the marks compiled in."""
    WORK.mkdir(parents=True, exist_ok=True)
    out = WORK / f"lib{Path(names[0]).stem}_clocks.so"
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-DQPDO_PHASE_CLOCKS",
           "-shared", "-o", str(out), *(str(kernels.CSRC / n) for n in names)]
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


def read_step_clocks(reader) -> np.ndarray:
    """The spans of each block and step, (block, step, slot)."""
    buf = (ctypes.c_longlong * (STEP_BLOCKS * STEPS * SLOTS))()
    err = reader(ctypes.c_void_p(ctypes.addressof(buf)))
    if err:
        raise RuntimeError(f"cudaMemcpyFromSymbol: CUDA error {err}")
    return np.array(buf, dtype=np.int64).reshape(STEP_BLOCKS, STEPS, SLOTS)


def print_busiest(name: str, steps: np.ndarray, C: int, P: int) -> None:
    """For each slot of STEP_PHASES (steps 0 .. P-2) and BACK_PHASES
    (panels P-1 .. 0), the maximum over the cluster's C blocks at each
    step and the block that took it."""
    names = {k: ph for k, ph, _ in CLUSTER_PHASES}
    for slots, count, what in ((STEP_PHASES, P - 1, "step"),
                               (BACK_PHASES, P, "panel")):
        for k in slots:
            per = steps[:C, :count, k]
            most = per.max(axis=0)
            print(f"{name} busiest block, {names[k]}, by {what}: max "
                  f"{most.tolist()} (blocks {per.argmax(axis=0).tolist()});"
                  f" sum of the maxima {int(most.sum())}, mean "
                  f"{most.mean():.0f} a {what}", flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def global_route(lib) -> None:
    """Both entry points of kkt_solve_large.cu at GLOBAL_SHAPES: the spans
    of GLOBAL_PHASES for problem 0, their sum against the time of a call
    (CUDA events, 20 calls) at the SM clock: what is left is the gaps
    between the launches and the blocks after block (0, 0)."""
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_kkt as fk

    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.qpdo_kkt_solve_global_f32.argtypes = [ptr] * 8 + [i] * 4 + [ptr]
    lib.qpdo_chol_solve_global_f32.argtypes = [ptr] * 4 + [i] * 2 + [ptr]
    stream = torch.cuda.current_stream().cuda_stream
    sms = ff.sm_count(0)
    for B, M, N in GLOBAL_SHAPES:
        rng = np.random.default_rng(N)
        Mx = rng.standard_normal((B, N, N))
        arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / N + 0.1 * np.eye(N),
                  rng.standard_normal((B, M, N)), rng.random((B, M)),
                  np.full(B, 1e-3), rng.standard_normal((B, N)))
        Q, A, w, sigma, rhs = [
            torch.as_tensor(a, dtype=torch.float32, device="cuda:0")
            for a in arrays]
        K = A.mT @ (w[..., None] * A) + Q + sigma[:, None, None] * torch.eye(
            N, device="cuda:0")
        d = torch.diagonal(K, dim1=-2, dim2=-1).rsqrt()
        Khat = (K * d[:, :, None] * d[:, None, :]).contiguous()
        bhat = (rhs * d).contiguous()
        dx = torch.empty_like(rhs)
        work = torch.empty(fk.global_work_floats(B, N), dtype=torch.float32,
                           device="cuda:0")
        splits = ff.formation_splits(B, M, N, sms)
        partial = (torch.empty((B, splits, N, N), dtype=torch.float32,
                               device="cuda:0") if splits > 1 else None)
        calls = {
            "kkt_solve_global": lambda: lib.qpdo_kkt_solve_global_f32(
                Q.data_ptr(), A.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                rhs.data_ptr(), dx.data_ptr(), work.data_ptr(),
                None if partial is None else partial.data_ptr(), B, M, N,
                splits, stream),
            "chol_solve_global": lambda: lib.qpdo_chol_solve_global_f32(
                Khat.data_ptr(), bhat.data_ptr(), dx.data_ptr(),
                work.data_ptr(), B, N, stream)}
        for name, call in calls.items():
            for _ in range(3):      # the last of three runs is printed
                assert lib.qpdo_kkt_large_phase_clocks_reset() == 0
                err = call()
                torch.cuda.synchronize()
                t = read_clocks(lib.qpdo_kkt_large_phase_clocks)
            assert err == 0 and torch.isfinite(dx).all(), name
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            clock = smi("clocks.sm")
            spans = sum(t[:len(GLOBAL_PHASES)])
            print(f"{name} (B={B}, m={M}, n={N}), problem 0: "
                  + "; ".join(f"{ph} {t[k]}"
                              for k, ph in enumerate(GLOBAL_PHASES))
                  + f"; spans {spans} cycles at SM clock {clock}; {ms:.4f} ms"
                  f" a call ({ms * 1e-3 * float(clock.split()[0]) * 1e6:.0f}"
                  f" cycles)", flush=True)


def cluster_route(lib) -> None:
    """Both entry points of kkt_solve_cluster.cu at CLUSTER_SHAPES: the
    spans of CLUSTER_PHASES for problem 0's cluster, each also as an
    average over its blocks, the pivot chain per pivot (panels 1..), and
    the time of a call (CUDA events, 20 calls) at the SM clock."""
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_kkt as fk

    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.qpdo_kkt_solve_cluster_f32.argtypes = [ptr] * 8 + [i] * 5 + [ptr]
    lib.qpdo_chol_solve_cluster_f32.argtypes = [ptr] * 4 + [i] * 3 + [ptr]
    lib.qpdo_kkt_cluster_block_phase_clocks.argtypes = [ptr]
    stream = torch.cuda.current_stream().cuda_stream
    sms = ff.sm_count(0)
    for B, M, N in CLUSTER_SHAPES:
        rng = np.random.default_rng(N)
        Mx = rng.standard_normal((B, N, N))
        arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / N + 0.1 * np.eye(N),
                  rng.standard_normal((B, M, N)), rng.random((B, M)),
                  np.full(B, 1e-3), rng.standard_normal((B, N)))
        Q, A, w, sigma, rhs = [
            torch.as_tensor(a, dtype=torch.float32, device="cuda:0")
            for a in arrays]
        K = A.mT @ (w[..., None] * A) + Q + sigma[:, None, None] * torch.eye(
            N, device="cuda:0")
        d = torch.diagonal(K, dim1=-2, dim2=-1).rsqrt()
        Khat = (K * d[:, :, None] * d[:, None, :]).contiguous()
        bhat = (rhs * d).contiguous()
        dx = torch.empty_like(rhs)
        splits = ff.formation_splits(B, M, N, sms)
        partial = (torch.empty((B, splits, N, N), dtype=torch.float32,
                               device="cuda:0") if splits > 1 else None)
        work = {name: torch.empty(fk.cluster_work_floats(name, B, N),
                                  dtype=torch.float32, device="cuda:0")
                for name in ("kkt_solve", "chol_solve")}
        calls = {
            "kkt_solve_cluster": lambda: lib.qpdo_kkt_solve_cluster_f32(
                Q.data_ptr(), A.data_ptr(), w.data_ptr(), sigma.data_ptr(),
                rhs.data_ptr(), dx.data_ptr(), work["kkt_solve"].data_ptr(),
                None if partial is None else partial.data_ptr(), B, M, N,
                splits, 0, stream),
            "chol_solve_cluster": lambda: lib.qpdo_chol_solve_cluster_f32(
                Khat.data_ptr(), bhat.data_ptr(), dx.data_ptr(),
                work["chol_solve"].data_ptr(), B, N, 0, stream)}
        C = kernels.cluster_size(N)
        pivots = N - 32 if N > 32 else 1
        for name, call in calls.items():
            for _ in range(3):      # the last of three runs is printed
                assert lib.qpdo_kkt_cluster_phase_clocks_reset() == 0
                err = call()
                torch.cuda.synchronize()
                t = read_clocks(lib.qpdo_kkt_cluster_phase_clocks)
                steps = read_step_clocks(
                    lib.qpdo_kkt_cluster_block_phase_clocks)
            assert err == 0 and torch.isfinite(dx).all(), name
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / 20
            clock = smi("clocks.sm")
            print(f"{name} (B={B}, m={M}, n={N}, a cluster of {C} blocks), "
                  "problem 0: " + "; ".join(
                      f"{ph} ({who}) {t[k]}"
                      + (f" [{t[k] / C:.0f} a block]"
                         if who == "every block" else "")
                      for k, ph, who in CLUSTER_PHASES)
                  + f"; pivot chain {t[3] / pivots:.0f} cycles a pivot; "
                  f"SM clock {clock}; {ms:.4f} ms a call "
                  f"({ms * 1e-3 * float(clock.split()[0]) * 1e6:.0f} cycles)",
                  flush=True)
            print_busiest(name, steps, C, (N + 31) // 32)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_phase_clocks: needs a CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["cluster"]:
        print(smi("name,power.limit"))
        cluster_route(marked_library("kkt_solve_cluster.cu", "formation.cu"))
        return 0
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
    global_route(marked_library("kkt_solve_large.cu", "formation.cu"))
    cluster_route(marked_library("kkt_solve_cluster.cu", "formation.cu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
