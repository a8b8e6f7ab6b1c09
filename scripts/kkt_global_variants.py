#!/usr/bin/env python3
"""Time the global-memory route of kernels 3 and 4 (csrc/kkt_solve_large.cu)
with and without programmatic dependent launch, on one NVIDIA GPU.

    python3 scripts/kkt_global_variants.py

Builds the source as it is and with ``kDependentLaunch = 0`` (every launch
of the panel sequence then waits for the one before it to finish before it
is launched), each with formation.cu into its own library under
build/kkt_global_variants/, and times both C entry points at
chip_smoke.py's ``LARGE_KKT_SHAPES`` with CUDA events (20 back-to-back
calls after 5, best of 3), the two variants in turns (with, without,
without, with), on the inputs of phase 6b; each variant's result is held
to the plain version within 2e-5 of max|dx|.  The line before the last is
the card's name and power limit, the last one JSON object with every
number.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from qpdo_tpu_torch import kernels  # noqa: E402
from qpdo_tpu_torch.ops import fused_formation as ff  # noqa: E402
from qpdo_tpu_torch.ops import fused_kkt as fk  # noqa: E402

WORK = REPO / "build" / "kkt_global_variants"
SWITCH = "constexpr int kDependentLaunch = 1;"
VARIANTS = {"dependent_launch": SWITCH,
            "plain_launch": "constexpr int kDependentLaunch = 0;"}


def variant_library(name: str, switch: str) -> ctypes.CDLL:
    text = (kernels.CSRC / "kkt_solve_large.cu").read_text()
    if SWITCH not in text:
        raise SystemExit(f"kkt_solve_large.cu has no line {SWITCH!r}")
    WORK.mkdir(parents=True, exist_ok=True)
    src = WORK / f"{name}.cu"
    src.write_text(text.replace(SWITCH, switch))
    out = WORK / f"lib{name}.so"
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, f"-I{kernels.CSRC}",
           "-shared", "-o", str(out), str(src),
           str(kernels.CSRC / "formation.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    lib = ctypes.CDLL(str(out))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.qpdo_kkt_solve_global_f32.argtypes = [ptr] * 8 + [i] * 4 + [ptr]
    lib.qpdo_chol_solve_global_f32.argtypes = [ptr] * 4 + [i] * 2 + [ptr]
    return lib


def events_ms(call, calls=20, best_of=3):
    for _ in range(5):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(best_of):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return min(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("kkt_global_variants: needs a CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    libs = {name: variant_library(name, switch)
            for name, switch in VARIANTS.items()}
    stream = torch.cuda.current_stream().cuda_stream
    sms = ff.sm_count(0)
    rows = []
    for b, m, n in cs.LARGE_KKT_SHAPES:
        Q, A, w, sigma, rhs = cs.kkt_inputs(seed=n, shape=(b, m, n))
        Khat, bhat, _ = cs.scaled_system(fk, ff, Q, A, w, sigma, rhs)
        refs = {"kkt_solve_global": fk.reference_kkt_solve(Q, A, w, sigma, rhs),
                "chol_solve_global": fk.reference_chol_solve(Khat, bhat)}
        dx = torch.empty_like(rhs)
        work = torch.empty(fk.global_work_floats(b, n), device=rhs.device)
        splits = ff.formation_splits(b, m, n, sms)
        partial = (torch.empty((b, splits, n, n), device=rhs.device)
                   if splits > 1 else None)
        for name, ref in refs.items():
            def call_of(lib):
                if name == "kkt_solve_global":
                    return lambda: lib.qpdo_kkt_solve_global_f32(
                        Q.data_ptr(), A.data_ptr(), w.data_ptr(),
                        sigma.data_ptr(), rhs.data_ptr(), dx.data_ptr(),
                        work.data_ptr(),
                        None if partial is None else partial.data_ptr(),
                        b, m, n, splits, stream)
                return lambda: lib.qpdo_chol_solve_global_f32(
                    Khat.data_ptr(), bhat.data_ptr(), dx.data_ptr(),
                    work.data_ptr(), b, n, stream)
            row = dict(name=name, B=b, m=m, n=n)
            for variant in (*VARIANTS, *reversed(list(VARIANTS))):
                call = call_of(libs[variant])
                if call() != 0:
                    raise SystemExit(f"{variant} {name}: launch failed")
                torch.cuda.synchronize()
                err = cs.rel_err(dx, ref)
                if not err <= 2e-5:
                    raise SystemExit(f"{variant} {name} at {(b, m, n)}: "
                                     f"error {err:.3e} > 2e-5")
                row.setdefault(variant, []).append(round(events_ms(call), 5))
            print(f"kkt_global_variants: {row}", flush=True)
            rows.append(row)
    print(cs.card_line())
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
