#!/usr/bin/env python3
"""Drive the PyTorch port (qpdo_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from qpdo_tpu_torch/csrc with nvcc.
2. Formation kernel against its plain PyTorch version on the card, at the
   bench shape (B=256, m=150, n=100), float32 and float64: max error
   relative to max|K| <= 1e-5 (f32) and 1e-12 (f64).
3. Residual kernel against its plain version, same shape and dtypes:
   elementwise |a - b| <= rtol * |b| with rtol 1e-6 (f32) and 1e-13
   (f64); ``active`` equal exactly.
4. The main path: the bench problem family (bench.py:341-352, B=256,
   n=100, m=150, seed 0) solved by ``qpdo_tpu_torch.solve_batch(...,
   compact=True)`` on cuda:0 with the bench settings plus both kernel
   flags.  Every problem SOLVED, the numpy float64 KKT oracle of
   bench.py:482-490 at rp, rd <= 1.1e-6, both kernels launched during the
   run, results on the card.  A small batch is also solved on the card and
   on the CPU (plain versions) and must agree in status and, within 3, in
   iteration counts.  Then 3 timed runs.
5. Kernel against plain-version time per call at the bench shape.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

B, N, M = 256, 100, 150
DEVICE = "cuda:0"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def bench_problems(B, n, m, seed=0):
    """The bench family as numpy float64 arrays (bench.py:344-352)."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


def bench_settings(pt):
    """bench.py:375-448 at its defaults, plus both kernel flags
    (QPDO_BENCH_PALLAS=both)."""
    return pt.Settings(eps_abs=1e-6, max_iter=300, inner_max_iter=50,
                       eps_abs_in=0.1, rho=0.02, delta=0.1, refine_steps=2,
                       kkt_dtype="float32", hybrid_warmup=True, mu_min=1e-7,
                       cert_dtype="float32", linesearch="bisect",
                       linesearch_dtype="float32",
                       phase2_gemm_dtype="float32", hard_rows=8,
                       anchor_every=10, newton_full_step=True,
                       warmup_eps=1e-4, warmup_matmul_precision="highest",
                       kkt_update_rows=0, warmup_refine_steps=0,
                       polish=False, pallas_formation=True,
                       pallas_residuals=True, pallas_kkt=False,
                       fused_newton_rhs=False, kkt_solver="ns",
                       kkt_ns_steps=5, kkt_inv_refresh=False, kkt_cg_fixed=0)


def oracle(d, x, y):
    """Per-problem unscaled KKT residuals in numpy float64."""
    Ax = np.einsum("bmn,bn->bm", d["A"], x)
    rp = np.abs(Ax - np.clip(Ax + y, d["l"], d["u"])).max(axis=1)
    rd = np.abs(np.einsum("bij,bj->bi", d["Q"], x) + d["q"]
                + np.einsum("bmn,bm->bn", d["A"], y)).max(axis=1)
    return rp, rd


def time_ms(fn, reps=100, warmup=10):
    """Mean device time per call over back-to-back calls (CUDA events);
    when the host takes longer to issue a call than the card to run it,
    this is the host's issue time, as the solver loop sees it."""
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


def formation_inputs(dtype, seed=3):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, M, N))
    w = rng.random((B, M))
    Mx = rng.standard_normal((B, N, N))
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / N
    sigma = rng.random(B) * 0.1
    return [torch.as_tensor(a, dtype=dtype, device=DEVICE)
            for a in (A, w, Q, sigma)]


def residual_inputs(dtype, seed=4):
    rng = np.random.default_rng(seed)
    d = lambda *s: rng.standard_normal(s)
    E = rng.random((B, M)) + 0.5
    arrays = (d(B, M), d(B, M), rng.random((B, M)) + 0.1, d(B, M),
              -(rng.random((B, M)) + 0.2), rng.random((B, M)) + 0.2,
              E, 1.0 / E, d(B, N), d(B, N), d(B, N), d(B, N), d(B, N),
              rng.random((B, N)) + 0.5, rng.random(B) * 0.1,
              rng.random(B) + 0.5)
    return [torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in arrays]


def check_formation(ff, dtype, tol):
    args = formation_inputs(dtype)
    K = ff.fused_formation(*args)
    ref = ff.reference_formation(*args)
    torch.cuda.synchronize()
    err = (K - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if not (rel <= tol):
        raise AssertionError(f"formation {dtype}: rel err {rel:.3e} > {tol}")
    return err, rel


def check_residuals(fr, dtype, rtol):
    args = residual_inputs(dtype)
    out = fr.fused_residuals(*args)
    ref = fr.reference_residuals(*args)
    torch.cuda.synchronize()
    names = ("res_prim", "res_prim_in", "w", "active", "res_dual_in",
             "rp", "rd", "rpi", "rdi")
    worst = 0.0
    for name, a, b in zip(names, out, ref):
        if name == "active":
            if not torch.equal(a, b):
                raise AssertionError(f"residuals {dtype}: active differs")
            continue
        diff = (a - b).abs()
        if not bool((diff <= rtol * b.abs()).all()):
            raise AssertionError(f"residuals {dtype}: {name} off by "
                                 f"{diff.max().item():.3e}")
        worst = max(worst, diff.max().item())
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    import qpdo_tpu_torch as pt
    from qpdo_tpu_torch import kernels
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_residuals as fr

    # ---- phase 1: the card, the build ----
    card = card_line()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    t0 = time.perf_counter()
    lib = kernels.library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({lib._name})")
    log = lib._name + ".log"
    try:
        with open(log) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print("  ptxas:", line.strip())
    except FileNotFoundError:
        pass

    # ---- phase 2, 3: each kernel against its plain version ----
    max_err = {"formation": 0.0, "residuals": 0.0}
    for dtype, ftol, rtol in ((torch.float32, 1e-5, 1e-6),
                              (torch.float64, 1e-12, 1e-13)):
        err, rel = check_formation(ff, dtype, ftol)
        max_err["formation"] = max(max_err["formation"], err)
        print(f"phase 2: formation {dtype}: max abs err {err:.3e}, "
              f"relative to max|K| {rel:.3e} (tol {ftol})")
        err = check_residuals(fr, dtype, rtol)
        max_err["residuals"] = max(max_err["residuals"], err)
        print(f"phase 3: residuals {dtype}: max abs err {err:.3e} "
              f"(rtol {rtol}), active equal")

    # ---- phase 4: the main path ----
    d = bench_problems(B, N, M)
    settings = bench_settings(pt)
    problems = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                             for k, v in d.items()})
    ff.fused_formation.launches = 0
    fr.fused_residuals.launches = 0
    t0 = time.perf_counter()
    res = pt.solve_batch(problems, settings, compact=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"formation": ff.fused_formation.launches,
                "residuals": fr.fused_residuals.launches}
    print(f"phase 4: first solve {first_s:.2f} s, kernel launches {launches}")
    if not (res.x.is_cuda and res.y.is_cuda and res.info.status_val.is_cuda):
        raise AssertionError("results are not on the card")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    status = res.info.status_val.cpu().numpy()
    x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
    if x.shape != (B, N) or y.shape != (B, M):
        raise AssertionError(f"result shapes {x.shape}, {y.shape}")
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise AssertionError("non-finite solution")
    solved = int((status == pt.SOLVED).sum())
    rp, rd = oracle(d, x, y)
    print(f"phase 4: solved {solved}/{B}, oracle max rp {rp.max():.3e}, "
          f"max rd {rd.max():.3e}")
    if solved != B:
        raise AssertionError(f"only {solved}/{B} problems SOLVED")
    if not (rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6):
        raise AssertionError("oracle residual above 1.1e-6")

    # the same code on the CPU (plain versions) on a small batch
    ds = bench_problems(16, 40, 60, seed=1)
    small = {dev: pt.solve_batch(pt.Problem(**{
        k: torch.as_tensor(v, device=dev) for k, v in ds.items()}),
        settings, compact=True) for dev in (DEVICE, "cpu")}
    st = {dev: r.info.status_val.cpu().numpy() for dev, r in small.items()}
    it = {dev: r.info.iterations.cpu().numpy().astype(int)
          for dev, r in small.items()}
    dev_iter = int(np.abs(it[DEVICE] - it["cpu"]).max())
    print(f"phase 4: small batch card vs CPU: statuses "
          f"{'equal' if np.array_equal(st[DEVICE], st['cpu']) else 'DIFFER'}"
          f", max iteration difference {dev_iter}")
    if not (np.all(st[DEVICE] == pt.SOLVED) and np.all(st["cpu"] == pt.SOLVED)
            and dev_iter <= 3):
        raise AssertionError("card and CPU disagree on the small batch")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.solve_batch(problems, settings, compact=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    iters = res.info.iterations.cpu().numpy()
    witers = res.info.warmup_iterations.cpu().numpy()
    print(f"phase 4: {B / min(times):.2f} QPs/s (best of 3; mean "
          f"{B / np.mean(times):.2f}), solve times "
          f"{[round(t, 4) for t in times]} s, mean iterations "
          f"{iters.mean():.2f}, mean warmup iterations {witers.mean():.2f}, "
          f"on {card}")

    # ---- phase 5: kernel against plain version, per call ----
    ms = {}
    for dtype in (torch.float32, torch.float64):
        fa = formation_inputs(dtype)
        ra = residual_inputs(dtype)
        ms[("formation", dtype)] = (
            time_ms(lambda: ff.fused_formation(*fa)),
            time_ms(lambda: ff.reference_formation(*fa)))
        ms[("residuals", dtype)] = (
            time_ms(lambda: fr.fused_residuals(*ra)),
            time_ms(lambda: fr.reference_residuals(*ra)))
    for (name, dtype), (k, p) in ms.items():
        print(f"phase 5: {name} {dtype} at B={B} m={M} n={N}: kernel "
              f"{k:.4f} ms, plain {p:.4f} ms per call")

    source = {"formation": ("qpdo_tpu_torch/csrc/formation.cu",
                            "qpdo_tpu/ops/pallas_formation.py:24"),
              "residuals": ("qpdo_tpu_torch/csrc/residuals.cu",
                            "qpdo_tpu/ops/pallas_residuals.py:47")}
    # the path runs the formation in float32 and the residuals mostly in
    # float32 (the hybrid warmup), so the times reported are float32's
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source[name][0],
         "replaces": source[name][1], "launches": launches[name],
         "max_abs_err": max_err[name],
         "ms": ms[(name, torch.float32)][0],
         "plain_ms": ms[(name, torch.float32)][1]}
        for name in ("formation", "residuals")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
