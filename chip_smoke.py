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
5. Time per call at the bench shape: each kernel beside its plain
   version and beside the library route for the same function (cuBLAS and
   ``torch.linalg`` calls: for the fused KKT solve, formation kernel ->
   ``jacobi_cholesky`` -> two triangular solves), with the least time the
   card could take for the same bytes and operations.
6. The fused KKT-solve kernel and the Cholesky-solve kernel against their
   plain versions at B=256, m=150, n=100, float32: max error relative to
   max|dx| <= 2e-5 (found: 1.5e-6 to 4.2e-6; the same recurrences summed
   in another order).  The composition formation kernel -> Jacobi scale and
   shift -> Cholesky-solve kernel -> unscale against the fused kernel, same
   tolerance.  One problem made indefinite and one with a NaN in rhs:
   kernel and plain version agree on which problems come back non-finite,
   and the other problems are untouched.
7. The second path: the same family through ``solve_batch(...,
   compact=True)`` with ``kkt_dtype="float32", mu_min=1e-7,
   refine_steps=2, pallas_kkt=True, pallas_residuals=True`` (float64
   state, no warmup): every Newton solve is the fused kernel, three
   launches per step.  Same gate as phase 4, the fused kernel launched,
   results on the card; then a warm-started re-solve (q perturbed from a
   seed, x0/y0 the previous solution), same gate; 3 timed runs.
8. The stateful entry point: ``QPDO().setup(...)`` of one n=100, m=150
   problem with no device argument (so the card), solve, warm_start,
   update_q, update_bounds, solve; results on the card, same oracle.

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
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 and float64 FLOP/s
# outside the tensor cores
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 34e12


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


def bound_ms(nbytes, flops, peak_flops=PEAK_F32):
    """The least time for that many bytes (each input read once, each
    output written once) and operations, and which of the two sets it."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kkt_inputs(seed=6):
    """Float32 inputs of the fused KKT solve at the bench shape."""
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((B, N, N))
    arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / N + 0.1 * np.eye(N),
              rng.standard_normal((B, M, N)), rng.random((B, M)),
              np.full(B, 1e-3), rng.standard_normal((B, N)))
    return [torch.as_tensor(a, dtype=torch.float32, device=DEVICE)
            for a in arrays]


def scaled_system(fk, ff, Q, A, w, sigma, rhs):
    """Formation kernel -> Jacobi scale and static shift, in plain tensor
    ops: the input of the Cholesky-solve kernel (Khat, scaled rhs, dinv)."""
    K = ff.fused_formation(A, w, Q, sigma)
    d = torch.diagonal(K, dim1=-2, dim2=-1)
    dinv = torch.where(d > 0, torch.rsqrt(d), torch.ones_like(d))
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    Khat = K * dinv[:, :, None] * dinv[:, None, :] + fk._static_reg32() * eye
    return Khat.contiguous(), rhs * dinv, dinv


def on_card(*tensors) -> bool:
    return all(t.is_cuda for t in tensors)


def rel_err(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def check_solved(pt, d, res, what):
    """The gate of a solve: on the card, right shapes, finite, every
    problem SOLVED, the numpy float64 oracle at 1.1e-6."""
    if not on_card(res.x, res.y, res.info.status_val):
        raise AssertionError(f"{what}: results are not on the card")
    status = res.info.status_val.cpu().numpy()
    x, y = res.x.cpu().numpy(), res.y.cpu().numpy()
    nb = d["q"].shape[0]
    if x.shape != d["q"].shape or y.shape != d["l"].shape:
        raise AssertionError(f"{what}: result shapes {x.shape}, {y.shape}")
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise AssertionError(f"{what}: non-finite solution")
    solved = int((status == pt.SOLVED).sum())
    rp, rd = oracle(d, x, y)
    print(f"{what}: solved {solved}/{nb}, oracle max rp {rp.max():.3e}, "
          f"max rd {rd.max():.3e}, mean iterations "
          f"{res.info.iterations.float().mean().item():.2f}", flush=True)
    if solved != nb:
        raise AssertionError(f"{what}: only {solved}/{nb} problems SOLVED "
                             f"(statuses {sorted(set(status.tolist()))})")
    if not (rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6):
        raise AssertionError(f"{what}: oracle residual above 1.1e-6")


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
    from qpdo_tpu_torch.ops import fused_kkt as fk
    from qpdo_tpu_torch.ops import fused_residuals as fr
    from qpdo_tpu_torch.ops import linalg as tl

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
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    res = pt.solve_batch(problems, settings, compact=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"formation": ff.fused_formation.launches,
                "residuals": fr.fused_residuals.launches}
    path_launches_bench = dict(launches)
    print(f"phase 4: first solve {first_s:.2f} s, kernel launches {launches}")
    if not on_card(res.x, res.y, res.info.status_val):
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

    # ---- phase 6: the KKT-solve kernels against their plain versions ----
    max_err.update(phase6(ff, fk))
    # launches of the Cholesky-solve kernel's own path (no solver calls it):
    # formation kernel -> scale -> kernel -> unscale, once
    ff.fused_formation.launches = 0
    fk.chol_solve_stacked.launches = 0
    ka = kkt_inputs()
    Khat, bhat, dinv = scaled_system(fk, ff, *ka)
    composed = fk.chol_solve_stacked(Khat, bhat) * dinv
    torch.cuda.synchronize()
    launches["chol_solve"] = fk.chol_solve_stacked.launches
    path_launches = {"composition": {
        "formation": ff.fused_formation.launches,
        "chol_solve": fk.chol_solve_stacked.launches}}
    if not torch.isfinite(composed).all() or launches["chol_solve"] <= 0:
        raise AssertionError("the composition path did not run kernel 4")

    # ---- phase 7: the second path, every Newton solve the fused kernel ----
    launches["kkt_solve"], path_launches["pallas_kkt"] = phase7(
        pt, ff, fr, fk, d, card)

    # ---- phase 8: the stateful entry point, on the card by default ----
    phase8(pt, fk)

    # ---- phase 5: time per call: kernel, plain version, library route ----
    rows = phase5(ff, fr, fk, tl)
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = max_err[r["name"]]
        r["launches_by_path"] = {"bench_ns": path_launches_bench.get(
            r["name"], 0), **{k: v.get(r["name"], 0)
                              for k, v in path_launches.items()}}
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def phase5(ff, fr, fk, tl):
    """Time every kernel at the bench shape in float32 (the type the paths
    run them in; formation and residuals also in float64, printed only)
    beside its plain version, the library route for the same function and
    its bound.  Returns the rows of the kernels line."""
    f32 = torch.float32
    ms = {}
    for dtype in (f32, torch.float64):
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

    Q, A, w, sigma, rhs = kkt_inputs()
    Khat, bhat, dinv = scaled_system(fk, ff, Q, A, w, sigma, rhs)

    def kkt_library():
        K = ff.fused_formation(A, w, Q, sigma)
        chol, di = tl.jacobi_cholesky(K)
        return tl._prescaled_tri_solver(chol, di, f32)(rhs)

    def chol_library():
        chol = torch.linalg.cholesky_ex(Khat)[0]
        z = torch.linalg.solve_triangular(chol, bhat[..., None], upper=False)
        return torch.linalg.solve_triangular(chol.mT, z, upper=True)

    # each side is timed twice, in turns, and the smaller time kept
    def timed(fn, reps):
        return time_ms(fn, reps=reps, warmup=max(2, reps // 10))

    t = {}
    for name, kernel, plain, library, single in (
            ("kkt_solve", lambda: fk.fused_kkt_solve(Q, A, w, sigma, rhs),
             lambda: fk.reference_kkt_solve(Q, A, w, sigma, rhs),
             kkt_library, None),
            ("chol_solve", lambda: fk.chol_solve_stacked(Khat, bhat),
             lambda: fk.reference_chol_solve(Khat, bhat), chol_library,
             lambda: torch.linalg.solve(Khat, bhat))):
        k1, l1 = timed(kernel, 100), timed(library, 100)
        l2, k2 = timed(library, 100), timed(kernel, 100)
        t[name] = dict(ms=min(k1, k2), plain_ms=timed(plain, 3),
                       library_route_ms=min(l1, l2),
                       library_ms=None if single is None
                       else timed(single, 100))
        print(f"phase 5: {name} float32 at B={B} m={M} n={N}: kernel "
              f"{t[name]['ms']:.4f} ms ({k1:.4f}, {k2:.4f}), plain version "
              f"{t[name]['plain_ms']:.2f} ms, library route (torch.linalg) "
              f"{t[name]['library_route_ms']:.4f} ms ({l1:.4f}, {l2:.4f})"
              + ("" if single is None else
                 f", torch.linalg.solve {t[name]['library_ms']:.4f} ms"))
    for name in ("formation", "residuals"):
        k, p = ms[(name, f32)]
        # the plain versions of these two are the library route: cuBLAS
        # batched GEMM, ATen elementwise and reduction kernels
        t[name] = dict(ms=k, plain_ms=p, library_route_ms=p, library_ms=None)

    # the work of one call, from the shapes: bytes with each input read and
    # each output written once (4 bytes each), operations as in the sources
    work = {
        "formation": (4 * (B * M * N + B * M + 2 * B * N * N + B),
                      2 * B * M * N * N),
        # 16 inputs and 6 outputs; about 22 operations per dual entry and
        # 10 per primal entry
        "residuals": (4 * (12 * B * M + 7 * B * N + 6 * B),
                      22 * B * M + 10 * B * N),
        # formation, Jacobi scale, n^3/3 factor, two n^2 substitutions
        "kkt_solve": (4 * (B * N * N + B * M * N + B * M + B + 2 * B * N),
                      B * (2 * M * N * N + N ** 3 // 3 + 4 * N * N)),
        "chol_solve": (4 * (B * N * N + 2 * B * N),
                       B * (N ** 3 // 3 + 2 * N * N)),
    }
    meta = {
        "formation": ("qpdo_tpu_torch/csrc/formation.cu",
                      "qpdo_tpu/ops/pallas_formation.py:24",
                      "cuBLAS batched GEMM + elementwise"),
        "residuals": ("qpdo_tpu_torch/csrc/residuals.cu",
                      "qpdo_tpu/ops/pallas_residuals.py:47",
                      "ATen elementwise and reduction kernels"),
        "kkt_solve": ("qpdo_tpu_torch/csrc/kkt_solve.cu",
                      "qpdo_tpu/ops/pallas_kkt.py:40",
                      "formation kernel + torch.linalg.cholesky_ex + 2 "
                      "solve_triangular"),
        "chol_solve": ("qpdo_tpu_torch/csrc/kkt_solve.cu",
                       "qpdo_tpu/ops/pallas_kkt.py:209",
                       "torch.linalg.cholesky_ex + 2 solve_triangular"),
    }
    rows = []
    for name in ("formation", "residuals", "kkt_solve", "chol_solve"):
        bms, by = bound_ms(*work[name])
        print(f"phase 5: {name} float32: kernel {t[name]['ms']:.4f} ms, bound "
              f"{bms:.5f} ms (by {by}: {work[name][0] / 1e6:.2f} MB, "
              f"{work[name][1] / 1e9:.4f} GFLOP)")
        rows.append({"name": name, "route": "cuda", "source": meta[name][0],
                     "replaces": meta[name][1], "launches": 0,
                     "max_abs_err": 0.0, "ms": t[name]["ms"],
                     "plain_ms": t[name]["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": t[name]["library_ms"],
                     "library_route_ms": t[name]["library_route_ms"],
                     "library_route": meta[name][2]})
    return rows


def phase6(ff, fk):
    """Kernels 3 and 4 against their plain versions, the composition
    against kernel 3, and failed problems.  Returns max abs errors."""
    tol = 2e-5
    Q, A, w, sigma, rhs = kkt_inputs()
    dx = fk.fused_kkt_solve(Q, A, w, sigma, rhs)
    ref = fk.reference_kkt_solve(Q, A, w, sigma, rhs)
    Khat, bhat, dinv = scaled_system(fk, ff, Q, A, w, sigma, rhs)
    x = fk.chol_solve_stacked(Khat, bhat)
    xref = fk.reference_chol_solve(Khat, bhat)
    torch.cuda.synchronize()
    errs = {"kkt_solve": (dx - ref).abs().max().item(),
            "chol_solve": (x - xref).abs().max().item()}
    rels = {"kkt_solve vs plain": rel_err(dx, ref),
            "chol_solve vs plain": rel_err(x, xref),
            "formation -> scale -> chol_solve -> unscale vs kkt_solve":
                rel_err(x * dinv, dx)}
    # for scale: both against a float64 solve of the same system
    K64 = (torch.matmul(A.double().mT, w.double()[..., None] * A.double())
           + Q.double() + 1e-3 * torch.eye(N, dtype=torch.float64,
                                           device=DEVICE))
    exact = torch.linalg.solve(K64, rhs.double())
    for what, r in rels.items():
        print(f"phase 6: {what}: max error relative to max|dx| {r:.3e} "
              f"(tol {tol})")
        if not (r <= tol):
            raise AssertionError(f"phase 6: {what}: {r:.3e} > {tol}")
    print(f"phase 6: against a float64 solve: kernel "
          f"{rel_err(dx.double(), exact):.3e}, plain version "
          f"{rel_err(ref.double(), exact):.3e}")

    # failures stay in their problem
    Qb, rb = Q.clone(), rhs.clone()
    Qb[1] = -Qb[1] - 10.0 * torch.eye(N, device=DEVICE)     # indefinite
    rb[2, 3] = float("nan")
    bad = fk.fused_kkt_solve(Qb, A, w, sigma, rb)
    bad_ref = fk.reference_kkt_solve(Qb, A, w, sigma, rb)
    Kb, bb, db = scaled_system(fk, ff, Qb, A, w, sigma, rb)
    bad4 = fk.chol_solve_stacked(Kb, bb)
    bad4_ref = fk.reference_chol_solve(Kb, bb)
    torch.cuda.synchronize()
    for what, got, want, good in (("kkt_solve", bad, bad_ref, dx),
                                  ("chol_solve", bad4, bad4_ref, x)):
        fin = torch.isfinite(got).all(dim=1)
        if not torch.equal(fin, torch.isfinite(want).all(dim=1)):
            raise AssertionError(f"phase 6: {what} and its plain version "
                                 "disagree on which problems are non-finite")
        lost = (~fin).nonzero().flatten().tolist()
        if 2 not in lost or not set(lost) <= {1, 2}:
            raise AssertionError(f"phase 6: {what}: non-finite problems {lost}")
        keep = [i for i in range(B) if i not in (1, 2)]
        if not torch.equal(got[keep], good[keep]):
            raise AssertionError(f"phase 6: {what}: a failed problem changed "
                                 "its neighbours")
        print(f"phase 6: {what}: non-finite problems {lost} (kernel and "
              f"plain version agree), the other {len(keep)} bit-identical "
              "to the clean run")
    return errs


def pallas_kkt_settings(pt):
    """The configuration of tests/test_pallas_inloop.py:146-161 plus the
    residual kernel's flag."""
    return pt.Settings(kkt_dtype="float32", mu_min=1e-7, refine_steps=2,
                       pallas_kkt=True, pallas_residuals=True)


def reset_counts(*modules):
    for mod in modules:
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches"):
                fn.launches = 0


def phase7(pt, ff, fr, fk, d, card):
    """The second path at full width.  Returns the fused kernel's launches
    in the cold solve and all counters of that solve."""
    settings = pallas_kkt_settings(pt)
    problems = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                             for k, v in d.items()})
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    res = pt.solve_batch(problems, settings, compact=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = {"formation": ff.fused_formation.launches,
              "residuals": fr.fused_residuals.launches,
              "kkt_solve": fk.fused_kkt_solve.launches,
              "chol_solve": fk.chol_solve_stacked.launches}
    print(f"phase 7: first solve {first_s:.2f} s, kernel launches {counts}")
    if counts["kkt_solve"] <= 0 or counts["residuals"] <= 0:
        raise AssertionError(f"phase 7: a kernel of the path was not "
                             f"launched: {counts}")
    check_solved(pt, d, res, "phase 7 (cold)")

    # the MPC re-solve: a perturbed cost, from the previous solution
    rng = np.random.default_rng(7)
    d2 = dict(d, q=d["q"] + 0.01 * rng.standard_normal(d["q"].shape))
    warm = pt.solve_batch(
        problems._replace(q=torch.as_tensor(d2["q"], device=DEVICE)),
        settings, x0=res.x, y0=res.y, compact=True)
    torch.cuda.synchronize()
    check_solved(pt, d2, warm, "phase 7 (warm-started re-solve)")
    cold_it = res.info.iterations.float().mean().item()
    warm_it = warm.info.iterations.float().mean().item()
    print(f"phase 7: mean iterations cold {cold_it:.2f}, warm-started "
          f"{warm_it:.2f}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pt.solve_batch(problems, settings, compact=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"phase 7: {B / min(times):.2f} QPs/s (best of 3; mean "
          f"{B / np.mean(times):.2f}), solve times "
          f"{[round(t, 4) for t in times]} s, mean iterations "
          f"{res.info.iterations.float().mean().item():.2f}, on {card}")
    return counts["kkt_solve"], counts


def phase8(pt, fk):
    """QPDO on one problem, no device argument: everything on the card."""
    d = {k: v[0] for k, v in bench_problems(1, N, M, seed=8).items()}
    solver = pt.QPDO()
    solver.setup(d["Q"], d["q"], d["A"], d["l"], d["u"],
                 pallas_kkt_settings(pt))
    if not on_card(solver._sp.data.Q):
        raise AssertionError("phase 8: setup() did not default to the card")
    before = fk.fused_kkt_solve.launches
    res = solver.solve()
    batch = lambda dd: {k: np.asarray(v)[None] for k, v in dd.items()}
    check_solved(pt, batch(d), res, "phase 8 (setup, solve)")
    rng = np.random.default_rng(9)
    d2 = dict(d, q=d["q"] + 0.01 * rng.standard_normal(N),
              l=d["l"] - 0.05, u=d["u"] + 0.05)
    solver.warm_start(res.x, res.y)
    solver.update_q(d2["q"])
    solver.update_bounds(d2["l"], d2["u"])
    res2 = solver.solve()
    check_solved(pt, batch(d2), res2,
                 "phase 8 (warm_start, update_q, update_bounds, solve)")
    print(f"phase 8: iterations {int(res.info.iterations)} then "
          f"{int(res2.info.iterations)}, fused KKT kernel launches "
          f"{fk.fused_kkt_solve.launches - before}, solve time "
          f"{float(res2.info.solve_time):.3f} s")
    if fk.fused_kkt_solve.launches <= before:
        raise AssertionError("phase 8: the fused kernel was not launched")


if __name__ == "__main__":
    sys.exit(main())
