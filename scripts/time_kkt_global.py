#!/usr/bin/env python3
"""Time the two KKT kernels (Pallas kernels 3 and 4's port) of one
checkout's qpdo_tpu_torch on one NVIDIA GPU, on every route.

    python3 scripts/time_kkt_global.py [ROOT] [VARIANT.cu ...]

ROOT is the root of the checkout whose package is built and timed (this
one by default); give it another commit unpacked with ``git archive`` to
compare two versions on one card in one call, in turns.  The times are
``chip_smoke.device_ms`` of this checkout (replays of a CUDA graph of the
public wrappers ``fused_kkt_solve`` and ``chol_solve_stacked``, float32),
at the bench shape (B=256, m=150, n=100: the register route), at (32,
300, 200) (the shared-memory route) and at ``chip_smoke.LARGE_KKT_SHAPES``
(above it: the route that B and n select), on the inputs of chip_smoke.py's
phases 6 and 6b, and at ``LIMIT_SHAPES`` (the cluster route's batch limit:
the most clusters the card holds at once, and one more).  Where the
checkout has the cluster route and n has a cluster, the route not
selected there is timed too (cluster or global, by the wrappers' own
launch, ``chip_smoke.on_route``), so that one call compares the two.

One Newton solve's three solves of one K (a first solve and the two
refinement sweeps that ``refine_steps = 2`` makes) is then timed at
``NEWTON_SHAPES`` (the benchmark cell's B = 1,024 and its compacted 256
at m = 506, n = 505; phase 7d's one problem of n = 1,024 and the cluster
route's limit there), on each route that can serve it: the global route
as ``newton_system_solve`` runs it (one launch of kernel 3, then two
substitutions on its kept factor, ``fused_kkt_solver``, built on the
global route whatever B and n select), the global route with a launch
for each solve, and where B clusters fit on the card at once the cluster
route (a launch for each solve); the kept factor's dx held bit for bit
to the launches'.  Each ``device_ms`` of the three solves.

Each VARIANT.cu (a copy of csrc/kkt_solve_cluster.cu with a line
changed), and ROOT's own kkt_solve_cluster.cu, is then built with
formation.cu into a library of its own under build/kkt_cluster_variants/
and its ``qpdo_chol_solve_cluster_f32`` timed at ``VARIANT_SHAPES`` with
CUDA events (20 back-to-back calls, three times), in turns, each result
held to the plain version.  The last line is one JSON object with every
number; the line before it the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
# the cluster route's batch limit at n = 512 (15 clusters of 8 blocks at
# once on an H100) and n = 1024 (7 of 16), and one problem past it
LIMIT_SHAPES = ((15, 768, 512), (16, 768, 512), (7, 1536, 1024),
                (8, 1536, 1024))
VARIANT_SHAPES = ((1, 768, 512), (1, 1536, 1024))
NEWTON_SHAPES = ((1024, 506, 505), (256, 506, 505), (1, 1536, 1024),
                 (7, 1536, 1024))


def refined_solves(cs, fk, route, args, kept):
    """A function that makes one Newton solve's three solves of the K of
    ``args`` on ``route`` (right-hand sides rhs, rhs reversed, rhs / 2):
    with ``kept``, one launch and two substitutions on its factor (the
    global route only), else a launch of kernel 3 each."""
    Q, A, w, sigma, rhs = args
    sides = (rhs, rhs.flip(1), 0.5 * rhs)
    if not kept:
        return lambda: [cs.on_route(fk, "kkt_solve", route,
                                    (Q, A, w, sigma, r), tuple(A.shape))
                        for r in sides]

    def solves():
        select, fk.kernel_route = fk.kernel_route, lambda *a: "global"
        try:
            solver = fk.fused_kkt_solver(Q, A, w, sigma)
        finally:
            fk.kernel_route = select
        return [solver(r) for r in sides]
    return solves


def time_newton(cs, fk, kernels):
    """The three solves of one Newton solve at NEWTON_SHAPES on each route
    (module docstring), in turns."""
    rows = []
    for b, m, n in NEWTON_SHAPES:
        args = cs.card_kkt_inputs((b, m, n), seed=n)
        ways = {"global kept": refined_solves(cs, fk, "global", args, True),
                "global each": refined_solves(cs, fk, "global", args, False)}
        if b <= kernels.max_active_clusters(n):
            ways["cluster each"] = refined_solves(cs, fk, "cluster", args,
                                                  False)
        same = all(torch.equal(x, y) for x, y in
                   zip(ways["global kept"](), ways["global each"]()))
        times = {way: [] for way in ways}
        for way in list(ways) + list(reversed(ways)):
            times[way].append(round(cs.device_ms(ways[way], calls=3,
                                                 replays=3), 5))
        row = dict(B=b, m=m, n=n, selected=fk.kernel_route("kkt_solve", b, n),
                   same_bits=same, device_ms={w: min(t) for w, t in
                                              times.items()}, runs=times)
        print(f"time_kkt_global newton: {row}", flush=True)
        rows.append(row)
        if not same:
            raise SystemExit(f"the kept factor gave other bits at {(b, m, n)}")
        del args, ways
        torch.cuda.empty_cache()
    return rows


def build_variant(kernels, src: Path, formation: Path, tag: str):
    """``src`` (a kkt_solve_cluster.cu) and ``formation`` built into one
    library under build/kkt_cluster_variants/."""
    work = HERE / "build" / "kkt_cluster_variants"
    work.mkdir(parents=True, exist_ok=True)
    out = work / f"lib{tag}.so"
    cmd = [kernels.find_nvcc(), *kernels.NVCC_FLAGS, f"-I{src.parent}",
           f"-I{formation.parent}", "-shared", "-o", str(out), str(src),
           str(formation)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stderr[-4000:])
    lib = ctypes.CDLL(str(out))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    lib.qpdo_chol_solve_cluster_f32.argtypes = [ptr] * 4 + [i] * 3 + [ptr]
    return lib


def time_variants(cs, fk, ff, kernels, sources):
    """chol_solve_cluster of each source in ``sources`` (tag: path) at
    VARIANT_SHAPES, in turns (the order, then backwards)."""
    formation = kernels.CSRC / "formation.cu"
    libs = {tag: build_variant(kernels, Path(src), formation, f"v{k}")
            for k, (tag, src) in enumerate(sources.items())}
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for b, m, n in VARIANT_SHAPES:
        Q, A, w, sigma, rhs = cs.kkt_inputs(seed=n, shape=(b, m, n))
        Khat, bhat, _ = cs.scaled_system(fk, ff, Q, A, w, sigma, rhs)
        xref = fk.reference_chol_solve(Khat, bhat)
        out = torch.empty_like(bhat)
        work = torch.empty(fk.cluster_work_floats("chol_solve", b, n),
                           device=bhat.device)

        def call(lib):
            return lib.qpdo_chol_solve_cluster_f32(
                Khat.data_ptr(), bhat.data_ptr(), out.data_ptr(),
                work.data_ptr(), b, n, 0, stream)

        for tag in list(libs) + list(reversed(libs)):
            if call(libs[tag]) != 0:
                raise SystemExit(f"{tag}: the launch failed at {(b, m, n)}")
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            ms = []
            for _ in range(3):
                start.record()
                for _ in range(20):
                    call(libs[tag])
                end.record()
                torch.cuda.synchronize()
                ms.append(start.elapsed_time(end) / 20)
            row = dict(variant=tag, B=b, m=m, n=n,
                       error=cs.rel_err(out, xref), ms=ms)
            print(f"time_kkt_global variant: {row}", flush=True)
            rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kkt_global: needs a CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    variants = [a for a in args if a.endswith(".cu")]
    roots = [a for a in args if not a.endswith(".cu")]
    root = Path(roots[0]).resolve() if roots else HERE
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_kkt as fk
    if Path(fk.__file__).resolve().parents[2] != root:
        raise SystemExit(f"imported {fk.__file__}, not the package of {root}")
    from qpdo_tpu_torch import kernels

    clusters = hasattr(fk, "cluster_work_floats")   # this PR's route
    rows = []
    shapes = ((cs.B, cs.M, cs.N), (32, 300, 200), *cs.LARGE_KKT_SHAPES,
              *(LIMIT_SHAPES if clusters else ()))
    for n in sorted({n for _, _, n in shapes if clusters and n > 239}):
        print(f"time_kkt_global: n={n}: cluster of {kernels.cluster_size(n)}"
              f" blocks, {kernels.max_active_clusters(n)} at once", flush=True)
    for b, m, n in shapes:
        seed = 6 if n == cs.N else (16 if n == 200 else n)
        Q, A, w, sigma, rhs = cs.kkt_inputs(seed=seed, shape=(b, m, n))
        Khat, bhat, _ = cs.scaled_system(fk, ff, Q, A, w, sigma, rhs)
        for name, args, sizes, kernel in (
                ("kkt_solve", (Q, A, w, sigma, rhs), (b, m, n),
                 lambda: fk.fused_kkt_solve(Q, A, w, sigma, rhs)),
                ("chol_solve", (Khat, bhat), (b, n),
                 lambda: fk.chol_solve_stacked(Khat, bhat))):
            selected = (fk.kernel_route(name, b, n) if clusters
                        else fk.kernel_route(name, n))
            calls = {selected: kernel}
            if (clusters and kernels.cluster_size(n)
                    and selected in ("cluster", "global")):
                other = "global" if selected == "cluster" else "cluster"
                calls[other] = (lambda name=name, other=other, args=args,
                                sizes=sizes: cs.on_route(fk, name, other,
                                                         args, sizes))
            for route, call in calls.items():
                times = [round(cs.device_ms(call, calls=20, replays=3), 5)
                         for _ in range(5)]
                row = dict(name=name, route=route,
                           selected=route == selected, B=b, m=m, n=n,
                           device_ms=min(times), runs=times)
                print(f"time_kkt_global {root.name}: {row}", flush=True)
                rows.append(row)
    newton = (time_newton(cs, fk, kernels)
              if hasattr(fk, "fused_kkt_solver") else [])
    timed = {}
    if clusters:
        sources = {"this source": kernels.CSRC / "kkt_solve_cluster.cu"}
        sources.update({f"{Path(v).name} ({k})": v
                        for k, v in enumerate(variants)})
        timed = time_variants(cs, fk, ff, kernels, sources)
    print(cs.card_line())
    print(json.dumps({"root": str(root), "rows": rows, "newton": newton,
                      "variants": timed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
