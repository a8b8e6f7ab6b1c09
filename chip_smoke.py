#!/usr/bin/env python3
"""Drive the PyTorch port (qpdo_tpu_torch) once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA device and nvcc:

    python3 chip_smoke.py [--seed SEED]

Phases (any failure raises and exits non-zero):

1. Print the card's name and power limit (nvidia-smi) and build the CUDA
   kernels from qpdo_tpu_torch/csrc with nvcc.
2. Formation kernel against its plain PyTorch version on the card, at the
   bench shape (B=256, m=150, n=100), float32 and float64: max error
   relative to max|K| <= 1e-5 (f32) and 1e-12 (f64).
3. Residual kernel against its plain version, float32 and float64, at
   B=256 and B=4096 (m=150, n=100): every output equal bit for bit (the
   kernel rounds each operation as the plain version does, in the same
   order; a failure message reports the largest relative error beside the
   former tolerance, rtol 1e-6 / 1e-13).
4. The main path: the bench problem family (bench.py:341-352, B=256,
   n=100, m=150, seed 0) solved by ``qpdo_tpu_torch.solve_batch(...,
   compact=True)`` on cuda:0 with the bench settings plus both kernel
   flags.  Every problem SOLVED, the numpy float64 KKT oracle of
   bench.py:482-490 at rp, rd <= 1.1e-6, both kernels launched during the
   run, results on the card.  A small batch is also solved on the card and
   on the CPU (plain versions) and must agree in status and, within 3, in
   iteration counts.  Then 3 timed runs.
5. Time per call at the bench shape (the residual kernel also at
   B=4096; formation and residuals in float32 and float64): each kernel
   beside its plain version and beside the library route for the same
   function (cuBLAS and
   ``torch.linalg`` calls: for the fused KKT solve, formation kernel ->
   ``jacobi_cholesky`` -> two triangular solves), with the least time the
   card could take for the same bytes and operations.  ``ms`` is what the
   solver loop sees (back-to-back eager calls: the host's issue time once a
   kernel is faster than its wrapper; the residual wrapper writing into
   buffers handed in, as the loop calls it, and ``ms_allocating`` making
   its outputs); ``device_ms`` is the kernel's time with the host out of
   the way (replays of a CUDA graph that captured 100 calls of the
   wrapper).  For the residual kernel also ``cold_device_ms`` (the calls
   rotate through input sets that hold more than twice the L2, so every
   call reads its inputs from HBM) and ``context_device_ms``, the part of
   a solver step around it (zeros_like(sigma) -> kernel -> res_dual_in -
   Aty, solver/core.py) beside ``context_base_device_ms``, the same two
   ATen kernels without it.
6. The fused KKT-solve kernel and the Cholesky-solve kernel against their
   plain versions at B=256, m=150, n=100, float32: max error relative to
   max|dx| <= 2e-5 (found: 1.5e-6 to 4.2e-6; the same recurrences summed
   in another order).  The composition formation kernel -> Jacobi scale and
   shift -> Cholesky-solve kernel -> unscale against the fused kernel, same
   tolerance.  One problem made indefinite and one with a NaN in rhs:
   kernel and plain version agree on which problems come back non-finite,
   and the other problems are untouched.  Both kernels also at n=200, the
   shared-memory route that serves 128 < n <= 220 (239), against their
   plain versions, same tolerance.
   6b. Both kernels above the shared-memory route (n above 220 and 239)
   at ``LARGE_KKT_SHAPES`` (B=8, n=256 and 512, m = 1.5 n, phase 7b's
   shape, one and two problems at n=1024, one at n=512), on the route that
   B and n select: the cluster route (a thread-block cluster a problem, K
   in the blocks' shared memory, one launch after kernel 1) for a few
   problems, else the global-memory route (a sequence of panel and
   trailing-update launches); against their plain versions and the
   composition, same tolerance, the same bits from a second call,
   failures kept in their problem, the route's launches counted; the
   other route against the plain versions too; kernel 1 at (8, 768, 512)
   against its plain version; both routes' times beside the library route
   and the bound, and the clusters the card holds at once.  Then both
   kernels at one problem of odd n (``ODD_KKT_SHAPES``: n = 221, 243 and
   1001, B n^2 odd) on the route each selects, against their plain
   versions and twice for the same bits.  At the global-route shapes and
   at ``RESOLVE_SHAPE`` (the benchmark cell's), kernel 3's factor kept for
   another right-hand side (``fused_kkt_solver``: one launch, then
   ``kkt_resolve_global``): the bits of ``fused_kkt_solve`` for both
   right-hand sides, the plain version's tolerance (or twice the plain
   version's distance from the float64 solution where K's conditioning
   makes that larger), one substitution counted, and its times beside the library route (two triangular solves
   on a kept ``cholesky_ex`` factor) and its bound.
7. The second path: the same family through ``solve_batch(...,
   compact=True)`` with ``kkt_dtype="float32", mu_min=1e-7,
   refine_steps=2, pallas_kkt=True, pallas_residuals=True`` (float64
   state, no warmup): every Newton solve is the fused kernel, three
   launches per step.  Same gate as phase 4, the fused kernel launched,
   results on the card; then a warm-started re-solve (q perturbed from a
   seed, x0/y0 the previous solution), same gate; 3 timed runs.
   7b. The same settings on the bench family at B=64, n=300, m=450: every
   Newton solve kernel 3's global route (its launches counted and
   required), every problem SOLVED within the oracle at 1.1e-6.
   7c. One QP of n=200, m=50,000 (phase 16b's family) through ``solve``
   with those settings less ``pallas_kkt``: every K formed by kernel 1 in
   float32 with its rows split over blocks (counted and required), SOLVED
   within the oracle at 1.1e-6.
   7d. One dense QP of n=1,024, m=1,536 (``random_qp``) with phase 7's
   settings through ``solve``, then ``QPDO`` (setup, a cold solve, a warm
   re-solve after a 1% change of q): every Newton solve kernel 3's cluster
   route (counted and required), SOLVED within the oracle at 1.1e-6,
   iterations and wall times printed; the three infeasibility problems of
   ``examples/infeasibility_tests.m`` through ``solve`` on the card and
   the CPU under ``Settings(max_iter=100)`` and phase 7's settings, held
   to [SOLVED, PRIMAL_INFEASIBLE, DUAL_INFEASIBLE].
8. The stateful entry point: ``QPDO().setup(...)`` of one n=100, m=150
   problem with no device argument (so the card), solve, warm_start,
   update_q, update_bounds, solve; results on the card, same oracle.
9. The dense modes at full width (the bench family, B=256, n=100, m=150,
   seed 0; ``variants``): the bench settings with polish (and warmup_eps
   1e-3), with ``kkt_solver`` "inv", with "cg", with the incremental KKT
   cache (``kkt_update_rows=16``), with the fused right-hand side, with
   the chunked bisection; the phase 7 settings with the fused right-hand
   side (kernel 3); the library-default float64 ``Settings()`` with
   "inv", with "cg" and with ``accel_gamma=0.5`` (the float64 formation
   kernel; both "cg" variants at B=64: each took more than 30 s at
   B=256).  Each through ``solve_batch(..., compact=True)``, kernel
   counts set to 0 just before and read just after: every problem SOLVED
   with the oracle at 1.1e-6, the kernels its line names launched, and the
   16-problem batch of phase 4 on the card and on the CPU with equal
   statuses and iterations within 3, except on the problems of
   ``ROUNDING_SENSITIVE``, whose counts rounding moves by more than 3 in
   the JAX package or the port on the CPU: those are held to their status.
10. The host-driven loop: problem 0 of the family through ``QPDO`` with
   the phase 7 settings, three ways: ``verbose=True, print_interval=10``
   (the table is printed; the same iterations as the silent solve),
   ``eps_abs=1e-14, max_time=1e-3`` (MAX_TIME_REACHED) and
   ``max_time=60`` (SOLVED, the silent solve's iterations).

11. The differentiable layer ``qp_solve`` on the bench family at
   ``Settings()`` (float64): the forward pass every problem SOLVED (the
   statuses of ``solve_batch`` on the same tensors) with the oracle at
   1.1e-6, the float64 formation and residual kernels launched; the
   gradients of a seeded loss in Q, q, A, l and u held against the port on
   the CPU (first 8 problems, ``GRAD_CPU_RTOL``) and, in q and u, against
   central differences at eps_abs 1e-10 (rtol 2e-3, atol 5e-4, as
   tests/test_diff.py) on those of the first 16 problems whose three
   solves end SOLVED (at least half); forward mode against reverse mode,
   <g, J t> = <J' g, t> to ``DUALITY_RTOL``.  Forward, backward and jvp
   wall times.
12. ``SolverService(max_batch=64, max_wait_ms=5)`` at the library
   defaults: 512 requests of the bench family with n in 60-100 and m in
   90-150 (``--seed``), from 8 threads, each thread's first request under
   a session and re-sent with q moved after its answer (a warm hit each);
   every request SOLVED with the oracle at 1.1e-6; 16 of them against
   direct ``solve`` calls of the unpadded problems (equal statuses,
   iterations and x within ``SERVE_ITER_BAND`` and ``SERVE_X_BAND``).
   Requests/s, latency p50/p99, mean batch size, the counters.
13. ``applications``: lasso, portfolio and mpc_condensed at the sizes of
   tests/test_applications.py on the card against the CPU (x within
   ``APP_X_BAND``), ``sqp_minimize`` on the constrained Rosenbrock
   problem; ``Settings(pallas_kkt=True)`` at kkt_dtype None on 16 problems
   of the family: no launch of the fused kernel and results bit for bit
   those of ``pallas_kkt=False``; n=221 with ``pallas_kkt`` and a float32
   KKT (once refused at setup) solved through kernel 3's global route,
   within the oracle.
14. Files, the command line, the utilities and the sparse path (PHASE14_*
   sizes): (a) ``main([...])`` of ``python -m qpdo_tpu_torch`` in-process
   on HS21 with its objective constant, HS35, HS51 and bench problem 0
   (written by the port's ``write_qps``), then the same files through a
   subprocess: every file SOLVED, the three optima within 1e-6, problem 0
   within the numpy oracle at 1.1e-6, the float64 formation and residual
   kernels launched, exit code 0; (b) the n=10,000 instance of
   examples/large_sparse.py written as QPS and parsed by ``read_qps`` and
   ``read_qps_native`` (arrays equal, both parse times); (c) that instance
   (n=10,000, m=15,000, seed 0) through ``solve_sparse`` on the card at
   ``Settings()`` and through ``python -m qpdo_tpu_torch --sparse``: SOLVED,
   the example's KKT residuals at 1.1e-6, the residual kernel launched;
   wall time, iterations, CG iterations per Newton step, one ``Amv`` and
   one ``Atmv``, the residual kernel at B=1 of this shape; card against CPU
   on an n=500 instance of the generator: the same status (the count is
   printed: rounding moves it by up to 5 at n=1,000 on the CPU,
   scripts/sparse_cg_sensitivity.py, so by phase 9's rule the problem is
   held to its status) and x within ``CARD_CPU_X_BAND``; the ordered
   segment sum kernel launched (every sum into a shared target adds in
   map order); (d) a second-difference banded problem
   (benchmarks/fuzz_sparse.py kind 0) at n=500 through ``solve_sparse``
   at the defaults: the banded route (``newton_exact``; "auto" is cyclic
   reduction on the card), SOLVED, oracle at 1.1e-6, time per Newton
   step, and solved again: the same bits (x, y, iterations); (e) fleets:
   ``solve_sparse_batch`` of
   64 same-pattern n=1,000 instances, of 8 mixed patterns (union), and
   ``solve_sparse_heterogeneous`` of 8 sizes in 600-1,000: every problem
   SOLVED within the oracle; then the formation, residual and ordered
   segment sum kernels against their plain versions at every (dtype,
   shape) that (a) and (c)-(e) gave them on the card (recorded around the
   solver's calls, with the segment map), on fresh inputs of each shape,
   with the tolerances of phases 2 and 3 (the segment sum bit for bit
   against index_add_ on the CPU); (f) ``PhaseTimer`` around a solve at
   least the solve's device time, that solve the same bits as 14c's,
   ``trace`` writes a profiler file, a CUDA Result
   survives ``save_result``/``load_result`` bit for bit, back on the card.
   14c also times the residual kernel's plain version (its library route)
   at B=1 of its shape.
15. The rest of the sparse path and the structured path (PHASE15_* sizes,
   float64 state, ``Settings()`` unless stated): (a) the second-difference
   problem at n=2,000 through ``banded_algo="auto"`` (cyclic reduction,
   counted around ``SparseOperator._banded_factor_cr``), SOLVED within the
   oracle, ms a Newton step and the CR levels; at n=500 through "cr" and
   "scan": the same status and x within ``CR_SCAN_X_BAND`` of max|x|;
   (b) the LISWET ladder of examples/continuation.py (500, 1,000, 2,000,
   4,000; its settings, ``refine_final``) with the float64 factor, and
   with ``kkt_dtype="float32", mu_min=1e-9, refine_steps=3`` on the
   ladder 500, 1,000 (``PHASE15_LADDER_F32_N``), the scan fallbacks and
   escalations counted: the finest level SOLVED within the oracle at
   1.1e-6; (c) a two-stage stochastic QP (S=128, n0=20, ns=40, ms=60,
   ``--seed``) through ``solver.structured``: SOLVED within a blockwise
   numpy KKT oracle at 1.1e-6; at S=16 against ``to_dense_problem`` and
   the dense ``solve``: the same status, x within ``DENSE_X_BAND``;
   (d) ``sparse_qp_layer`` on the n=1,000 instance of
   examples/large_sparse.py at ``LAYER_DIFF_MU`` on the card and on the
   CPU: both forward solves within the oracle, both adjoint CG solves
   converged to 1e-10, the card's five gradients within
   ``LAYER_GRAD_RTOL`` of the CPU's; ``lasso_sparse`` and
   ``huber_sparse`` of a 5,000 x 2,000 F (0.5% dense) SOLVED within the
   oracle; (e) an n=1,000 instance with ``cg_dtype="float32"`` (the
   float32 segment sums launched), SOLVED within the oracle;
   ``Amv``/``Atmv`` at 14c's shape through the ELL maps and through the
   scatter (times, and their difference); 14c's solve again: the same
   bits as 14c's (x, y, iterations, every CG solve's count and
   residual); the ordered segment sum timed at 14c's shape beside its
   plain version, ``index_add_`` and its bound; then the kernels against
   their plain versions at every shape (a)-(e) gave them.
16. The distributed paths, in child processes of this script
   (``--phase16-child``, started with the environment ``torchrun`` sets
   and joined by ``multihost.initialize()``; the parent joins no group
   and builds the kernels first): 2 ranks over gloo on the one card
   (NCCL refuses two ranks on one GPU) and 1 rank over NCCL, every child
   under a process-group and a process time limit; a failed child fails
   the phase.  (a) the bench family of phase 4 through ``solve_batch``
   of ``shard_problems`` with compaction (phase 4's path, split) and
   through ``solve_batch_sharded``, and each rank's own problems (seeds
   100+rank) through ``distribute_batch`` + ``solve_batch``: every
   problem SOLVED within the oracle, phase 4's statuses (the iteration
   gap to phase 4 printed), and each rank's block of the uncompacted
   solve bit for bit the unsharded solve of the same problems in a batch
   of that size (the card's batched float32 GEMMs round by batch size);
   (b, gloo) one
   QP of n=200, m=100,000 (and 100,001: a padded row) through
   ``solve_row_sharded``: SOLVED within the oracle on the whole A, the
   padded tail of y exactly 0, x bit-identical on both ranks, and at
   m=100,000 the unsharded solve's iterations with x within
   ``ROW_X_BAND`` of max|x|; (c) ``arrow_solve_sharded`` at phase 15c's
   shape against ``arrow_solve`` within ``ARROW_RTOL``; (d) phase 15c's
   problem with its scenarios split: the unsharded iterations, x within
   ``STRUCTURED_X_BAND``; (e) phase 14e's fleet at n=1,000, cut to 16
   problems, over the mesh: SOLVED within the oracle; (f) 64 requests
   through ``SolverService(mesh=)`` submitted on rank 0: SOLVED within the
   oracle, x within ``SERVE_X_BAND`` of direct solves.  Kernels 1 and 2
   must launch on the batch-sharded and row-sharded paths (kernel 1 with
   its rows split on the row-sharded ones), and are held against their
   plain versions at every shape the children gave them; kernel 1 is
   timed at B=1, n=200 and m = 50,000 (a rank's rows) and 100,000 (the
   unsharded solve's), in both dtypes, with its number of row chunks S,
   beside its library route and bound, against its plain version, and
   bit for bit against a second call.

The line before the last is a JSON object with one entry per kernel and
dtype (formation, residuals and the ordered segment sum "ordered_sum" in
both dtypes), and one per added route
("formation_split" in both dtypes, "kkt_solve_global",
"chol_solve_global", "kkt_resolve_global", "kkt_solve_cluster",
"chol_solve_cluster"), with its
launches on the path that runs it first and on each path (phases 6b, 7b,
7c and 7d add "composition_large", "pallas_kkt_n300", "tall_f32" and
"pallas_kkt_n1024"; phase 15 adds "cr",
"continuation", "structured", "sparse_layer", "sparse_applications" and
"sparse_cg_f32"; phase 16 adds "batch_sharded_compact_gloo",
"batch_sharded_gloo", "distribute_batch_gloo", "row_sharded_m100000",
"row_sharded_m100001", "structured_sharded", "sparse_fleet_mesh",
"serve_mesh", "batch_sharded_compact_nccl", "batch_sharded_nccl" and
"distribute_batch_nccl", summed over the ranks; the "formation_split"
entries hold phase 16's timings of kernel 1 under "shapes"); the last
line is
{"ok": true, "device": {...}}.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np
import torch

B, N, M = 256, 100, 150
DEVICE = "cuda:0"
# batches at which the residual kernel is checked and timed: the bench
# batch, and one large enough that memory, not the launch, bounds it
RESIDUAL_BATCHES = (B, 4096)
F32, F64 = torch.float32, torch.float64
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 and float64 FLOP/s
# outside the tensor cores, and the bytes of its L2 cache
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 34e12
# float64 on the tensor cores (mma .f64), which kernel 1's split route uses
PEAK_F64_TENSOR = 67e12
L2_BYTES = 50e6
# the kernels against their plain versions (phases 2, 3 and 14): the
# formation's error relative to max|K|, and the residual tolerance that the
# bit-for-bit check replaced (printed when it fails)
FORMATION_TOL = {F32: 1e-5, F64: 1e-12}
RESIDUAL_RTOL = {F32: 1e-6, F64: 1e-13}
# kernels 3 and 4 above the shared-memory route (phase 6b), on the route
# that B and n select (cluster or global), the other route timed beside it:
# (B, m, n) at n = 256 and 512 with m = 1.5 n, the shape phase 7b's solve
# gives them, one and two large problems (n = 1024, a cluster of 16
# blocks each), and one problem at n = 512 (a cluster of 8)
LARGE_KKT_SHAPES = ((8, 384, 256), (8, 768, 512), (64, 450, 300),
                    (1, 1536, 1024), (2, 1536, 1024), (1, 768, 512))
# phase 6b: one problem of odd n (B n^2 odd: K's share of the cluster
# route's workspace is padded so that the panel buffer after it stays
# aligned), on the route each kernel selects
ODD_KKT_SHAPES = ((1, 332, 221), (1, 366, 243), (1, 1502, 1001))
# phase 6b: kernel 3's kept factor (kkt_resolve_global) at the shape of
# the benchmark's cell, 1,024 OSQP Portfolio QPs at k = 5 (B, m, n), its
# inputs made on the card
RESOLVE_SHAPE = (1024, 506, 505)
# phase 7b: the pallas_kkt path above the shared-memory route (B, n, m)
PHASE7B = (64, 300, 450)
# phase 7d: one large dense QP, random_qp(n, m, seed=0) (n, m)
PHASE7D = (1024, 1536)


def parse_args():
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of phase 12's request sizes and data")
    parser.add_argument("--phase16-child", metavar="BACKEND",
                        help="run as one rank of phase 16 (the script "
                        "starts these itself)")
    return parser.parse_args()


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


def timed(fn, reps):
    """``time_ms`` with a warm-up of a tenth of the calls (at least 2)."""
    return time_ms(fn, reps=reps, warmup=max(2, reps // 10))


def device_ms(*fns, calls=100, replays=5):
    """Mean time per call on the card with the host out of the way: ``calls``
    calls, taking the functions ``fns`` in turn, are captured into one CUDA
    graph and the graph is replayed."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(calls):
            fns[k % len(fns)]()
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


def formation_work(b, m, n):
    """Kernel 1's work at (b, m, n): the elements it must move (A, w, Q
    and sigma read once, K written once) and its operations: K is
    symmetric, so its product is one multiply-add per row of A and entry
    on or above the diagonal, m * n * (n + 1) operations a problem."""
    return b * m * n + b * m + 2 * b * n * n + b, b * m * n * (n + 1)


def kkt_work(name, b, m, n):
    """Kernel 3's or 4's work at (b, m, n), in float32: the elements it
    must move (each input read once, dx written once) and its operations
    (the symmetric product, the Jacobi scale, the n^3/3 factor, two n^2
    substitutions)."""
    if name.startswith("kkt_solve"):
        return (b * n * n + b * m * n + b * m + b + 2 * b * n,
                b * (m * n * (n + 1) + n ** 3 // 3 + 4 * n * n))
    return b * n * n + 2 * b * n, b * (n ** 3 // 3 + 2 * n * n)


def kkt_library_route(ff, tl, Q, A, w, sigma, rhs):
    """Kernel 3's function by the formation kernel and torch.linalg
    (``jacobi_cholesky``, two triangular solves)."""
    def run():
        K = ff.fused_formation(A, w, Q, sigma)
        chol, di = tl.jacobi_cholesky(K)
        return tl._prescaled_tri_solver(chol, di, F32)(rhs)
    return run


def chol_library_route(Khat, bhat):
    """Kernel 4's function by ``cholesky_ex`` and two triangular solves."""
    def run():
        chol = torch.linalg.cholesky_ex(Khat)[0]
        z = torch.linalg.solve_triangular(chol, bhat[..., None], upper=False)
        return torch.linalg.solve_triangular(chol.mT, z, upper=True)
    return run


def bound_ms(nbytes, flops, peak_flops=PEAK_F32):
    """The least time for that many bytes (each input read once, each
    output written once) and operations, and which of the two sets it."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def kkt_inputs(seed=6, shape=None):
    """Float32 inputs of the fused KKT solve, ``shape`` = (B, m, n): the
    bench shape unless told otherwise."""
    b, m, n = shape or (B, M, N)
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((b, n, n))
    arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
              rng.standard_normal((b, m, n)), rng.random((b, m)),
              np.full(b, 1e-3), rng.standard_normal((b, n)))
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


def formation_inputs(dtype, seed=3, b=B, m=M, n=N):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((b, m, n))
    w = rng.random((b, m))
    Mx = rng.standard_normal((b, n, n))
    Q = np.einsum("bij,bkj->bik", Mx, Mx) / n
    sigma = rng.random(b) * 0.1
    return [torch.as_tensor(a, dtype=dtype, device=DEVICE)
            for a in (A, w, Q, sigma)]


def residual_inputs(dtype, seed=4, b=B, m=M, n=N):
    rng = np.random.default_rng(seed)
    d = lambda *s: rng.standard_normal(s)
    E = rng.random((b, m)) + 0.5
    arrays = (d(b, m), d(b, m), rng.random((b, m)) + 0.1, d(b, m),
              -(rng.random((b, m)) + 0.2), rng.random((b, m)) + 0.2,
              E, 1.0 / E, d(b, n), d(b, n), d(b, n), d(b, n), d(b, n),
              rng.random((b, n)) + 0.5, rng.random(b) * 0.1,
              rng.random(b) + 0.5)
    return [torch.as_tensor(a, dtype=dtype, device=DEVICE) for a in arrays]


RESIDUAL_NAMES = ("res_prim", "res_prim_in", "w", "active", "res_dual_in",
                  "rp", "rd", "rpi", "rdi")
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}


def bitwise_differs(out, ref):
    """The names of the residual outputs whose bits differ."""
    return [name for name, a, b in zip(RESIDUAL_NAMES, out, ref)
            if a.shape != b.shape or a.dtype != b.dtype
            or not torch.equal(a.view(_BITS[a.dtype]), b.view(_BITS[b.dtype]))]


def residual_bound(b, m, n, dtype):
    """The residual block's bound: 16 inputs read and 9 outputs written
    once (12 m + 7 n + 6 words a problem), about 22 operations per dual
    entry and 10 per primal entry."""
    size = torch.empty((), dtype=dtype).element_size()
    peak = PEAK_F32 if dtype == F32 else PEAK_F64
    nbytes = size * (12 * b * m + 7 * b * n + 6 * b)
    return bound_ms(nbytes, 22 * b * m + 10 * b * n, peak) + (nbytes,)


def residual_times(fr, dtype, b):
    """Times of the residual kernel of the package ``fr`` (a checkout's
    ``qpdo_tpu_torch.ops.fused_residuals``) at (b, M, N) in ``dtype``, by
    the public wrapper only, so that another commit's package can be timed
    the same way (scripts/time_residuals.py): ``ms`` as the solver loop
    calls it (into buffers handed in, where the package has that path),
    ``ms_allocating``, ``device_ms`` (warm: the same inputs every call),
    ``cold_device_ms`` (inputs read from HBM), ``context_device_ms`` and
    ``context_base_device_ms`` (the step around it, with and without the
    kernel), the plain version's ``plain_ms`` and
    ``library_route_device_ms``."""
    args = residual_inputs(dtype, b=b, m=M, n=N)
    kernel = lambda: fr.fused_residuals(*args)
    r = dict(B=b, ms_allocating=time_ms(kernel))
    if hasattr(fr, "kernel_outputs"):
        out = fr.kernel_outputs(b, M, N, dtype, args[0].device)
        r["ms"] = time_ms(lambda: fr.fused_residuals(*args, out=out))
    else:
        r["ms"] = r["ms_allocating"]
    r["device_ms"] = device_ms(kernel)
    size = torch.empty((), dtype=dtype).element_size()
    input_bytes = size * (8 * b * M + 6 * b * N + 2 * b)
    sets = [args] + [residual_inputs(dtype, seed=5 + k, b=b, m=M, n=N)
                     for k in range(int(-(-2 * L2_BYTES // input_bytes)))]
    r["cold_device_ms"] = device_ms(
        *[lambda a=a: fr.fused_residuals(*a) for a in sets])
    del sets
    # solver/core.py:180-188 on the bench path: sig_eff, the block, df
    rdi = fr.reference_residuals(*args)[4]

    def step_part():
        sig = torch.zeros_like(args[14])
        return fr.fused_residuals(*args[:14], sig, args[15])[4] - args[10]

    def step_base():
        torch.zeros_like(args[14])
        return rdi - args[10]

    r["context_device_ms"] = device_ms(step_part)
    r["context_base_device_ms"] = device_ms(step_base)
    plain = lambda: fr.reference_residuals(*args)
    r["plain_ms"] = time_ms(plain)
    r["library_route_device_ms"] = device_ms(plain)
    return r


def check_formation(ff, dtype, tol, b=B, m=M, n=N):
    args = formation_inputs(dtype, b=b, m=m, n=n)
    K = ff.fused_formation(*args)
    ref = ff.reference_formation(*args)
    torch.cuda.synchronize()
    err = (K - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if not (rel <= tol):
        raise AssertionError(f"formation {dtype} B={b} m={m} n={n}: rel err "
                             f"{rel:.3e} > {tol}")
    return err, rel


def check_residuals(fr, dtype, b, rtol, m=M, n=N):
    """The kernel against its plain version: every output bit-identical."""
    args = residual_inputs(dtype, b=b, m=m, n=n)
    out = fr.fused_residuals(*args)
    ref = fr.reference_residuals(*args)
    torch.cuda.synchronize()
    differs = bitwise_differs(out, ref)
    if differs:
        worst = max(((a - c).abs() / c.abs()).max().item()
                    for a, c in zip(out, ref))
        raise AssertionError(
            f"residuals {dtype} B={b} m={m} n={n}: {differs} differ from "
            f"the plain version (largest relative error {worst:.3e}; the "
            f"former tolerance was rtol {rtol})")
    return max((a - c).abs().max().item() for a, c in zip(out, ref))


def main() -> int:
    args = parse_args()
    seed = args.seed
    if args.phase16_child:
        return phase16_child(args.phase16_child, seed)
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
    t_start = time.perf_counter()
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
    max_err = {}
    for dtype in (F32, F64):
        ftol, rtol = FORMATION_TOL[dtype], RESIDUAL_RTOL[dtype]
        err, rel = check_formation(ff, dtype, ftol)
        max_err[("formation", dtype)] = err
        print(f"phase 2: formation {dtype}: max abs err {err:.3e}, "
              f"relative to max|K| {rel:.3e} (tol {ftol})")
        for b in RESIDUAL_BATCHES:
            err = check_residuals(fr, dtype, b, rtol)
            max_err[("residuals", dtype)] = max(
                max_err.get(("residuals", dtype), 0.0), err)
            print(f"phase 3: residuals {dtype} at B={b} m={M} n={N}: all "
                  f"nine outputs bit-identical to the plain version (max "
                  f"abs err {err:.3e})")

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
    path_launches = {"bench_ns": launch_counts(ff, fr, fk)}
    phase4_ref = dict(status=res.info.status_val.cpu().tolist(),
                      iterations=res.info.iterations.cpu().tolist())
    print(f"phase 4: first solve {first_s:.2f} s, kernel launches "
          f"{printable(path_launches['bench_ns'])}")
    if not on_card(res.x, res.y, res.info.status_val):
        raise AssertionError("results are not on the card")
    require_launched(path_launches["bench_ns"], "phase 4",
                     ("formation", F32), ("residuals", F32),
                     ("residuals", F64))
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
    max_err.update({(name, F32): err for name, err in phase6(ff, fk).items()})
    # launches of the Cholesky-solve kernel's own path (no solver calls it):
    # formation kernel -> scale -> kernel -> unscale, once
    reset_counts(ff, fr, fk)
    ka = kkt_inputs()
    Khat, bhat, dinv = scaled_system(fk, ff, *ka)
    composed = fk.chol_solve_stacked(Khat, bhat) * dinv
    torch.cuda.synchronize()
    path_launches["composition"] = launch_counts(ff, fr, fk)
    if not torch.isfinite(composed).all():
        raise AssertionError("the composition path gave non-finite results")
    require_launched(path_launches["composition"], "the composition path",
                     ("formation", F32), ("chol_solve", F32))

    # ---- phase 6b: kernels 3 and 4 above the shared-memory route ----
    errs6b, times6b, path_launches["composition_large"] = phase6b(
        ff, fr, fk, tl, card)

    # ---- phase 7: the second path, every Newton solve the fused kernel ----
    path_launches["pallas_kkt"] = phase7(pt, ff, fr, fk, d, card)
    # ---- phase 7b: the same above the shared-memory route (n=300) ----
    path_launches["pallas_kkt_n300"] = phase7b(pt, ff, fr, fk, card)
    # ---- phase 7c: one tall QP, kernel 1 in float32 with its rows split --
    path_launches["tall_f32"] = phase7c(pt, ff, fr, fk, card)
    # ---- phase 7d: one large dense QP on kernel 3's cluster route; the
    # infeasible problems ----
    path_launches["pallas_kkt_n1024"] = phase7d(pt, ff, fr, fk, card)

    # ---- phase 8: the stateful entry point, on the card by default ----
    phase8(pt, fk)

    # ---- phase 9: the dense modes at full width ----
    path_launches.update(phase9(pt, ff, fr, fk, d, card))

    # ---- phase 10: the host-driven loop ----
    path_launches["driver"] = phase10(pt, ff, fr, fk, d)

    # ---- phases 11-13: the layer, serving, applications ----
    t0 = time.perf_counter()
    path_launches["qp_solve"] = phase11(pt, ff, fr, fk, d, card)
    t11 = time.perf_counter()
    path_launches["serve"] = phase12(pt, ff, fr, fk, card, seed)
    t12 = time.perf_counter()
    path_launches["applications"] = phase13(pt, ff, fr, fk, d, card)
    print(f"phases 11, 12, 13 took {t11 - t0:.1f}, {t12 - t11:.1f}, "
          f"{time.perf_counter() - t12:.1f} s, on {card}")

    # ---- phase 14: files, the command line, utilities, the sparse path ----
    t0 = time.perf_counter()
    launches14, sparse_shape, errs14, first_solve = phase14(pt, ff, fr, fk,
                                                            card)
    path_launches.update(launches14)
    print(f"phase 14 took {time.perf_counter() - t0:.1f} s, on {card}")

    # ---- phase 15: CR, continuation, structured, the sparse layer, ELL ----
    t0 = time.perf_counter()
    launches15, errs15, sum_times = phase15(pt, ff, fr, fk, card, seed,
                                            first_solve)
    path_launches.update(launches15)
    print(f"phase 15 took {time.perf_counter() - t0:.1f} s, on {card}")

    # ---- phase 16: the distributed paths, in child processes ----
    t0 = time.perf_counter()
    launches16, errs16, tall = phase16(pt, ff, fr, fk, card, phase4_ref,
                                       seed)
    path_launches.update(launches16)
    print(f"phase 16 took {time.perf_counter() - t0:.1f} s, on {card}")
    shapes_checked = collections.defaultdict(list)
    for (name, dtype, shape), err in {**errs14, **errs15,
                                      **errs16}.items():
        max_err[(name, dtype)] = max(max_err.get((name, dtype), 0.0), err)
        if list(shape) not in shapes_checked[(name, dtype)]:
            shapes_checked[(name, dtype)].append(list(shape))

    # ---- phase 5: time per call: kernel, plain version, library route ----
    rows = phase5(ff, fr, fk, tl)
    # each kernel's launches on the path that drives it first
    first_path = {("formation", F32): "bench_ns",
                  ("formation", F64): "default_inv",
                  ("residuals", F32): "bench_ns",
                  ("residuals", F64): "bench_ns",
                  ("kkt_solve", F32): "pallas_kkt",
                  ("chol_solve", F32): "composition",
                  ("formation_split", F32): "tall_f32",
                  ("formation_split", F64): "row_sharded_m100000",
                  ("kkt_solve_global", F32): "pallas_kkt_n300",
                  ("kkt_resolve_global", F32): "pallas_kkt_n300",
                  ("chol_solve_global", F32): "composition_large",
                  ("kkt_solve_cluster", F32): "pallas_kkt_n1024",
                  ("chol_solve_cluster", F32): "composition_large",
                  ("ordered_sum", F32): "sparse_cg_f32",
                  ("ordered_sum", F64): "sparse"}
    rows += route_rows(times6b, tall)
    rows += ordered_sum_rows(sum_times)
    for key, err in errs6b.items():
        max_err[key] = max(max_err.get(key, 0.0), err)
    for t in tall:
        key = ("formation_split", getattr(torch, t["dtype"]))
        max_err[key] = max(max_err.get(key, 0.0), t["max_abs_err"])
    for r in rows:
        key = (r["name"], getattr(torch, r["dtype"]))
        r["launches"] = path_launches[first_path[key]][key]
        r["max_abs_err"] = max_err[key]
        r["path_shapes_checked"] = shapes_checked.get(key, [])
        r["launches_by_path"] = {path: counts[key]
                                 for path, counts in path_launches.items()}
        if key == ("residuals", F64):
            r["sparse_shape"] = sparse_shape
    print(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s "
          f"on {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def phase5(ff, fr, fk, tl):
    """Time every kernel beside its plain version, the library route for the
    same function and its bound: formation and residuals in float32 and
    float64 (the residual kernel at each of RESIDUAL_BATCHES), the two KKT
    kernels in float32 (the type the paths run them in), all at the bench
    shape.  Returns the rows of the kernels line."""
    t = {}
    # the plain versions of these two are their library routes: cuBLAS
    # batched GEMM, ATen elementwise and reduction kernels
    for dtype in (F32, F64):
        args = formation_inputs(dtype)
        k = lambda: ff.fused_formation(*args)
        p = lambda: ff.reference_formation(*args)
        t[("formation", dtype, B)] = dict(
            ms=time_ms(k), device_ms=device_ms(k), plain_ms=time_ms(p),
            library_route_device_ms=device_ms(p))
        for b in RESIDUAL_BATCHES:
            t[("residuals", dtype, b)] = residual_times(fr, dtype, b)
        for b in (None,) + RESIDUAL_BATCHES:
            key = ("residuals", dtype, b) if b else ("formation", dtype, B)
            print(f"phase 5: {key[0]} {dtype} at B={key[2]} m={M} n={N}: "
                  + ", ".join(f"{k} {v:.5f}" for k, v in t[key].items()
                              if k != "B"))

    Q, A, w, sigma, rhs = kkt_inputs()
    Khat, bhat, dinv = scaled_system(fk, ff, Q, A, w, sigma, rhs)
    kkt_library = kkt_library_route(ff, tl, Q, A, w, sigma, rhs)
    chol_library = chol_library_route(Khat, bhat)

    # each side is timed twice, in turns, and the smaller time kept
    for name, kernel, plain, library, single in (
            ("kkt_solve", lambda: fk.fused_kkt_solve(Q, A, w, sigma, rhs),
             lambda: fk.reference_kkt_solve(Q, A, w, sigma, rhs),
             kkt_library, None),
            ("chol_solve", lambda: fk.chol_solve_stacked(Khat, bhat),
             lambda: fk.reference_chol_solve(Khat, bhat), chol_library,
             lambda: torch.linalg.solve(Khat, bhat))):
        k1, l1 = timed(kernel, 100), timed(library, 100)
        l2, k2 = timed(library, 100), timed(kernel, 100)
        r = t[(name, F32, B)] = dict(
            ms=min(k1, k2), device_ms=device_ms(kernel),
            plain_ms=timed(plain, 3), library_route_ms=min(l1, l2),
            library_route_device_ms=None,
            library_ms=None if single is None else timed(single, 100))
        print(f"phase 5: {name} float32 at B={B} m={M} n={N}: kernel "
              f"{r['ms']:.4f} ms ({k1:.4f}, {k2:.4f}), on the card alone "
              f"{r['device_ms']:.4f} ms, plain version {r['plain_ms']:.2f} "
              f"ms, library route (torch.linalg) {r['library_route_ms']:.4f}"
              f" ms ({l1:.4f}, {l2:.4f})"
              + ("" if single is None else
                 f", torch.linalg.solve {r['library_ms']:.4f} ms"))

    # the work of one call, from the shapes: bytes with each input read and
    # each output written once, and the operations the function needs
    def work(name, dtype, b):
        if name == "residuals":
            return residual_bound(b, M, N, dtype)
        size = torch.empty((), dtype=dtype).element_size()
        peak = PEAK_F32 if dtype == F32 else PEAK_F64
        nbytes, ops = (formation_work(b, M, N) if name == "formation"
                       else kkt_work(name, b, M, N))
        return bound_ms(size * nbytes, ops, peak) + (size * nbytes,)

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
    for name, dtype in (("formation", F32), ("formation", F64),
                        ("residuals", F32), ("residuals", F64),
                        ("kkt_solve", F32), ("chol_solve", F32)):
        batches = RESIDUAL_BATCHES if name == "residuals" else (B,)
        sizes = []
        for b in batches:
            r = t[(name, dtype, b)]
            r.setdefault("library_route_ms", r["plain_ms"])
            r.setdefault("library_ms", None)
            bms, by, nbytes = work(name, dtype, b)
            print(f"phase 5: {name} {dtype} at B={b}: kernel {r['ms']:.4f} "
                  f"ms (on the card alone {r['device_ms']:.4f} ms), bound "
                  f"{bms:.5f} ms (by {by}: {nbytes / 1e6:.2f} MB)")
            sizes.append(dict(r, B=b, bound_ms=bms, bound_by=by,
                              bytes=nbytes))
        r, first = t[(name, dtype, B)], sizes[0]
        row = {"name": name, "dtype": str(dtype).replace("torch.", ""),
               "route": "cuda", "source": meta[name][0],
               "replaces": meta[name][1], "launches": 0, "max_abs_err": 0.0,
               "ms": r["ms"], "device_ms": r["device_ms"],
               "plain_ms": r["plain_ms"], "bound_ms": first["bound_ms"],
               "bound_by": first["bound_by"], "library_ms": r["library_ms"],
               "library_route_ms": r["library_route_ms"],
               "library_route_device_ms": r["library_route_device_ms"],
               "library_route": meta[name][2]}
        if len(sizes) > 1:
            row["batches"] = sizes
        rows.append(row)
    return rows


def route_rows(times6b, tall):
    """Rows of the kernels line for the routes added to kernels 1, 3 and 4:
    kernel 1 with its rows split (headline: B=1, m=50,000, n=200, a rank's
    rows of the row-sharded solve), kernels 3 and 4 on the global route
    (headline: phase 7b's shape) and on the cluster route (headline: one
    problem of n=1024); every timed shape under "shapes"."""
    rows = []
    for t in tall:
        if t["m"] != TALL_FORMATION_M[0]:
            continue
        rows.append({
            "name": "formation_split", "dtype": t["dtype"], "route": "cuda",
            "source": "qpdo_tpu_torch/csrc/formation.cu",
            "replaces": "qpdo_tpu/ops/pallas_formation.py:24",
            "launches": 0, "max_abs_err": 0.0, "ms": t["ms"],
            "device_ms": t["device_ms"], "plain_ms": t["library_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "library_route_ms": t["library_ms"],
            "library_route_device_ms": t["library_device_ms"],
            "library_route": "torch.matmul + elementwise",
            "splits": t["splits"],
            "shapes": [u for u in tall if u["dtype"] == t["dtype"]]})
    # headline shapes: kernels 3 and 4 on the global route at phase 7b's
    # shape, on the cluster route at one problem of n=1024 (phase 7d's)
    big = (1, PHASE7D[1], PHASE7D[0])
    n300 = (PHASE7B[0], PHASE7B[2], PHASE7B[1])
    meta = {"kkt_solve_global": ("qpdo_tpu/ops/pallas_kkt.py:40",
                                 "kkt_solve_large.cu", n300),
            "chol_solve_global": ("qpdo_tpu/ops/pallas_kkt.py:209",
                                  "kkt_solve_large.cu", n300),
            "kkt_solve_cluster": ("qpdo_tpu/ops/pallas_kkt.py:40",
                                  "kkt_solve_cluster.cu", big),
            "chol_solve_cluster": ("qpdo_tpu/ops/pallas_kkt.py:209",
                                   "kkt_solve_cluster.cu", big)}
    library = {"kkt_solve": "formation kernel + torch.linalg.cholesky_ex + 2 "
                            "solve_triangular",
               "chol_solve": "torch.linalg.cholesky_ex + 2 solve_triangular"}
    for name, (replaces, source, shape) in meta.items():
        head = times6b[(name, shape)]
        rows.append({
            "name": name, "dtype": "float32", "route": "cuda",
            "source": f"qpdo_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            **{k: head[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "library_route_ms",
                                    "library_route_device_ms")},
            "library_route": library[name.rsplit("_", 1)[0]],
            "shapes": [t for (nm, _), t in times6b.items() if nm == name]})
    head = times6b[("kkt_resolve_global", RESOLVE_SHAPE)]
    rows.append({
        "name": "kkt_resolve_global", "dtype": "float32", "route": "cuda",
        "source": "qpdo_tpu_torch/csrc/kkt_solve_large.cu",
        "replaces": "none: kernel 3's substitutions (qpdo_tpu/ops/"
                    "pallas_kkt.py:40) on its kept factor; the TPU path "
                    "launches kernel 3 whole for each right-hand side",
        "launches": 0, "max_abs_err": 0.0,
        **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                "bound_by", "library_ms", "library_route_ms",
                                "library_route_device_ms")},
        "library_route": "2 solve_triangular on a kept cholesky_ex factor",
        "shapes": [t for (nm, _), t in times6b.items()
                   if nm == "kkt_resolve_global"]})
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

    # the shared-memory route (128 < n): both kernels at n = 200
    big = kkt_inputs(seed=16, shape=(32, 300, 200))
    dx2 = fk.fused_kkt_solve(*big)
    ref2 = fk.reference_kkt_solve(*big)
    Khat2, bhat2, dinv2 = scaled_system(fk, ff, *big)
    x2 = fk.chol_solve_stacked(Khat2, bhat2)
    torch.cuda.synchronize()
    for what, r in (("kkt_solve vs plain", rel_err(dx2, ref2)),
                    ("chol_solve vs plain",
                     rel_err(x2, fk.reference_chol_solve(Khat2, bhat2))),
                    ("formation -> scale -> chol_solve -> unscale vs "
                     "kkt_solve", rel_err(x2 * dinv2, dx2))):
        print(f"phase 6: n=200 (shared-memory route), B=32, m=300: {what}: "
              f"max error relative to max|dx| {r:.3e} (tol {tol})")
        if not (r <= tol):
            raise AssertionError(f"phase 6: n=200: {what}: {r:.3e} > {tol}")

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
    from qpdo_tpu_torch.ops import ordered_sum

    for mod in (*modules, ordered_sum):
        for fn in vars(mod).values():
            for counter in ("launches", "split_launches", "routes"):
                if callable(fn) and hasattr(fn, counter):
                    getattr(fn, counter).clear()


def launch_counts(ff, fr, fk):
    """Launches since the last reset_counts, by (kernel, dtype)."""
    counts = {}
    for name, fn in (("formation", ff.fused_formation),
                     ("residuals", fr.fused_residuals)):
        for dtype in (F32, F64):
            counts[(name, dtype)] = fn.launches[dtype]
    counts[("kkt_solve", F32)] = fk.fused_kkt_solve.launches[F32]
    counts[("chol_solve", F32)] = fk.chol_solve_stacked.launches[F32]
    # the routes added for few problems with many rows (kernel 1) and for
    # n above the shared-memory route (kernels 3 and 4: global memory, or a
    # cluster a problem for a few problems)
    for dtype in (F32, F64):
        counts[("formation_split", dtype)] = \
            ff.fused_formation.split_launches[dtype]
    for route in ("global", "cluster"):
        counts[(f"kkt_solve_{route}", F32)] = fk.fused_kkt_solve.routes[route]
        counts[(f"chol_solve_{route}", F32)] = \
            fk.chol_solve_stacked.routes[route]
    # the global route's factor kept for a Newton solve's further right-hand
    # sides, which only substitute
    counts[("kkt_resolve_global", F32)] = fk.fused_kkt_solver.launches[F32]
    # the sparse path's sums into shared targets
    from qpdo_tpu_torch.ops import ordered_sum

    for dtype in (F32, F64):
        counts[("ordered_sum", dtype)] = \
            ordered_sum.ordered_segment_sum.launches[dtype]
    return counts


def printable(counts):
    return {f"{name} {str(dtype).replace('torch.', '')}": n
            for (name, dtype), n in counts.items()}


def require_launched(counts, what, *keys):
    missing = [k for k in keys if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: a kernel of the path was not launched:"
                             f" {printable(counts)}")


def phase7(pt, ff, fr, fk, d, card):
    """The second path at full width.  Returns the launches of its cold
    solve by (kernel, dtype)."""
    settings = pallas_kkt_settings(pt)
    problems = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                             for k, v in d.items()})
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    res = pt.solve_batch(problems, settings, compact=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = launch_counts(ff, fr, fk)
    print(f"phase 7: first solve {first_s:.2f} s, kernel launches "
          f"{printable(counts)}")
    require_launched(counts, "phase 7", ("kkt_solve", F32),
                     ("residuals", F64))
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
    return counts


def on_route(fk, name, route, args, sizes):
    """Kernel ``name`` ("kkt_solve" or "chol_solve") on ``route`` whatever
    B and n select, by the wrappers' own launch; counted on a stand-in,
    not on the wrapper (a comparison, not a path)."""
    import types

    stand_in = types.SimpleNamespace(launches=collections.Counter(),
                                     routes=collections.Counter())
    return fk._launch(name, stand_in, args, sizes, route=route)


def add_counts(total, counts):
    for key, v in counts.items():
        total[key] = total.get(key, 0) + v
    return total


def phase6b(ff, fr, fk, tl, card):
    """Kernels 3 and 4 above the shared-memory route, at LARGE_KKT_SHAPES:
    the route that B and n select (cluster or global), through the
    wrappers, against its plain version (phase 6's tolerance), twice for
    the same bits, with failures left in their problem where B > 1; the
    composition formation kernel -> scale -> kernel 4 -> unscale against
    kernel 3; the other route (where n has a cluster) against the plain
    version too; and the times of both routes beside the library route and
    the bound.  Returns the max abs errors by (route name, dtype), the
    times by (route name, shape), and the launches of the composition path
    over all shapes (the path that runs kernel 4 above the shared-memory
    route; no solver calls kernel 4)."""
    from qpdo_tpu_torch import kernels

    tol = 2e-5
    errs = {(f"{name}_{route}", F32): 0.0 for name in ("kkt_solve", "chol_solve")
            for route in ("global", "cluster")}
    times, composition = {}, {}
    for n in sorted({n for _, _, n in LARGE_KKT_SHAPES}):
        print(f"phase 6b: n={n}: cluster of {kernels.cluster_size(n)} blocks, "
              f"{kernels.max_active_clusters(n)} such clusters at once on "
              f"{card}", flush=True)

    for shape in LARGE_KKT_SHAPES:
        b, m, n = shape
        Q, A, w, sigma, rhs = kkt_inputs(seed=n, shape=shape)
        selected = {name: fk.kernel_route(name, b, n)
                    for name in ("kkt_solve", "chol_solve")}
        reset_counts(ff, fr, fk)
        Khat, bhat, dinv = scaled_system(fk, ff, Q, A, w, sigma, rhs)
        x = fk.chol_solve_stacked(Khat, bhat)
        torch.cuda.synchronize()
        add_counts(composition, launch_counts(ff, fr, fk))
        if shape == (8, 768, 512):
            # kernel 1 at this shape, against its plain version
            err, rel = check_formation(ff, F32, FORMATION_TOL[F32], b, m, n)
            errs[("formation", F32)] = err
            print(f"phase 6b: formation float32 at B={b} m={m} n={n}: error "
                  f"relative to max|K| {rel:.3e} (tol {FORMATION_TOL[F32]})")
        dx = fk.fused_kkt_solve(Q, A, w, sigma, rhs)
        torch.cuda.synchronize()
        routes = (fk.fused_kkt_solve.routes[selected["kkt_solve"]],
                  fk.chol_solve_stacked.routes[selected["chol_solve"]])
        if routes != (1, 1):
            raise AssertionError(f"phase 6b: {shape}: {selected} route "
                                 f"launches {routes}, not (1, 1)")
        ref = fk.reference_kkt_solve(Q, A, w, sigma, rhs)
        xref = fk.reference_chol_solve(Khat, bhat)
        again = (fk.fused_kkt_solve(Q, A, w, sigma, rhs),
                 fk.chol_solve_stacked(Khat, bhat))
        if not (torch.equal(again[0], dx) and torch.equal(again[1], x)):
            raise AssertionError(f"phase 6b: {shape}: a second call gave "
                                 "other bits")
        if b > 1:
            global_route_failures(fk, ff, (Q, A, w, sigma, rhs), dx, x, n,
                                  selected)
        got = {selected["kkt_solve"]: (dx, x)}
        others = {"cluster": "global", "global": "cluster"}
        other = others[selected["kkt_solve"]]
        if kernels.cluster_size(n):
            got[other] = (on_route(fk, "kkt_solve", other,
                                   (Q, A, w, sigma, rhs), (b, m, n)),
                          on_route(fk, "chol_solve", other, (Khat, bhat),
                                   (b, n)))
        for route, (dxr, xr) in got.items():
            for name, g, want in (("kkt_solve", dxr, ref),
                                  ("chol_solve", xr, xref)):
                key = (f"{name}_{route}", F32)
                errs[key] = max(errs[key], (g - want).abs().max().item())
            for what, r in (("kkt_solve vs plain", rel_err(dxr, ref)),
                            ("chol_solve vs plain", rel_err(xr, xref)),
                            ("formation -> scale -> chol_solve -> unscale vs "
                             "kkt_solve", rel_err(xr * dinv, dxr))):
                print(f"phase 6b: {shape} {route} route"
                      f"{' (selected)' if route == selected['kkt_solve'] else ''}"
                      f": {what}: max error relative to max|dx| {r:.3e} "
                      f"(tol {tol})")
                if not (r <= tol):
                    raise AssertionError(f"phase 6b: {shape} {route}: {what}:"
                                         f" {r:.3e} > {tol}")
        library = {"kkt_solve": kkt_library_route(ff, tl, Q, A, w, sigma, rhs),
                   "chol_solve": chol_library_route(Khat, bhat)}
        plain = {"kkt_solve": lambda: fk.reference_kkt_solve(Q, A, w, sigma,
                                                             rhs),
                 "chol_solve": lambda: fk.reference_chol_solve(Khat, bhat)}
        call = {"kkt_solve": ((Q, A, w, sigma, rhs), (b, m, n)),
                "chol_solve": ((Khat, bhat), (b, n))}
        for name in ("kkt_solve", "chol_solve"):
            args, sizes = call[name]
            elems, ops = kkt_work(name, b, m, n)
            bms, by = bound_ms(4 * elems, ops, PEAK_F32)
            lib_ms = {}
            for route in got:
                kernel = (lambda name=name, route=route, args=args,
                          sizes=sizes: on_route(fk, name, route, args, sizes))
                if route == selected[name]:
                    kernel = ((lambda: fk.fused_kkt_solve(*args))
                              if name == "kkt_solve"
                              else (lambda: fk.chol_solve_stacked(*args)))
                k1, l1 = timed(kernel, 20), timed(library[name], 20)
                l2, k2 = timed(library[name], 20), timed(kernel, 20)
                lib_ms[route] = min(l1, l2)
                times[(f"{name}_{route}", shape)] = dict(
                    B=b, m=m, n=n, selected=route == selected[name],
                    ms=min(k1, k2),
                    device_ms=device_ms(kernel, calls=20, replays=3),
                    bound_ms=bms, bound_by=by)
            shared = dict(
                plain_ms=timed(plain[name], 2), library_route_ms=min(
                    lib_ms.values()),
                library_route_device_ms=device_ms(library[name], calls=20,
                                                  replays=3),
                library_ms=(timed(lambda: torch.linalg.solve(Khat, bhat), 20)
                            if name == "chol_solve" else None))
            for route in got:
                r = times[(f"{name}_{route}", shape)]
                r.update(shared)
                print(f"phase 6b: {name}_{route} float32 at B={b} m={m} n={n}"
                      f"{' (selected)' if r['selected'] else ''}: kernel "
                      f"{r['ms']:.4f} ms, on the card alone "
                      f"{r['device_ms']:.4f} ms; plain version "
                      f"{r['plain_ms']:.2f} ms; library route "
                      f"{r['library_route_ms']:.4f} ms, on the card alone "
                      f"{r['library_route_device_ms']:.4f} ms"
                      + ("" if r["library_ms"] is None else
                         f"; torch.linalg.solve {r['library_ms']:.4f} ms")
                      + f"; bound {bms:.5f} ms (by {by}), on {card}",
                      flush=True)
            if len(got) == 2:
                cl = times[(f"{name}_cluster", shape)]["device_ms"]
                gl = times[(f"{name}_global", shape)]["device_ms"]
                print(f"phase 6b: {name} at {shape}: cluster route {cl:.4f} "
                      f"ms, global route {gl:.4f} ms on the card alone; "
                      f"selected {selected[name]}", flush=True)
        if selected["kkt_solve"] == "global":
            resolve_check(fk, ff, shape, (Q, A, w, sigma, rhs), ref, errs,
                          times, tol, card)
    resolve_check(fk, ff, RESOLVE_SHAPE, card_kkt_inputs(RESOLVE_SHAPE),
                  None, errs, times, tol, card)
    for shape in ODD_KKT_SHAPES:
        odd_n_check(fk, ff, shape, errs, tol)
    require_launched(composition, "phase 6b composition", ("formation", F32),
                     ("chol_solve_cluster", F32), ("chol_solve_global", F32))
    return errs, times, composition


def card_kkt_inputs(shape, seed=0):
    """``kkt_inputs``' family made on the card (too large for numpy's
    einsum): Q = M M' / n + 0.1 I, A normal, w uniform, sigma 1e-3, rhs
    normal."""
    b, m, n = shape
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    Mx = torch.randn((b, n, n), generator=gen, device=DEVICE)
    Q = torch.baddbmm(0.1 * torch.eye(n, device=DEVICE).expand(b, n, n),
                      Mx, Mx.mT, alpha=1 / n)
    del Mx
    return [Q, torch.randn((b, m, n), generator=gen, device=DEVICE),
            torch.rand((b, m), generator=gen, device=DEVICE),
            torch.full((b,), 1e-3, device=DEVICE),
            torch.randn((b, n), generator=gen, device=DEVICE)]


def float64_kkt_solve(fk, Q, A, w, sigma, rhs):
    """The system of ``fused_kkt_solve`` (K Jacobi-scaled, plus the static
    shift) solved in float64 by ``torch.linalg.cholesky``: the yardstick
    of float32 rounding at a shape."""
    Q, A, w, sigma, rhs = (t.to(F64) for t in (Q, A, w, sigma, rhs))
    eye = torch.eye(Q.shape[-1], dtype=F64, device=Q.device)
    K = A.mT @ (w[..., None] * A) + Q + sigma[:, None, None] * eye
    dinv = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Khat = K * dinv[:, :, None] * dinv[:, None, :] + fk._static_reg32() * eye
    del K
    chol = torch.linalg.cholesky(Khat)
    return torch.cholesky_solve((rhs * dinv)[..., None], chol)[..., 0] * dinv


def resolve_check(fk, ff, shape, args, ref, errs, times, tol, card):
    """Kernel 3's factor kept for another right-hand side at ``shape`` (a
    global-route shape): ``fused_kkt_solver`` called with a second
    right-hand side and then with ``rhs`` gives, for each, the bits of
    ``fused_kkt_solve``, and for ``rhs`` the plain version ``ref``
    (computed here when None) within ``tol``, or within twice the plain
    version's own distance from the float64 solution where that is larger
    (the rounding that K's conditioning allows in float32), with one
    ``kkt_resolve_global`` counted for the second call.  Its error goes
    into ``errs``, its times
    (a substitution on the kept factor, beside the library route, the
    plain version and the bound: R's upper triangle, dinv, R's diagonal
    and rhs read once, dx written once) into ``times``."""
    b, m, n = shape
    Q, A, w, sigma, rhs = args
    if fk.kernel_route("kkt_solve", b, n) != "global":
        raise AssertionError(f"phase 6b: resolve at {shape}: not the global "
                             "route")
    rhs2 = rhs.flip(1)
    solver = fk.fused_kkt_solver(Q, A, w, sigma)
    before = fk.fused_kkt_solver.launches[F32]
    got = (solver(rhs2), solver(rhs))
    torch.cuda.synchronize()
    resolves = fk.fused_kkt_solver.launches[F32] - before
    want = (fk.fused_kkt_solve(Q, A, w, sigma, rhs2),
            fk.fused_kkt_solve(Q, A, w, sigma, rhs))
    if ref is None:
        ref = fk.reference_kkt_solve(Q, A, w, sigma, rhs)
    same = all(torch.equal(g, x) for g, x in zip(got, want))
    r = rel_err(got[1], ref)
    plain = rel_err(ref, float64_kkt_solve(fk, Q, A, w, sigma, rhs))
    allowed = max(tol, 2 * plain)
    print(f"phase 6b: kkt_resolve_global at {shape}: same bits as "
          f"fused_kkt_solve for both right-hand sides {same}; max error "
          f"relative to max|dx| {r:.3e} (tol {allowed:.3e}: the plain "
          f"version is {plain:.3e} from float64); substitutions counted "
          f"{resolves}", flush=True)
    if not (same and r <= allowed and resolves == 1):
        raise AssertionError(f"phase 6b: kkt_resolve_global at {shape}: "
                             f"bits {same}, error {r:.3e} (tol "
                             f"{allowed:.3e}), {resolves} substitutions "
                             "counted (want 1)")
    key = ("kkt_resolve_global", F32)
    errs[key] = max(errs.get(key, 0.0), (got[1] - ref).abs().max().item())
    Khat, bhat, _ = scaled_system(fk, ff, Q, A, w, sigma, rhs)
    chol = torch.linalg.cholesky_ex(Khat)[0]
    del Khat

    def library():
        z = torch.linalg.solve_triangular(chol, bhat[..., None], upper=False)
        return torch.linalg.solve_triangular(chol.mT, z, upper=True)

    def kernel():
        return solver(rhs)

    bms, by = bound_ms(4 * b * (n * (n + 1) // 2 + 4 * n), 2 * b * n * n)
    k1, l1 = timed(kernel, 20), timed(library, 20)
    l2, k2 = timed(library, 20), timed(kernel, 20)
    t = times[(key[0], shape)] = dict(
        B=b, m=m, n=n, selected=True, ms=min(k1, k2),
        device_ms=device_ms(kernel, calls=20, replays=3),
        launch_device_ms=device_ms(lambda: fk.fused_kkt_solve(*args),
                                   calls=5, replays=2),
        plain_ms=timed(lambda: fk.reference_kkt_solve(*args), 2),
        bound_ms=bms, bound_by=by, library_ms=None,
        library_route_ms=min(l1, l2),
        library_route_device_ms=device_ms(library, calls=20, replays=3))
    print(f"phase 6b: kkt_resolve_global float32 at B={b} m={m} n={n}: "
          f"substitution {t['ms']:.4f} ms, on the card alone "
          f"{t['device_ms']:.4f} ms (a launch of kernel 3 "
          f"{t['launch_device_ms']:.4f} ms); plain version (the whole "
          f"solve) {t['plain_ms']:.2f} ms; library route "
          f"{t['library_route_ms']:.4f} ms, on the card alone "
          f"{t['library_route_device_ms']:.4f} ms; bound {bms:.5f} ms (by "
          f"{by}), on {card}", flush=True)


def odd_n_check(fk, ff, shape, errs, tol):
    """Both KKT kernels at one problem of odd n (``ODD_KKT_SHAPES``), on
    the route each selects (counted there), against the plain version and
    twice for the same bits; the errors go into ``errs``."""
    b, m, n = shape
    Q, A, w, sigma, rhs = kkt_inputs(seed=n, shape=shape)
    Khat, bhat, _ = scaled_system(fk, ff, Q, A, w, sigma, rhs)
    for name, wrapper, args, plain in (
            ("kkt_solve", fk.fused_kkt_solve, (Q, A, w, sigma, rhs),
             fk.reference_kkt_solve),
            ("chol_solve", fk.chol_solve_stacked, (Khat, bhat),
             fk.reference_chol_solve)):
        route = fk.kernel_route(name, b, n)
        before = wrapper.routes[route]
        got = wrapper(*args)
        again = wrapper(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        r = rel_err(got, want)
        print(f"phase 6b: {name} at odd n {shape} on the {route} route: max "
              f"error relative to max|dx| {r:.3e} (tol {tol}); same bits "
              f"{torch.equal(got, again)}", flush=True)
        if wrapper.routes[route] != before + 2:
            raise AssertionError(f"phase 6b: {name} at {shape} did not take "
                                 f"the {route} route")
        if not (r <= tol and torch.equal(got, again)):
            raise AssertionError(f"phase 6b: {name} at odd n {shape}: error "
                                 f"{r:.3e} or other bits on a second call")
        key = (f"{name}_{route}", F32)
        if key in errs:
            errs[key] = max(errs[key], (got - want).abs().max().item())


def global_route_failures(fk, ff, args, dx, x, n, selected):
    """Problem 0 made indefinite and a NaN in problem 1's rhs, on the
    ``selected`` routes (global or cluster): kernel and plain version
    agree on which problems come back non-finite (problem 1 among them),
    and the other problems keep the bits of the clean run ``dx`` (kernel
    3) and ``x`` (kernel 4)."""
    Q, A, w, sigma, rhs = args
    Qb, rb = Q.clone(), rhs.clone()
    Qb[0] = -Qb[0] - 1e3 * torch.eye(n, device=DEVICE)
    rb[1, 3] = float("nan")
    Kg, bg, _ = scaled_system(fk, ff, Q, A, w, sigma, rhs)
    Kb, bb = Kg.clone(), bg.clone()
    Kb[0] = -Kb[0]
    bb[1, 3] = float("nan")
    for what, got, want, clean in (
            ("kkt_solve", fk.fused_kkt_solve(Qb, A, w, sigma, rb),
             fk.reference_kkt_solve(Qb, A, w, sigma, rb), dx),
            ("chol_solve", fk.chol_solve_stacked(Kb, bb),
             fk.reference_chol_solve(Kb, bb), x)):
        fin = torch.isfinite(got).all(dim=1)
        lost = (~fin).nonzero().flatten().tolist()
        keep = [i for i in range(got.shape[0]) if i not in (0, 1)]
        if not (torch.equal(fin, torch.isfinite(want).all(dim=1))
                and 1 in lost and set(lost) <= {0, 1}
                and torch.equal(got[keep], clean[keep])):
            raise AssertionError(f"phase 6b: n={n}: {what}: a failure left "
                                 f"its problem (non-finite {lost})")
        print(f"phase 6b: n={n}, B={got.shape[0]}: {what} on the "
              f"{selected[what]} route: non-finite problems {lost} (kernel "
              f"and plain version agree), the other {len(keep)} "
              "bit-identical to the clean run")


def phase7b(pt, ff, fr, fk, card):
    """The pallas_kkt path above the shared-memory route: the bench family
    at PHASE7B (B=64, n=300, m=450) with phase 7's settings, every Newton
    solve kernel 3's global route.  Returns the launches of the solve."""
    from qpdo_tpu_torch.ops import linalg

    b, n, m = PHASE7B
    d = bench_problems(b, n, m, seed=11)
    settings = pallas_kkt_settings(pt)
    route = linalg.fused_kkt_kernel_route(settings, b, n, DEVICE, F64)
    if route != "global":
        raise AssertionError(f"phase 7b: n={n} takes the {route} route")
    problems = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                             for k, v in d.items()})
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    res = pt.solve_batch(problems, settings, compact=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ff, fr, fk)
    print(f"phase 7b: B={b} n={n} m={m}, kernel 3's {route} route: first "
          f"solve {wall:.2f} s, kernel launches {printable(counts)}, on "
          f"{card}")
    require_launched(counts, "phase 7b", ("kkt_solve", F32),
                     ("kkt_solve_global", F32), ("kkt_resolve_global", F32),
                     ("residuals", F64))
    check_solved(pt, d, res, "phase 7b (n=300, global route)")
    return counts


def phase7c(pt, ff, fr, fk, card):
    """One QP with many rows (``random_qp(200, 50,000)``, phase 16b's
    family at a rank's rows) through ``solve`` with phase 7's settings
    without ``pallas_kkt``: the float32 chol route, every K formed by
    kernel 1 in float32 with its rows split over blocks.  Returns the
    launches of the solve."""
    Q, q, A, l, u = random_qp(PHASE16_ROW_N, TALL_FORMATION_M[0], seed=0)
    problem = pt.make_problem(Q, q, A, l, u)
    settings = pt.Settings(kkt_dtype="float32", mu_min=1e-7, refine_steps=2)
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    res = pt.solve(problem, settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ff, fr, fk)
    print(f"phase 7c: solve n={Q.shape[0]} m={A.shape[0]} (float32 KKT): "
          f"{wall:.2f} s, kernel launches {printable(counts)}, on {card}")
    require_launched(counts, "phase 7c", ("formation", F32),
                     ("formation_split", F32), ("residuals", F64))
    d = dict(Q=Q[None], q=q[None], A=A[None], l=l[None], u=u[None])
    check_solved(pt, d, res, "phase 7c (n=200, m=50,000)")
    return counts


def infeasible_problems():
    """The three acceptance QPs of examples/infeasibility_tests.m (as
    benchmarks/run.py:72-88 builds them), as numpy: (Q, q, A, l, u) of a
    solvable, a primal infeasible and a dual infeasible problem."""
    def problem(a, b, c):
        return (np.array([[1.0, 0.0], [0.0, 0.0]]), np.array([1.0, c]),
                np.array([[a, a], [1.0, 0.0], [0.0, 1.0]]),
                np.array([-np.inf, 1.0, 1.0]), np.array([0.0, 3.0, b]))
    return [problem(0.0, 3.0, 0.0), problem(1.0, 3.0, 0.0),
            problem(0.0, np.inf, -1.0)]


def phase7d(pt, ff, fr, fk, card):
    """One large dense QP (``random_qp(*PHASE7D)``, n=1024, m=1536: phase
    6b's largest shape as a solve) with phase 7's settings through
    ``solve``, then through ``QPDO`` (setup, a cold solve, a warm re-solve
    after a 1% change of q), every Newton solve kernel 3's cluster route;
    then the three infeasibility problems through ``solve`` under
    ``Settings(max_iter=100)`` and phase 7's settings, on the card and on
    the CPU.  Returns the launches of the large solves."""
    from qpdo_tpu_torch import kernels
    from qpdo_tpu_torch.ops import linalg

    n, m = PHASE7D
    Q, q, A, l, u = random_qp(n, m, seed=0)
    settings = pallas_kkt_settings(pt)
    route = linalg.fused_kkt_kernel_route(settings, 1, n, DEVICE, F64)
    if route != "cluster":
        raise AssertionError(f"phase 7d: n={n} takes the {route} route")
    d = dict(Q=Q[None], q=q[None], A=A[None], l=l[None], u=u[None])
    problem = pt.make_problem(Q, q, A, l, u)
    reset_counts(ff, fr, fk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.solve(problem, settings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(ff, fr, fk)
    print(f"phase 7d: solve n={n} m={m}, kernel 3's {route} route (clusters "
          f"of {kernels.cluster_size(n)} blocks): {wall:.2f} s, "
          f"{int(res.info.iterations)} iterations, kernel launches "
          f"{printable(counts)}, on {card}", flush=True)
    require_launched(counts, "phase 7d", ("kkt_solve_cluster", F32),
                     ("residuals", F64))
    check_solved(pt, d, res, "phase 7d (solve)")

    solver = pt.QPDO()
    solver.setup(Q, q, A, l, u, settings)
    walls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = solver.solve()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    check_solved(pt, d, cold, "phase 7d (QPDO: setup, solve)")
    rng = np.random.default_rng(12)
    q2 = q + 0.01 * rng.standard_normal(n)
    solver.warm_start(cold.x, cold.y)
    solver.update_q(q2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = solver.solve()
    torch.cuda.synchronize()
    walls.append(time.perf_counter() - t0)
    check_solved(pt, dict(d, q=q2[None]), warm,
                 "phase 7d (QPDO: warm_start, update_q, solve)")
    counts = launch_counts(ff, fr, fk)
    require_launched(counts, "phase 7d (QPDO)", ("kkt_solve_cluster", F32),
                     ("residuals", F64))
    routes = dict(fk.fused_kkt_solve.routes)
    print(f"phase 7d: QPDO iterations cold {int(cold.info.iterations)}, "
          f"warm {int(warm.info.iterations)}; wall {walls[0]:.2f} s cold, "
          f"{walls[1]:.2f} s warm; launches of the three solves "
          f"{printable(counts)}, kernel 3 by route {routes}, on {card}",
          flush=True)

    expected = [pt.SOLVED, pt.PRIMAL_INFEASIBLE, pt.DUAL_INFEASIBLE]
    for what, s in (("max_iter=100", pt.Settings(max_iter=100)),
                    ("phase 7's settings", settings)):
        statuses = {}
        for device in (DEVICE, "cpu"):
            statuses[device] = []
            for args in infeasible_problems():
                r = pt.solve(pt.make_problem(*args, device=device), s)
                if device == DEVICE and not on_card(r.x, r.info.status_val):
                    raise AssertionError("phase 7d: results are not on the "
                                         "card")
                statuses[device].append(int(r.info.status_val))
        print(f"phase 7d: infeasibility problems under {what}: statuses "
              f"{statuses[DEVICE]} on the card, {statuses['cpu']} on the CPU"
              f" (expected {expected})", flush=True)
        if statuses[DEVICE] != expected or statuses["cpu"] != expected:
            raise AssertionError(f"phase 7d: infeasibility statuses under "
                                 f"{what}: {statuses}")
    return counts


def phase8(pt, fk):
    """QPDO on one problem, no device argument: everything on the card."""
    d = {k: v[0] for k, v in bench_problems(1, N, M, seed=8).items()}
    solver = pt.QPDO()
    solver.setup(d["Q"], d["q"], d["A"], d["l"], d["u"],
                 pallas_kkt_settings(pt))
    if not on_card(solver._sp.data.Q):
        raise AssertionError("phase 8: setup() did not default to the card")
    before = fk.fused_kkt_solve.launches[F32]
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
          f"{fk.fused_kkt_solve.launches[F32] - before}, solve time "
          f"{float(res2.info.solve_time):.3f} s")
    if fk.fused_kkt_solve.launches[F32] <= before:
        raise AssertionError("phase 8: the fused kernel was not launched")


# Problems of phase 9's small batch whose iteration counts differ by more
# than 3 between the JAX package and the port on the CPU, or move by more
# than 3 in either package when A changes by one part in 1e15
# (scripts/phase9_reference.py, 12 draws for the default_* variants, 4
# for the others): the variant's path moves with rounding there, so the
# card is held to their status, not their count.
ROUNDING_SENSITIVE = {"bench_incremental": (8, 10),
                      "default_inv": (3, 8, 11, 13),
                      "default_cg": (0, 4, 5, 6, 8, 9, 10, 11, 12, 13, 14,
                                     15)}


def variants(pt):
    """Phase 9: (name, settings, batch size, kernels that must launch)."""
    bench, pkkt, lib = bench_settings(pt), pallas_kkt_settings(pt), pt.Settings()
    mixed = (("formation", F32), ("residuals", F32), ("residuals", F64))
    f64 = (("formation", F64), ("residuals", F64))
    return [
        ("bench_polish", bench.replace(polish=True, warmup_eps=1e-3), B, mixed),
        ("bench_inv", bench.replace(kkt_solver="inv"), B, mixed),
        # bench_cg and default_cg each took more than 30 s at B=256 (33.2
        # and 37.6 s in one run each on the H100): B=64 keeps the phase
        # inside its time
        ("bench_cg", bench.replace(kkt_solver="cg"), 64, mixed),
        ("bench_incremental",
         bench.replace(kkt_solver="chol", kkt_update_rows=16), B, mixed),
        ("bench_fused_rhs",
         bench.replace(kkt_solver="chol", fused_newton_rhs=True), B, mixed),
        ("bench_bisect_chunk", bench.replace(linesearch="bisect_chunk"), B,
         mixed),
        ("pallas_kkt_fused_rhs", pkkt.replace(fused_newton_rhs=True), B,
         (("kkt_solve", F32), ("residuals", F64))),
        ("default_inv", lib.replace(kkt_solver="inv"), B, f64),
        ("default_cg", lib.replace(kkt_solver="cg"), 64, f64),
        ("default_accel", lib.replace(accel_gamma=0.5), B, f64),
    ]


def phase9(pt, ff, fr, fk, d, card):
    """Every variant at full width: the gate of phase 4 and its launches.
    Returns the launches of each variant's solve by (kernel, dtype)."""
    ds = bench_problems(16, 40, 60, seed=1)
    out = {}
    for name, settings, b, kernels_of_path in variants(pt):
        db = {k: v[:b] for k, v in d.items()}
        problems = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                                 for k, v in db.items()})
        torch.cuda.synchronize()
        reset_counts(ff, fr, fk)
        t0 = time.perf_counter()
        res = pt.solve_batch(problems, settings, compact=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = out[name] = launch_counts(ff, fr, fk)
        what = f"phase 9: {name}" + ("" if b == B else f" (B={b})")
        check_solved(pt, db, res, what)
        print(f"{what}: one solve {wall:.3f} s, kernel launches "
              f"{printable(counts)}, on {card}", flush=True)
        require_launched(counts, what, *kernels_of_path)
        small = {dev: pt.solve_batch(pt.Problem(**{
            k: torch.as_tensor(v, device=dev) for k, v in ds.items()}),
            settings, compact=True) for dev in (DEVICE, "cpu")}
        st = {dev: r.info.status_val.cpu().numpy() for dev, r in small.items()}
        it = {dev: r.info.iterations.cpu().numpy().astype(int)
              for dev, r in small.items()}
        diff = np.abs(it[DEVICE] - it["cpu"])
        loose = ROUNDING_SENSITIVE.get(name, ())
        gap = int(np.delete(diff, loose).max())
        print(f"{what}: small batch card vs CPU: statuses "
              f"{'equal' if np.array_equal(st[DEVICE], st['cpu']) else 'DIFFER'}"
              f", max iteration difference {gap}"
              + (f" (problems {list(loose)}, held to their status: rounding "
                 f"moves their counts by more than 3 on the CPU)"
                 if loose else "")
              + f"; differences {diff.tolist()}", flush=True)
        if not (np.array_equal(st[DEVICE], st["cpu"]) and gap <= 3):
            raise AssertionError(f"{what}: card and CPU disagree on the "
                                 "small batch")
    return out


def phase10(pt, ff, fr, fk, d):
    """Problem 0 through QPDO: verbose, a time limit that ends it, a time
    limit that does not.  Returns the launches of the three solves."""
    d0 = {k: v[0] for k, v in d.items()}
    one = {k: np.asarray(v)[None] for k, v in d0.items()}
    base = pallas_kkt_settings(pt)
    solver = pt.QPDO()
    solver.setup(d0["Q"], d0["q"], d0["A"], d0["l"], d0["u"], base)
    silent = solver.solve()
    check_solved(pt, one, silent, "phase 10 (silent)")
    counts = collections.Counter()
    for kw in (dict(verbose=True, print_interval=10),
               dict(eps_abs=1e-14, max_time=1e-3), dict(max_time=60.0)):
        solver.update_settings(base.replace(**kw))
        buf = io.StringIO()
        torch.cuda.synchronize()
        reset_counts(ff, fr, fk)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = solver.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts.update(launch_counts(ff, fr, fk))
        status, iters = int(res.info.status_val), int(res.info.iterations)
        table = buf.getvalue()
        print(table, end="")
        print(f"phase 10: {kw}: {res.info.status[0]}, {iters} iterations "
              f"(silent {int(silent.info.iterations)}), {wall:.3f} s",
              flush=True)
        if "max_time" in kw and kw["max_time"] < 1.0:
            if status != pt.constants.MAX_TIME_REACHED:
                raise AssertionError(f"phase 10: {kw} gave {status}")
            continue
        check_solved(pt, one, res, f"phase 10 ({kw})")
        if iters != int(silent.info.iterations):
            raise AssertionError(f"phase 10: {kw}: {iters} iterations, "
                                 "not the silent solve's")
        if kw.get("verbose") and "QPDO on GPU" not in table:
            raise AssertionError("phase 10: the verbose table was not printed")
    require_launched(counts, "phase 10", ("kkt_solve", F32),
                     ("residuals", F64))
    return counts


def numpy_problems(pt, d, device):
    """A Problem of the numpy batch ``d`` on ``device``."""
    return pt.Problem(**{k: torch.as_tensor(v, device=device)
                         for k, v in d.items()})


def max_rel(a, b):
    """max|a - b| / max|b| of two tensors (on any devices), as a float."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


# Phase 11: gradients on the card against the port on the CPU, first 8
# problems (relative to each gradient's max|entry|); forward mode against
# reverse mode
GRAD_CPU_RTOL, DUALITY_RTOL = 1e-9, 1e-6
FD_H, FD_COORDS, FD_BATCH = 1e-5, (3, 41), 16


def phase11(pt, ff, fr, fk, d, card):
    """The differentiable layer at full width: forward at the library
    defaults, reverse mode against the port on the CPU and against finite
    differences, forward mode against reverse mode.  Returns the launches
    of the forward and backward passes."""
    import torch.autograd.forward_ad as fwAD

    settings = pt.Settings()
    names = ("Q", "q", "A", "l", "u")
    theta = [torch.as_tensor(d[k], device=DEVICE).requires_grad_()
             for k in names]
    rng = np.random.default_rng(11)
    gx = torch.as_tensor(rng.standard_normal((B, N)), device=DEVICE)
    gy = torch.as_tensor(rng.standard_normal((B, M)), device=DEVICE)

    torch.cuda.synchronize()
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    x, y = pt.qp_solve(*theta, settings)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_counts = launch_counts(ff, fr, fk)
    require_launched(fwd_counts, "phase 11 forward", ("formation", F64),
                     ("residuals", F64))
    # the statuses: solve_batch runs the same solve (scale_problem +
    # solve_scaled) on the same tensors
    ref = pt.solve_batch(numpy_problems(pt, d, DEVICE), settings)
    check_solved(pt, d, ref, "phase 11 (statuses: solve_batch, Settings())")
    check_solved(pt, d, ref._replace(x=x.detach(), y=y.detach()),
                 "phase 11 (qp_solve forward, Settings())")
    print(f"phase 11: qp_solve forward {fwd_s:.3f} s at B={B}, kernel "
          f"launches {printable(fwd_counts)}; max|x - solve_batch x| "
          f"{(x - ref.x).abs().max().item():.3e}, on {card}", flush=True)

    loss = (gx * x).sum() + (gy * y).sum()
    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss, theta)
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    if not all(torch.isfinite(g).all() and on_card(g) for g in grads):
        raise AssertionError("phase 11: non-finite gradient or not on the card")
    print(f"phase 11: backward {bwd_s:.3f} s (batched LU of {B} saddle "
          f"systems of size {N + M}), on {card}", flush=True)

    # the port on the CPU on the first 8 problems
    cpu = [t.detach()[:8].cpu().requires_grad_() for t in theta]
    xc, yc = pt.qp_solve(*cpu, settings)
    gc = torch.autograd.grad((gx[:8].cpu() * xc).sum()
                             + (gy[:8].cpu() * yc).sum(), cpu)
    errs = {k: max_rel(g[:8], c) for k, g, c in zip(names, grads, gc)}
    print("phase 11: card against CPU, first 8 problems, max error relative "
          "to max|gradient|: " + ", ".join(f"d{k} {e:.3e}"
                                           for k, e in errs.items())
          + f" (tol {GRAD_CPU_RTOL}); x {max_rel(x[:8], xc):.3e}")
    if not max(errs.values()) <= GRAD_CPU_RTOL:
        raise AssertionError("phase 11: card gradients differ from the CPU's")

    # central differences in q and u on the card, FD_BATCH problems, at the
    # tolerance of tests/test_diff.py (eps_abs 1e-10: FD noise ~ eps/h)
    tight = pt.Settings(eps_abs=1e-10, max_iter=500)
    sub = [t.detach()[:FD_BATCH].clone() for t in theta]
    sub_grad = [t.clone().requires_grad_() for t in sub]
    xs, ys = pt.qp_solve(*sub_grad, tight)
    g_sub = torch.autograd.grad((gx[:FD_BATCH] * xs).sum()
                                + (gy[:FD_BATCH] * ys).sum(), sub_grad)

    def losses(th):
        # solve_batch is qp_solve's forward solve (bit for bit, above), and
        # it gives the statuses too
        c0 = torch.zeros(FD_BATCH, dtype=th[0].dtype, device=DEVICE)
        r = pt.solve_batch(pt.Problem(*th, c=c0), tight)
        return ((gx[:FD_BATCH] * r.x).sum(1) + (gy[:FD_BATCH] * r.y).sum(1),
                r.info.status_val == pt.SOLVED)

    def moved(k, c, h):
        th = [t.clone() for t in sub]
        th[k][:, c] += h
        return losses(th)

    # a gradient means something only where the solve converged (diff.py):
    # each coordinate is held on the problems whose three solves are SOLVED
    base_ok = losses(sub)[1]
    worst, held = 0.0, []
    for k in (1, 4):                                     # q, u
        for c in FD_COORDS:
            c = c % theta[k].shape[1]
            (lp, okp), (lm, okm) = moved(k, c, FD_H), moved(k, c, -FD_H)
            ok = base_ok & okp & okm
            fd, got = ((lp - lm) / (2 * FD_H))[ok], g_sub[k][:, c][ok]
            excess = ((got - fd).abs() - (5e-4 + 2e-3 * fd.abs())).max()
            worst = max(worst, (got - fd).abs().max().item())
            held.append(int(ok.sum()))
            if excess.item() > 0 or held[-1] < FD_BATCH // 2:
                raise AssertionError(f"phase 11: d{names[k]}[:, {c}] differs "
                                     "from finite differences or too few "
                                     f"problems converged ({held[-1]})")
    print(f"phase 11: dq and du at coordinates {FD_COORDS} against central "
          f"differences (h={FD_H}, eps_abs 1e-10, max_iter 500) on the "
          f"problems of the first {FD_BATCH} whose three solves are SOLVED "
          f"({held} of {FD_BATCH}; not SOLVED at the base: "
          f"{(~base_ok).nonzero().flatten().tolist()}): max abs difference "
          f"{worst:.3e} (rtol 2e-3, atol 5e-4)")

    # forward mode: <g, J t> = <J' g, t> with J' g the reverse gradients
    tangents = [torch.as_tensor(rng.standard_normal(t.shape), device=DEVICE)
                for t in theta]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fwAD.dual_level():
        duals = [fwAD.make_dual(t.detach(), dt) for t, dt in zip(theta,
                                                                  tangents)]
        xf, yf = pt.qp_solve(*duals, settings, mode="forward")
        dx, dy = fwAD.unpack_dual(xf).tangent, fwAD.unpack_dual(yf).tangent
        lhs = ((gx * dx).sum() + (gy * dy).sum()).item()
    torch.cuda.synchronize()
    jvp_s = time.perf_counter() - t0
    rhs = sum((g * t).sum() for g, t in zip(grads, tangents)).item()
    rel = abs(lhs - rhs) / max(abs(rhs), 1e-300)
    print(f"phase 11: forward mode {jvp_s:.3f} s; <g, J t> {lhs:.10e}, "
          f"<J' g, t> {rhs:.10e}, relative difference {rel:.3e} (tol "
          f"{DUALITY_RTOL}), on {card}")
    if not rel <= DUALITY_RTOL:
        raise AssertionError("phase 11: forward and reverse modes disagree")
    return fwd_counts


# Phase 12: the service's sample against direct solves of the unpadded
# problems on the card
SERVE_REQUESTS, SERVE_THREADS, SERVE_SAMPLE = 512, 8, 16
SERVE_ITER_BAND, SERVE_X_BAND = 3, 1e-5


def serve_requests(seed):
    """(numpy problem, n, m) of every request of phase 12: the bench family
    at sizes drawn from ``seed``, n in 60-100 and m in 90-150."""
    rng = np.random.default_rng(seed)
    sizes = zip(rng.integers(60, 101, SERVE_REQUESTS),
                rng.integers(90, 151, SERVE_REQUESTS))
    return [({k: v[0] for k, v in bench_problems(1, int(n), int(m),
                                                 seed=seed + 1000 + i).items()},
             int(n), int(m)) for i, (n, m) in enumerate(sizes)]


def phase12(pt, ff, fr, fk, card, seed):
    """SolverService on the card: 512 requests of mixed sizes from 8
    threads, one warm-started session per thread.  Returns the launches."""
    import threading

    from qpdo_tpu_torch.serve import SolverService

    reqs = serve_requests(seed)
    make = lambda dd: pt.make_problem(dd["Q"], dd["q"], dd["A"], dd["l"],
                                      dd["u"], device=DEVICE)
    problems = [make(dd) for dd, _, _ in reqs]
    # each thread's session: its first request, then that problem with q
    # moved by 1e-3, submitted once the first is answered
    per = SERVE_REQUESTS // SERVE_THREADS
    rng = np.random.default_rng(seed + 1)
    moved = {}
    for t in range(SERVE_THREADS):
        dd, n, m = reqs[t * per]
        moved[("moved", t)] = (
            dict(dd, q=dd["q"] + 1e-3 * rng.standard_normal(n)), n, m)
    torch.cuda.synchronize()
    svc = SolverService(max_batch=64, max_wait_ms=5)
    futures, done_at, errors = {}, {}, []
    submitted_at = {}
    lock = threading.Lock()

    def submit(key, problem, session=None):
        submitted_at[key] = time.perf_counter()
        fut = svc.submit(problem, session=session)
        fut.add_done_callback(
            lambda f, key=key: done_at.__setitem__(key, time.perf_counter()))
        with lock:
            futures[key] = fut
        return fut

    def client(t):
        try:
            first = t * per
            submit(first, problems[first], f"client-{t}").result(600)
            for i in range(first + 1, first + per):
                submit(i, problems[i])
            submit(("moved", t), make(moved[("moved", t)][0]), f"client-{t}")
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    reset_counts(ff, fr, fk)
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    results = {k: f.result(timeout=900) for k, f in futures.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = svc.stats()
    svc.shutdown()
    counts = launch_counts(ff, fr, fk)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"phase 12: a client failed: {errors}")
    if len(results) != SERVE_REQUESTS + SERVE_THREADS:
        raise AssertionError(f"phase 12: {len(results)} results")

    worst = (0.0, 0.0)
    for key, res in results.items():
        dd, n, m = moved[key] if key in moved else reqs[key]
        one = {k: np.asarray(v)[None] for k, v in dd.items()}
        if res.x.shape != (1, n) or res.y.shape != (1, m):
            raise AssertionError(f"phase 12: request {key}: shapes "
                                 f"{tuple(res.x.shape)}, {tuple(res.y.shape)}")
        if res.info.status != ["solved"] or not on_card(res.x):
            raise AssertionError(f"phase 12: request {key}: "
                                 f"{res.info.status} on {res.x.device}")
        rp, rd = oracle(one, res.x.cpu().numpy(), res.y.cpu().numpy())
        worst = (max(worst[0], rp.max()), max(worst[1], rd.max()))
    if not max(worst) <= 1.1e-6:
        raise AssertionError(f"phase 12: oracle {worst} above 1.1e-6")
    if stats["session_warm_hits"] != SERVE_THREADS:
        raise AssertionError(f"phase 12: session hits {stats}")
    lat = np.array([done_at[k] - submitted_at[k] for k in results]) * 1e3
    print(f"phase 12: {len(results)} requests from {SERVE_THREADS} threads "
          f"in {wall:.3f} s: {len(results) / wall:.2f} requests/s, latency "
          f"p50 {np.percentile(lat, 50):.1f} ms, p99 "
          f"{np.percentile(lat, 99):.1f} ms, mean batch size "
          f"{stats['mean_batch_size']:.2f}; every request SOLVED, oracle max "
          f"rp {worst[0]:.3e}, max rd {worst[1]:.3e}; stats {stats}; kernel "
          f"launches {printable(counts)}, on {card}", flush=True)
    require_launched(counts, "phase 12", ("formation", F64),
                     ("residuals", F64))

    # a sample against direct solves of the same unpadded problems
    sample = np.random.default_rng(seed + 2).choice(
        [k for k in results if not isinstance(k, tuple)], SERVE_SAMPLE,
        replace=False)
    d_it, d_x = [], []
    for i in sample:
        direct = pt.solve(problems[i])
        res = results[int(i)]
        if direct.info.status != res.info.status:
            raise AssertionError(f"phase 12: request {i}: status "
                                 f"{res.info.status}, direct "
                                 f"{direct.info.status}")
        d_it.append(abs(int(direct.info.iterations)
                        - int(res.info.iterations)))
        d_x.append((direct.x - res.x).abs().max().item())
    print(f"phase 12: {SERVE_SAMPLE} requests against direct solves of the "
          f"unpadded problems: statuses equal, iteration differences "
          f"{d_it}, max|x - direct x| {max(d_x):.3e} (bands "
          f"{SERVE_ITER_BAND}, {SERVE_X_BAND})")
    if max(d_it) > SERVE_ITER_BAND or max(d_x) > SERVE_X_BAND:
        raise AssertionError("phase 12: the service's results differ from "
                             "the direct solves")
    return counts


# Phase 13: an application on the card against the port on the CPU
APP_X_BAND = 1e-5


def phase13(pt, ff, fr, fk, d, card):
    """The applications and the repaired pallas_kkt rules on the card.
    Returns the launches of the three applications' solves."""
    apps = pt.applications
    rng = np.random.default_rng(0)
    F = rng.standard_normal((40, 15))
    b = F[:, :3] @ np.array([2.0, -1.5, 1.0]) + 0.05 * rng.standard_normal(40)
    rng = np.random.default_rng(3)
    Mx = rng.standard_normal((8, 8))
    port = (rng.standard_normal(8) * 0.1, Mx @ Mx.T / 8 + 0.05 * np.eye(8),
            2.0)
    Ad = np.array([[1.0, 0.1, 0.0], [0.0, 1.0, 0.1], [0.0, 0.0, 0.9]])
    Bd = np.array([[0.0], [0.05], [1.0]])
    cases = {
        "lasso": lambda dev: apps.lasso(F, b, 2.0, device=dev),
        "portfolio": lambda dev: apps.portfolio(*port, device=dev),
        "mpc_condensed": lambda dev: apps.mpc_condensed(
            Ad, Bd, np.eye(3), 0.1 * np.eye(1), np.array([1.5, 0.0, 0.0]),
            10, u_lo=-0.4, u_hi=0.4, x_lo=-2.0, x_hi=2.0, device=dev),
    }
    counts = collections.Counter()
    for name, build in cases.items():
        reset_counts(ff, fr, fk)
        card_res = pt.solve(build(DEVICE))
        torch.cuda.synchronize()
        counts.update(launch_counts(ff, fr, fk))
        cpu_res = pt.solve(build("cpu"))
        dx = (card_res.x.cpu() - cpu_res.x).abs().max().item()
        print(f"phase 13: {name}: card {card_res.info.status[0]} in "
              f"{int(card_res.info.iterations)} iterations, CPU "
              f"{cpu_res.info.status[0]} in {int(cpu_res.info.iterations)}; "
              f"max|x card - x CPU| {dx:.3e} (band {APP_X_BAND})")
        if not (on_card(card_res.x) and card_res.info.status == ["solved"]
                and cpu_res.info.status == ["solved"] and dx <= APP_X_BAND):
            raise AssertionError(f"phase 13: {name} on the card")
    require_launched(counts, "phase 13 applications", ("formation", F64),
                     ("residuals", F64))

    f = lambda z: (1 - z[0]) ** 2 + 100.0 * (z[1] - z[0] ** 2) ** 2
    c = lambda z: torch.stack([z[0] ** 2 + z[1] ** 2])
    t0 = time.perf_counter()
    x, its = apps.sqp_minimize(f, c, [0.0, 0.0], [-float("inf")], [1.0],
                               device=DEVICE)
    sqp_s = time.perf_counter() - t0
    err = np.abs(x.cpu().numpy() - [0.7864, 0.6177]).max()
    print(f"phase 13: sqp_minimize (constrained Rosenbrock) on the card: x "
          f"{x.cpu().numpy()}, {its} outer iterations, {sqp_s:.2f} s, "
          f"|x - (0.7864, 0.6177)| {err:.2e} (tol 1e-3), on {card}")
    if not (on_card(x) and its < 50 and err <= 1e-3):
        raise AssertionError("phase 13: sqp_minimize")

    # pallas_kkt at the library defaults (kkt_dtype None, float64): the
    # chol route, bit for bit the solve without the flag
    problems = numpy_problems(pt, {k: v[:16] for k, v in d.items()}, DEVICE)
    before = fk.fused_kkt_solve.launches[F32]
    on = pt.solve_batch(problems, pt.Settings(pallas_kkt=True))
    torch.cuda.synchronize()
    kkt = fk.fused_kkt_solve.launches[F32] - before
    off = pt.solve_batch(problems, pt.Settings())
    same = all(torch.equal(a, b) for a, b in (
        (on.x, off.x), (on.y, off.y), (on.info.iterations, off.info.iterations),
        (on.info.status_val, off.info.status_val)))
    print(f"phase 13: Settings(pallas_kkt=True) at kkt_dtype None, B=16: "
          f"{kkt} kkt_solve launches, results "
          f"{'bit-identical' if same else 'DIFFERENT'} to pallas_kkt=False")
    if kkt != 0 or not same:
        raise AssertionError("phase 13: pallas_kkt at a float64 KKT dtype")

    # one past the shared-memory route of the fused kernel (once refused
    # at setup): solved through the route that B=2 selects there
    d221 = bench_problems(2, 221, 332, seed=13)
    big = numpy_problems(pt, d221, DEVICE)
    route = fk.kernel_route("kkt_solve", 2, 221)
    before = fk.fused_kkt_solve.routes[route]
    res = pt.solve_batch(big, pallas_kkt_settings(pt))
    torch.cuda.synchronize()
    launched = fk.fused_kkt_solve.routes[route] - before
    print(f"phase 13: n=221, pallas_kkt, kkt_dtype float32: {launched} "
          f"launches of kernel 3's {route} route")
    if launched <= 0:
        raise AssertionError(f"phase 13: n=221 did not take the {route} "
                             "route")
    check_solved(pt, d221, res, "phase 13 (n=221, pallas_kkt)")
    return counts


# Phase 14: files, the command line, the utilities and the sparse path.
# Copies of the fixtures of tests/test_qps.py and tests/test_maros_fixtures.py
# (the test modules import the JAX package, which this script does not).
HS21_WITH_CONST = """\
NAME          HS21
ROWS
 N  obj
 G  r1
COLUMNS
    x1        r1        10.0
    x2        r1        -1.0
RHS
    rhs       obj       100.0
    rhs       r1        10.0
BOUNDS
 LO bnd       x1        2.0
 UP bnd       x1        50.0
 LO bnd       x2        -50.0
 UP bnd       x2        50.0
QUADOBJ
    x1        x1        0.02
    x2        x2        2.0
ENDATA
"""
HS35 = """\
NAME          HS35
ROWS
 N  obj
 L  c1
COLUMNS
    x1        c1        1.0   obj       -8.0
    x2        c1        1.0   obj       -6.0
    x3        c1        2.0   obj       -4.0
RHS
    rhs       c1        3.0
    rhs       obj       -9.0
QUADOBJ
    x1        x1        4.0
    x1        x2        2.0
    x1        x3        2.0
    x2        x2        4.0
    x3        x3        2.0
ENDATA
"""
HS51 = """\
NAME          HS51
ROWS
 N  obj
 E  e1
 E  e2
 E  e3
COLUMNS
    x1        e1        1.0   obj       0.0
    x2        e1        3.0   e3        1.0
    x2        obj       -4.0
    x3        e2        1.0   obj       -4.0
    x4        e2        1.0   obj       -2.0
    x5        e2        -2.0  e3        -1.0
    x5        obj       -2.0
RHS
    rhs       e1        4.0
    rhs       obj       -6.0
BOUNDS
 FR bnd       x1
 FR bnd       x2
 FR bnd       x3
 FR bnd       x4
 FR bnd       x5
QUADOBJ
    x1        x1        2.0
    x1        x2        -2.0
    x2        x2        4.0
    x2        x3        2.0
    x3        x3        2.0
    x4        x4        2.0
    x5        x5        2.0
ENDATA
"""
# known optima of the three fixtures (tests/test_qps.py:70-74,
# tests/test_maros_fixtures.py:75-90)
FIXTURE_OPTIMA = {"HS21": -99.96, "HS35": 1.0 / 9.0, "HS51": 0.0}
# the sizes of phase 14: the full-width instance of examples/large_sparse.py,
# its reduced card-against-CPU copy, the banded problem and the fleets
PHASE14_N, PHASE14_M_INEQ = 10_000, 5_000
PHASE14_SMALL_N = 1_000
# the card-against-CPU copy, cut from 1,000 (12.2 s on the card and 6.4 s
# on the CPU) to fit the phase's time
PHASE14_CPU_N = 500
# cut from 2,000: the banded route is cyclic reduction on the card (26
# ms a Newton step at n=2,000 on an H100, 19.4 s; the scan took 223 ms,
# 167 s), and 15a solves the n=2,000 problem through it
PHASE14_BANDED_N = 500
PHASE14_FLEET_B = 64
PHASE14_HETERO_N = (600, 660, 720, 780, 840, 900, 960, 1000)
# card against CPU in 14c: the JAX package's acceptance for solves whose
# path moves with rounding (tests/test_torch_dense_modes.py); the readings
# on an H100 were 1.38e-7 and 1.39e-7 at n=1,000, 2.75e-7 at n=500
CARD_CPU_X_BAND = 1e-5


def large_sparse(n, m_ineq, seed=0):
    """examples/large_sparse.py's instance (a pentadiagonal Gram Q, m_ineq
    random rows of about 5 nonzeros and the box on every variable), as
    scipy.sparse CSR and numpy float64."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    bands = [rng.standard_normal(n - k) for k in range(3)]
    Bm = sps.diags(bands, offsets=[0, 1, 2])
    Q = (Bm.T @ Bm + 0.1 * sps.eye(n)).tocsr()
    q = rng.standard_normal(n)
    A_in = sps.random(m_ineq, n, density=5.0 / n, random_state=seed + 1,
                      data_rvs=rng.standard_normal).tocsr()
    A = sps.vstack([A_in, sps.eye(n)]).tocsr()
    l = np.concatenate([-rng.random(m_ineq) - 0.5, -2.0 * np.ones(n)])
    u = np.concatenate([rng.random(m_ineq) + 0.5, 2.0 * np.ones(n)])
    return Q, q, A, l, u


def second_difference(n, seed=0):
    """benchmarks/fuzz_sparse.py:gen kind 0: A = tridiag(1, -2, 1) of n-2
    rows, Q = c I with c in [1, 2), l = 0, u = +inf, q random."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.arange(3)[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    Q = sps.eye(n, format="csr") * (1 + rng.random())
    return Q, rng.standard_normal(n), A, np.zeros(m), np.full(m, np.inf)


def sparse_oracle(Q, q, A, l, u, x, y):
    """examples/large_sparse.py's independent KKT residuals of one
    problem: (max|Ax - clip(Ax + y, l, u)|, max|Qx + q + A'y|)."""
    Ax = A @ x
    return (float(np.max(np.abs(Ax - np.clip(Ax + y, l, u)))),
            float(np.max(np.abs(Q @ x + q + A.T @ y))))


def check_sparse(pt, problems, res, what):
    """A sparse solve's gate: on the card, every problem SOLVED, each
    within the oracle at 1.1e-6.  ``res`` is one batched Result or a list
    of one per problem."""
    results = res if isinstance(res, list) else [res]
    xs = [r.x[k] for r in results for k in range(r.x.shape[0])]
    ys = [r.y[k] for r in results for k in range(r.y.shape[0])]
    st = [int(v) for r in results for v in r.info.status_val.cpu().tolist()]
    if not all(on_card(r.x, r.y) for r in results):
        raise AssertionError(f"{what}: results are not on the card")
    worst = 0.0
    for p, x, y in zip(problems, xs, ys):
        x, y = x.cpu().numpy(), y.cpu().numpy()
        if x.shape != p[1].shape or not (np.isfinite(x).all()
                                         and np.isfinite(y).all()):
            raise AssertionError(f"{what}: bad solution shape or values")
        worst = max(worst, *sparse_oracle(*p[:5], x, y))
    solved = sum(v == pt.SOLVED for v in st)
    print(f"{what}: solved {solved}/{len(problems)}, oracle max {worst:.3e}",
          flush=True)
    if solved != len(problems) or not worst <= 1.1e-6:
        raise AssertionError(f"{what}: not every problem SOLVED within the "
                             f"oracle (statuses {sorted(set(st))})")
    return worst


def sparse_fleet(n, B, seed):
    """B instances of the large_sparse generator at n with one pattern:
    Q's and A's values and q redrawn per instance."""
    Q, q, A, l, u = large_sparse(n, n // 2, seed)
    rng = np.random.default_rng(seed + 100)
    fleet = []
    for _ in range(B):
        Qb, Ab = Q.copy(), A.copy()
        Qb.data = Qb.data * (1.0 + 0.1 * rng.random())
        Ab.data = Ab.data + 0.05 * rng.standard_normal(Ab.nnz)
        fleet.append((Qb, rng.standard_normal(n), Ab, l, u))
    return fleet


def run_cli(argv, module):
    """``module.main(argv)`` in this process, its standard output
    captured.  Returns (exit code, the JSON lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()
                if line.startswith("{")]


def check_cli_lines(lines, d0, what):
    """The JSON lines of the four files of phase 14a (with
    --print-solution): every file SOLVED, the fixtures at their optima,
    bench problem 0 within the oracle."""
    results = [ln for ln in lines if "status" in ln]
    sols = [ln for ln in lines if "x" in ln]
    if len(results) != 4 or len(sols) != 4:
        raise AssertionError(f"{what}: {len(results)} result lines")
    for res, sol in zip(results, sols):
        if res["status"] != "solved":
            raise AssertionError(f"{what}: {res['name']} {res['status']}")
        if res["name"] in FIXTURE_OPTIMA:
            err = abs(res["objective"] - FIXTURE_OPTIMA[res["name"]])
            if not err <= 1e-6:
                raise AssertionError(f"{what}: {res['name']} objective "
                                     f"{res['objective']}")
        else:
            x, y = np.array(sol["x"]), np.array(sol["y"])
            rp, rd = oracle({k: v[:1] for k, v in d0.items()}, x[None],
                            y[None])
            if not (rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6):
                raise AssertionError(f"{what}: problem 0 oracle {rp}, {rd}")
    print(f"{what}: " + ", ".join(
        f"{r['name']} {r['status']} in {r['iterations']} iterations, "
        f"objective {r['objective']:.10g}" for r in results), flush=True)


@contextlib.contextmanager
def recording_shapes(shapes, maps=None):
    """Add to the set ``shapes`` the (name, dtype, (B, m, n)) of every
    call that the solver makes on the card to the formation and residual
    wrappers while the context is open; with a dict ``maps``, also the
    ("ordered_sum", dtype, (B, terms, targets)) of every ordered segment
    sum of the sparse operator and its setup, with the segment map of the
    first call of each in ``maps``.  The calls go through unchanged, so
    the wrappers count their launches as before."""
    from qpdo_tpu_torch import operators
    from qpdo_tpu_torch.ops import linalg
    from qpdo_tpu_torch.solver import core
    from qpdo_tpu_torch.solver import sparse

    formation, residuals = linalg.fused_formation, core.fused_residuals
    segment_sum = operators.ordered_segment_sum
    card = torch.device(DEVICE).type

    def recorded_formation(A, w, Q, sigma):
        if A.device.type == card:
            shapes.add(("formation", A.dtype, tuple(A.shape)))
        return formation(A, w, Q, sigma)

    def recorded_residuals(*args, **kwargs):
        Ax, Qx = args[0], args[8]
        if Ax.device.type == card:
            shapes.add(("residuals", Ax.dtype, (*Ax.shape, Qx.shape[1])))
        return residuals(*args, **kwargs)

    def recorded_segment_sum(values, seg):
        if values.device.type == card:
            key = ("ordered_sum", values.dtype,
                   (*values.shape, seg[2].shape[0] - 1))
            shapes.add(key)
            maps.setdefault(key, seg)
        return segment_sum(values, seg)

    linalg.fused_formation = recorded_formation
    core.fused_residuals = recorded_residuals
    if maps is not None:
        operators.ordered_segment_sum = recorded_segment_sum
        sparse.ordered_segment_sum = recorded_segment_sum
    try:
        yield shapes
    finally:
        linalg.fused_formation, core.fused_residuals = formation, residuals
        operators.ordered_segment_sum = segment_sum
        sparse.ordered_segment_sum = segment_sum


def check_ordered_sum(dtype, shape, seg):
    """The ordered segment sum kernel on fresh values of ``shape`` (B,
    terms, targets) over the segment map ``seg`` (on the card) against its
    plain version, index_add_ on the CPU: bit for bit.  Returns the max
    abs error."""
    from qpdo_tpu_torch.ops import ordered_sum as osum

    b, terms, _ = shape
    g = torch.Generator(device=DEVICE).manual_seed(terms)
    values = (torch.randn((b, terms), dtype=dtype, device=DEVICE, generator=g)
              * 10.0 ** (12 * torch.rand((b, terms), dtype=dtype,
                                         device=DEVICE, generator=g) - 6))
    got = osum.ordered_segment_sum(values, seg).cpu()
    want = osum.reference_segment_sum(values.cpu(),
                                      tuple(t.cpu() for t in seg))
    if not torch.equal(got, want):
        raise AssertionError(f"ordered_sum {dtype} at {shape}: not the bits "
                             "of index_add_ on the CPU")
    return (got - want).abs().max().item() if got.numel() else 0.0


def check_path_shapes(ff, fr, shapes, what, maps=None):
    """Each kernel against its plain version at every shape of
    ``shapes`` (recording_shapes), on fresh inputs of that shape: the
    residual kernel and the ordered segment sum (over the recorded map,
    ``maps``) bit for bit, the formation kernel within FORMATION_TOL.
    Returns {(name, dtype, shape): max abs err}."""
    errs = {}
    for name, dtype, (b, m, n) in sorted(shapes, key=str):
        if name == "ordered_sum":
            err = check_ordered_sum(dtype, (b, m, n),
                                    maps[(name, dtype, (b, m, n))])
            errs[(name, dtype, (b, m, n))] = err
            print(f"{what}: ordered_sum {dtype} at B={b} terms={m} targets="
                  f"{n}: bit-identical to index_add_ on the CPU")
            continue
        if name == "formation":
            err, _ = check_formation(ff, dtype, FORMATION_TOL[dtype], b, m, n)
            how = f"within {FORMATION_TOL[dtype]} of max|K|"
        else:
            err = check_residuals(fr, dtype, b, RESIDUAL_RTOL[dtype], m, n)
            how = "all nine outputs bit-identical"
        errs[(name, dtype, (b, m, n))] = err
        print(f"{what}: {name} {dtype} at B={b} m={m} n={n}: {how} "
              f"(max abs err {err:.3e})")
    return errs


def timed_solve(fn):
    """(result, seconds) of ``fn()``, the card synchronized on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase14(pt, ff, fr, fk, card):
    """Files, the command line, the utilities and the sparse path on the
    card.  Returns ({"cli": launches, "sparse": launches}, the residual
    kernel's times at B=1 of the full-width sparse shape, the kernels'
    errors at each shape the path gave them, as check_path_shapes, and
    14c's solve (cg_counted_solve, with "run" to solve it again))."""
    import os
    import shutil
    import tempfile

    import qpdo_tpu_torch.__main__ as cli
    from qpdo_tpu_torch.io import QPSData, read_qps, write_qps
    from qpdo_tpu_torch.native import read_qps_native
    from qpdo_tpu_torch.solver.sparse import setup_sparse
    from qpdo_tpu_torch.utils import checkpoint, profiling

    launches = {}
    shapes, maps = set(), {}
    tmp = tempfile.mkdtemp(prefix="qpdo_phase14_")
    try:
        # ---- 14a: the command line, dense branch ----
        d0 = bench_problems(1, N, M, seed=0)
        files = []
        for name, text in (("hs21", HS21_WITH_CONST), ("hs35", HS35),
                           ("hs51", HS51)):
            files.append(os.path.join(tmp, name + ".qps"))
            with open(files[-1], "w") as f:
                f.write(text)
        files.append(os.path.join(tmp, "bench0.qps"))
        write_qps(QPSData(name="BENCH0", Q=d0["Q"][0], q=d0["q"][0], c=0.0,
                          A=d0["A"][0], l=d0["l"][0], u=d0["u"][0],
                          n_structural=M), files[-1])
        reset_counts(ff, fr, fk)
        with recording_shapes(shapes, maps):
            (rc, lines), cli_s = timed_solve(
                lambda: run_cli(["--print-solution", *files], cli))
        launches["cli"] = launch_counts(ff, fr, fk)
        print(f"phase 14a: main([...]) on 4 files: exit code {rc}, "
              f"{cli_s:.2f} s, kernel launches {printable(launches['cli'])}")
        check_cli_lines(lines, d0, "phase 14a in-process")
        require_launched(launches["cli"], "phase 14a", ("formation", F64),
                         ("residuals", F64))
        if rc != 0:
            raise AssertionError(f"phase 14a: exit code {rc}")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "qpdo_tpu_torch", "--print-solution",
             *files], capture_output=True, text=True, timeout=300)
        print(f"phase 14a: python -m qpdo_tpu_torch: exit code "
              f"{proc.returncode}, {time.perf_counter() - t0:.2f} s with "
              f"the start-up")
        if proc.returncode != 0:
            raise AssertionError(f"phase 14a subprocess: {proc.stderr[-2000:]}")
        check_cli_lines([json.loads(ln) for ln in proc.stdout.splitlines()
                         if ln.startswith("{")], d0, "phase 14a subprocess")

        # ---- 14b: the parsers on the full-width instance ----
        big = large_sparse(PHASE14_N, PHASE14_M_INEQ)
        Q, q, A, l, u = big
        big_path = os.path.join(tmp, "large_sparse.qps")
        t0 = time.perf_counter()
        write_qps(QPSData(name="LARGE", Q=Q, q=q, c=0.0, A=A, l=l, u=u,
                          n_structural=A.shape[0]), big_path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = read_qps(big_path, dense=False)
        py_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat = read_qps_native(big_path, dense=False)
        nat_s = time.perf_counter() - t0
        same = (py.Q.shape == nat.Q.shape and py.A.shape == nat.A.shape
                and (py.Q != nat.Q).nnz == 0 and (py.A != nat.A).nnz == 0
                and all(np.array_equal(a, b) for a, b in (
                    (py.q, nat.q), (py.l, nat.l), (py.u, nat.u)))
                and py.c == nat.c and py.n_structural == nat.n_structural)
        print(f"phase 14b: n={PHASE14_N} m={A.shape[0]}: write_qps "
              f"{write_s:.2f} s ({os.path.getsize(big_path) / 1e6:.1f} MB), "
              f"read_qps {py_s:.3f} s, read_qps_native {nat_s:.3f} s, arrays "
              f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError("phase 14b: the parsers disagree")

        # ---- 14c: sparse CG at full width ----
        reset_counts(ff, fr, fk)
        with recording_shapes(shapes, maps):
            first = cg_counted_solve(pt, big)
        first["run"] = lambda: cg_counted_solve(pt, big)
        res, wall = first["res"], first["wall"]
        launches["sparse"] = launch_counts(ff, fr, fk)
        its = first["iterations"]
        print(f"phase 14c: solve_sparse n={PHASE14_N} m={A.shape[0]} "
              f"nnz(Q)={Q.nnz} nnz(A)={A.nnz} on the card: "
              f"{res.info.status[0]} in {its} iterations, {wall:.2f} s "
              f"({wall / max(its, 1) * 1e3:.1f} ms an iteration), "
              f"{first['cg_solves']} CG solves, "
              f"{first['cg_iterations'] / max(first['cg_solves'], 1):.1f} CG "
              f"iterations a Newton step, kernel launches "
              f"{printable(launches['sparse'])}")
        check_sparse(pt, [big], res, "phase 14c solve_sparse")
        require_launched(launches["sparse"], "phase 14c", ("residuals", F64),
                         ("ordered_sum", F64))
        op = setup_sparse(Q, q, A, l, u)
        xv = torch.randn((1, op.n), dtype=F64, device=DEVICE)
        yv = torch.randn((1, op.m), dtype=F64, device=DEVICE)
        for name, f in (("Amv", lambda: op.Amv(xv)),
                        ("Atmv", lambda: op.Atmv(yv))):
            print(f"phase 14c: {name} at this size: {time_ms(f):.5f} ms as "
                  f"called, {device_ms(f):.5f} ms on the card alone")
        m_big = A.shape[0]
        rargs = residual_inputs(F64, b=1, m=m_big, n=PHASE14_N)
        rk = lambda: fr.fused_residuals(*rargs)
        plain = lambda: fr.reference_residuals(*rargs)
        bms, by, nbytes = residual_bound(1, m_big, PHASE14_N, F64)
        sparse_shape = dict(B=1, m=m_big, n=PHASE14_N, ms=time_ms(rk),
                            device_ms=device_ms(rk), plain_ms=time_ms(plain),
                            library_route_device_ms=device_ms(plain),
                            bound_ms=bms, bound_by=by, bytes=nbytes)
        print(f"phase 14c: residual kernel float64 at B=1 m={m_big} "
              f"n={PHASE14_N}: {sparse_shape['ms']:.5f} ms as called, "
              f"{sparse_shape['device_ms']:.5f} ms on the card alone, bound "
              f"{bms:.5f} ms (by {by}, {nbytes / 1e6:.2f} MB); its plain "
              f"version (the library route: ATen elementwise and reduction "
              f"kernels) {sparse_shape['plain_ms']:.5f} ms as called, "
              f"{sparse_shape['library_route_device_ms']:.5f} ms on the card "
              f"alone")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "qpdo_tpu_torch", "--sparse",
             "--print-solution", big_path], capture_output=True, text=True,
            timeout=600)
        out = [json.loads(ln) for ln in proc.stdout.splitlines()
               if ln.startswith("{")]
        if proc.returncode != 0 or len(out) != 2:
            raise AssertionError(f"phase 14c --sparse: exit code "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
        rp, rd = sparse_oracle(Q, q, A, l, u, np.array(out[1]["x"]),
                               np.array(out[1]["y"]))
        print(f"phase 14c: python -m qpdo_tpu_torch --sparse: {out[0]['path']}"
              f" {out[0]['status']} in {out[0]['iterations']} iterations, "
              f"solve {out[0]['solve_s']} s, parse {out[0]['parse_s']} s, "
              f"{time.perf_counter() - t0:.1f} s with the start-up; oracle "
              f"{rp:.3e}, {rd:.3e}")
        if not (out[0]["status"] == "solved" and out[0]["path"] == "sparse"
                and rp <= 1.1e-6 and rd <= 1.1e-6):
            raise AssertionError("phase 14c: --sparse on the QPS file")
        small = large_sparse(PHASE14_CPU_N, PHASE14_CPU_N // 2)
        with recording_shapes(shapes, maps):
            both = {dev: timed_solve(
                lambda: pt.solve_sparse(*small, device=dev))
                for dev in (DEVICE, "cpu")}
        st = {dev: r.info.status[0] for dev, (r, _) in both.items()}
        it = {dev: int(r.info.iterations[0]) for dev, (r, _) in both.items()}
        dx = (both[DEVICE][0].x.cpu() - both["cpu"][0].x).abs().max().item()
        print(f"phase 14c: n={PHASE14_CPU_N}: card {st[DEVICE]} in "
              f"{it[DEVICE]} iterations ({both[DEVICE][1]:.2f} s), CPU "
              f"{st['cpu']} in {it['cpu']} ({both['cpu'][1]:.2f} s); "
              f"max|x card - x CPU| {dx:.3e}")
        # a rounding-sensitive count (37-42 at n=1,000 under a 1e-15 change
        # of A on the CPU, scripts/sparse_cg_sensitivity.py): held to its
        # status and x
        if not (st[DEVICE] == st["cpu"] == "solved"
                and dx <= CARD_CPU_X_BAND):
            raise AssertionError(f"phase 14c: card and CPU disagree (x "
                                 f"within {CARD_CPU_X_BAND}?)")
        check_sparse(pt, [small], both[DEVICE][0],
                     f"phase 14c n={PHASE14_CPU_N} card")

        # ---- 14d: the banded route (cyclic reduction on the card) ----
        band = second_difference(PHASE14_BANDED_N)
        exact = setup_sparse(*band).newton_exact(pt.Settings())
        with recording_shapes(shapes, maps):
            res, wall = timed_solve(lambda: pt.solve_sparse(*band))
        its = int(res.info.iterations[0])
        again = pt.solve_sparse(*band)
        same = (torch.equal(again.x, res.x) and torch.equal(again.y, res.y)
                and int(again.info.iterations[0]) == its)
        print(f"phase 14d: second difference n={PHASE14_BANDED_N}: banded "
              f"route (newton_exact) {exact}, {res.info.status[0]} in {its} "
              f"iterations, {wall:.2f} s, {wall / max(its, 1) * 1e3:.1f} ms a"
              f" Newton step; solved again: "
              f"{'the same bits (x, y, iterations)' if same else 'DIFFERENT'}")
        if not exact:
            raise AssertionError("phase 14d: the banded maps were not built")
        if not same:
            raise AssertionError("phase 14d: a second solve gave other bits")
        check_sparse(pt, [band], res, "phase 14d")

        # ---- 14e: fleets ----
        fleet = sparse_fleet(PHASE14_SMALL_N, PHASE14_FLEET_B, seed=3)
        with recording_shapes(shapes, maps):
            res, t_same = timed_solve(lambda: pt.solve_sparse_batch(fleet))
        check_sparse(pt, fleet, res, f"phase 14e same pattern "
                                     f"B={PHASE14_FLEET_B} ({t_same:.2f} s)")
        mixed = [large_sparse(PHASE14_SMALL_N, PHASE14_SMALL_N // 2, seed=s)
                 for s in range(10, 18)]
        with recording_shapes(shapes, maps):
            res, t_mixed = timed_solve(lambda: pt.solve_sparse_batch(mixed))
        check_sparse(pt, mixed, res, f"phase 14e mixed patterns B=8 "
                                     f"({t_mixed:.2f} s)")
        hetero = [large_sparse(n, n // 2, seed=20 + k)
                  for k, n in enumerate(PHASE14_HETERO_N)]
        with recording_shapes(shapes, maps):
            res, t_het = timed_solve(
                lambda: pt.solve_sparse_heterogeneous(hetero))
        check_sparse(pt, hetero, res, f"phase 14e heterogeneous B=8 "
                                      f"({t_het:.2f} s)")

        # ---- each kernel at the shapes that 14a and 14c-14e gave it ----
        big_shape = ("residuals", F64, (1, m_big, PHASE14_N))
        if big_shape not in shapes:
            raise AssertionError("phase 14: the residual kernel's shape of "
                                 "14c was not recorded")
        errs = check_path_shapes(ff, fr, shapes, "phase 14 shapes", maps)
        sparse_shape["max_abs_err"] = errs[big_shape]

        # ---- 14f: the utilities ----
        # the card-against-CPU solve of 14c again, timed by the utility
        timer = profiling.PhaseTimer()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        produced = []
        with timer.phase("solve", produced):
            start.record()
            res = pt.solve_sparse(*small)
            end.record()
            produced.append(res.x)
        end.synchronize()
        dev_s = start.elapsed_time(end) / 1e3
        equal = torch.equal(res.x, both[DEVICE][0].x)
        print(f"phase 14f: PhaseTimer {timer.times['solve']:.4f} s, device "
              f"events {dev_s:.4f} s; the n={PHASE14_CPU_N} solve of 14c "
              f"again: "
              f"{int(res.info.iterations[0])} iterations, x "
              f"{'bit for bit equal' if equal else 'DIFFERENT'}")
        if not timer.times["solve"] >= dev_s:
            raise AssertionError("phase 14f: PhaseTimer ended before the card")
        if not equal:
            raise AssertionError("phase 14f: a second solve gave another x")
        trace_dir = os.path.join(tmp, "trace")
        with profiling.trace(trace_dir):
            pt.solve_sparse(*second_difference(64))
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        ckpt = os.path.join(tmp, "result.npz")
        checkpoint.save_result(ckpt, res)
        back = checkpoint.load_result(ckpt, res)
        same = all(a.device == b.device and a.dtype == b.dtype
                   and a.shape == b.shape
                   and torch.equal(a.view(_BITS.get(a.dtype, a.dtype)),
                                   b.view(_BITS.get(b.dtype, b.dtype)))
                   for a, b in zip(flat_tensors(back), flat_tensors(res)))
        print(f"phase 14f: trace files {traces}; checkpoint round trip "
              f"{'bit for bit, on the card' if same else 'DIFFERENT'}")
        if not traces or not same:
            raise AssertionError("phase 14f: trace or checkpoint")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, sparse_shape, errs, first


@contextlib.contextmanager
def recording_pcg(calls):
    """Append to ``calls`` the (iterations, final relative residual) of
    problem 0 of every CG solve the sparse operator makes while the
    context is open."""
    from qpdo_tpu_torch import operators

    pcg = operators.pcg

    def recorded(*args, **kwargs):
        out = pcg(*args, **kwargs)
        calls.append((int(out[1][0]), float(out[2][0])))
        return out

    operators.pcg = recorded
    try:
        yield calls
    finally:
        operators.pcg = pcg


def cg_counted_solve(pt, data):
    """``solve_sparse`` of ``data`` on the card with its CG solves counted
    (a problem that is not banded: every CG solve is a Newton solve).
    Returns the result, the wall time, the iterations, the CG solves and
    CG iterations, every CG solve's (iterations, relative residual), x
    and y."""
    calls = []
    with recording_pcg(calls):
        res, wall = timed_solve(lambda: pt.solve_sparse(*data))
    return dict(res=res, wall=wall, iterations=int(res.info.iterations[0]),
                cg_solves=len(calls),
                cg_iterations=sum(its for its, _ in calls), cg_calls=calls,
                x=res.x, y=res.y)


def same_solve(a, b):
    """Whether two cg_counted_solve results have the same bits: x, y,
    iterations and every CG solve's count and residual."""
    return (torch.equal(a["x"], b["x"]) and torch.equal(a["y"], b["y"])
            and a["iterations"] == b["iterations"]
            and a["cg_calls"] == b["cg_calls"])


# the sizes of phase 15: the banded problem of 14d uncut, and the pair
# that holds cyclic reduction against the scan
PHASE15_BANDED_N = 2_000
PHASE15_PAIR_N = 500
# examples/continuation.py at its default N: the ladder 500, 1,000, 2,000,
# 4,000 and the example's settings
PHASE15_LADDER_N = 4_000
# a two-stage stochastic QP: S scenarios of ns variables and ms rows
# coupled through n0 first-stage variables (n = 5,140, m = 7,680), and
# the scenario count of its dense comparison
PHASE15_S, PHASE15_N0, PHASE15_NS, PHASE15_MS = 128, 20, 40, 60
PHASE15_DENSE_S = 16
# the sparse layer on the n=1,000 instance of examples/large_sparse.py,
# and the sparse applications' data: F of N x p at this density
PHASE15_LAYER_N = 1_000
PHASE15_F = (5_000, 2_000, 0.005)
# cyclic reduction against the scan: x within this share of max|x|; the
# structured solve against its dense form: x within this band
CR_SCAN_X_BAND = 1e-6
DENSE_X_BAND = 1e-6
# the sparse layer's card gradients against the CPU's, relative to the
# largest entry of each gradient, at a diff_mu where the adjoint CG
# converges: at the default 1e-8 the adjoint of this instance has cond
# 2.0e10 and its CG stops at the 2,000-iteration cap, 15% off numpy's
# solve (scripts/sparse_layer_adjoint.py), on the CPU as on the card
LAYER_GRAD_RTOL = 1e-5
LAYER_DIFF_MU = 1e-2
# the float32-factor ladder of 15b, cut from N=4,000 (294.0 s on the card:
# 668 float32 scan fallbacks and 601 float64 escalations, each a scan
# factorization) to the ladder 500, 1,000
PHASE15_LADDER_F32_N = 1_000


def cr_levels(nb):
    """The levels of cyclic reduction at full depth on nb blocks."""
    levels = 0
    while nb > 1:
        nb -= nb // 2
        levels += 1
    return levels


@contextlib.contextmanager
def counting_factors(counts):
    """Count, in ``counts``, the banded factorizations the solver makes
    while the context is open: cyclic reduction ("cr") and the scan by the
    dtype of its factor ("scan float32": the CR fallback's, or "scan
    float64")."""
    from qpdo_tpu_torch import operators

    cls = operators.SparseOperator
    scan, cr = cls._banded_factor_scan, cls._banded_factor_cr

    def counted_scan(D, E):
        key = f"scan {str(D.dtype).replace('torch.', '')}"
        counts[key] = counts.get(key, 0) + 1
        return scan(D, E)

    def counted_cr(*args):
        counts["cr"] = counts.get("cr", 0) + 1
        return cr(*args)

    cls._banded_factor_scan = staticmethod(counted_scan)
    cls._banded_factor_cr = staticmethod(counted_cr)
    try:
        yield counts
    finally:
        cls._banded_factor_scan = staticmethod(scan)
        cls._banded_factor_cr = staticmethod(cr)


def liswet(n, d):
    """examples/continuation.py's LISWET problem: min 0.5||x - d||^2
    s.t. x_i - 2 x_{i+1} + x_{i+2} >= 0 (with Q = (1 + 1e-3) I)."""
    import scipy.sparse as sps

    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.arange(3)[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    return (sps.eye(n, format="csr") * (1.0 + 1e-3), -d, A, np.zeros(m),
            np.full(m, np.inf))


def liswet_ladder(N):
    """examples/continuation.py's ladder: the levels halve from N down to
    the first at most 700, the data d = sin(4 pi t) + noise (seed 42) of
    the finest grid interpolated onto each."""
    rng = np.random.default_rng(42)
    t_fine = np.linspace(0, 1, N)
    d_fine = np.sin(4 * np.pi * t_fine) + 0.1 * rng.standard_normal(N)
    levels = [N]
    while levels[0] > 700:
        levels.insert(0, (levels[0] + 1) // 2)
    return levels, [liswet(n, np.interp(np.linspace(0, 1, n), t_fine,
                                        d_fine)) for n in levels]


def block_angular(S, ms, n0, ns, seed):
    """tests/test_structured.py:_random_bap at these sizes: numpy float64
    arrays of one two-stage problem."""
    rng = np.random.default_rng(seed)
    M0 = rng.standard_normal((n0, n0)) / np.sqrt(n0)
    Ms = rng.standard_normal((S, ns, ns)) / np.sqrt(ns)
    return (M0 @ M0.T + 0.5 * np.eye(n0),
            np.einsum("sij,skj->sik", Ms, Ms) + 0.5 * np.eye(ns),
            rng.standard_normal(n0), rng.standard_normal((S, ns)),
            rng.standard_normal((S, ms, n0)) * 0.5,
            rng.standard_normal((S, ms, ns)),
            -rng.random((S, ms)) - 0.1, rng.random((S, ms)) + 0.1,
            np.asarray(0.0))


def block_angular_oracle(p, x0, xs, y):
    """The KKT residuals of a two-stage problem, blockwise in numpy
    float64: (max|Ax - clip(Ax + y, l, u)|, max|Qx + q + A'y|)."""
    Q0, Qs, q0, qs, T, W, l, u, _ = p
    Ax = np.einsum("smn,n->sm", T, x0) + np.einsum("smk,sk->sm", W, xs)
    rp = np.abs(Ax - np.clip(Ax + y, l, u)).max()
    rd0 = Q0 @ x0 + q0 + np.einsum("smn,sm->n", T, y)
    rds = np.einsum("sij,sj->si", Qs, xs) + qs + np.einsum("smk,sm->sk", W, y)
    return float(rp), float(max(np.abs(rd0).max(), np.abs(rds).max()))


def sparse_regression(N, p, density, seed):
    """F (N x p, scipy CSR) of ``density`` with normal entries, a sparse
    truth of 20 entries and b = F x + 0.01 noise, from ``seed``: the data
    of tests/test_applications.py:test_lasso_sparse_large at this size."""
    import scipy.sparse as sps

    rng = np.random.default_rng(seed)
    F = sps.random(N, p, density=density, random_state=seed, format="csr")
    F.data[:] = rng.standard_normal(F.nnz)
    x_true = np.zeros(p)
    x_true[rng.choice(p, 20, replace=False)] = rng.standard_normal(20) * 2.0
    return F, F @ x_true + 0.01 * rng.standard_normal(N)


def phase15(pt, ff, fr, fk, card, seed, first_solve):
    """Cyclic reduction, the continuation ladder, the structured solve,
    the sparse layer and applications, and ELL against the scatter, on
    the card.  Returns (launches by path, the kernels' errors at each
    shape these paths gave them, as check_path_shapes)."""
    from qpdo_tpu_torch.solver import structured
    from qpdo_tpu_torch.solver.sparse import setup_sparse

    launches = {}
    shapes, maps = set(), {}

    # ---- 15a: cyclic reduction against the scan ----
    band = second_difference(PHASE15_BANDED_N)
    nb, b = setup_sparse(*band).bd_shape
    factors = {}
    reset_counts(ff, fr, fk)
    with recording_shapes(shapes, maps), counting_factors(factors):
        res, wall = timed_solve(lambda: pt.solve_sparse(*band))
    launches["cr"] = launch_counts(ff, fr, fk)
    its = int(res.info.iterations[0])
    print(f"phase 15a: second difference n={PHASE15_BANDED_N} (nb={nb} "
          f"blocks of {b}, {cr_levels(nb)} CR levels) through "
          f"banded_algo='auto': {res.info.status[0]} in {its} iterations, "
          f"{wall:.2f} s, {wall / max(its, 1) * 1e3:.2f} ms a Newton step, "
          f"factorizations {factors}, kernel launches "
          f"{printable(launches['cr'])}", flush=True)
    check_sparse(pt, [band], res, "phase 15a auto")
    require_launched(launches["cr"], "phase 15a", ("residuals", F64),
                     ("ordered_sum", F64))
    if not factors.get("cr") or factors.get("scan float64"):
        raise AssertionError("phase 15a: 'auto' did not take cyclic "
                             "reduction on the card")
    pair = second_difference(PHASE15_PAIR_N, seed=1)
    runs = {}
    for algo in ("cr", "scan"):
        with recording_shapes(shapes, maps):
            runs[algo] = timed_solve(lambda: pt.solve_sparse(
                *pair, settings=pt.Settings(banded_algo=algo)))
    xs = {a: r.x[0].cpu().numpy() for a, (r, _) in runs.items()}
    gap = np.abs(xs["cr"] - xs["scan"]).max() / np.abs(xs["scan"]).max()
    print(f"phase 15a: n={PHASE15_PAIR_N}: " + "; ".join(
        f"{a} {r.info.status[0]} in {int(r.info.iterations[0])} iterations,"
        f" {w:.2f} s, {w / max(int(r.info.iterations[0]), 1) * 1e3:.2f} ms "
        f"a Newton step" for a, (r, w) in runs.items())
        + f"; max|x cr - x scan| / max|x| {gap:.3e}", flush=True)
    if not (runs["cr"][0].info.status == runs["scan"][0].info.status
            and gap <= CR_SCAN_X_BAND):
        raise AssertionError(f"phase 15a: CR and the scan disagree (x "
                             f"within {CR_SCAN_X_BAND} of max|x|?)")
    check_sparse(pt, [pair], runs["cr"][0], "phase 15a cr")

    # ---- 15b: the LISWET ladder of examples/continuation.py ----
    example = pt.Settings(eps_abs=1e-6, max_iter=100000, inner_max_iter=100,
                          eps_abs_in=0.1, rho=0.2, delta=1e-4, theta=0.9)
    reset_counts(ff, fr, fk)
    for name, settings, N in (
            ("float64 factor", example, PHASE15_LADDER_N),
            ("float32 factor", example.replace(kkt_dtype="float32",
                                               mu_min=1e-9, refine_steps=3),
             PHASE15_LADDER_F32_N)):
        levels, ladder = liswet_ladder(N)
        factors = {}
        per_level = []
        with recording_shapes(shapes, maps), counting_factors(factors):
            out, wall = timed_solve(lambda: pt.solve_continuation(
                ladder, settings,
                prolong=lambda x, y, i: pt.grid1d_prolong(
                    levels[i], levels[i + 1], order=2)(x, y),
                return_all=True, refine_final=True,
                progress=lambda i, r: per_level.append(
                    (levels[i], r.info.status[0],
                     int(r.info.iterations[0])))))
        fine = out[-1]
        rp, rd = sparse_oracle(*ladder[-1], fine.x[0].cpu().numpy(),
                               fine.y[0].cpu().numpy())
        print(f"phase 15b: ladder {levels}, {name}: per level (n, status, "
              f"iterations) {per_level}, finest {fine.info.status[0]} in "
              f"{int(fine.info.iterations[0])} iterations (after "
              f"refine_final), {wall:.2f} s, factorizations {factors}, "
              f"oracle {rp:.3e}, {rd:.3e}", flush=True)
        if not (fine.info.status == ["solved"] and rp <= 1.1e-6
                and rd <= 1.1e-6 and on_card(fine.x, fine.y)):
            raise AssertionError(f"phase 15b {name}: the finest level")
    launches["continuation"] = launch_counts(ff, fr, fk)
    require_launched(launches["continuation"], "phase 15b",
                     ("residuals", F64), ("ordered_sum", F64))

    # ---- 15c: a two-stage stochastic QP through the structured path ----
    S, n0, ns, ms = PHASE15_S, PHASE15_N0, PHASE15_NS, PHASE15_MS
    p = block_angular(S, ms, n0, ns, seed)
    reset_counts(ff, fr, fk)
    with recording_shapes(shapes, maps):
        res, wall = timed_solve(
            lambda: structured.solve_block_angular_result(
                structured.BlockAngularProblem(*p)))
    launches["structured"] = launch_counts(ff, fr, fk)
    its = int(res.info.iterations[0])
    x0, xs, y = (v[0].cpu().numpy() for v in (*res.x, res.y))
    rp, rd = block_angular_oracle(p, x0, xs, y)
    print(f"phase 15c: S={S} n0={n0} ns={ns} ms={ms} (n={n0 + S * ns}, "
          f"m={S * ms}): {res.info.status[0]} in {its} iterations, "
          f"{wall:.2f} s ({wall / max(its, 1) * 1e3:.2f} ms an iteration), "
          f"oracle {rp:.3e}, {rd:.3e}, kernel launches "
          f"{printable(launches['structured'])}", flush=True)
    if not (res.info.status == ["solved"] and rp <= 1.1e-6 and rd <= 1.1e-6
            and on_card(*res.x, res.y)):
        raise AssertionError("phase 15c: the structured solve")
    require_launched(launches["structured"], "phase 15c", ("residuals", F64))
    small = structured.BlockAngularProblem(*block_angular(
        PHASE15_DENSE_S, ms, n0, ns, seed))
    with recording_shapes(shapes, maps):
        sres = structured.solve_block_angular_result(small)
        dense = pt.solve(structured.to_dense_problem(small))
    gap = (torch.cat([sres.x[0], sres.x[1].flatten(1)], 1)
           - dense.x).abs().max().item()
    print(f"phase 15c: S={PHASE15_DENSE_S}: structured "
          f"{sres.info.status[0]} in {int(sres.info.iterations[0])} "
          f"iterations, dense {dense.info.status[0]} in "
          f"{int(dense.info.iterations[0])}; max|x structured - x dense| "
          f"{gap:.3e}", flush=True)
    if not (sres.info.status == dense.info.status == ["solved"]
            and gap <= DENSE_X_BAND):
        raise AssertionError("phase 15c: structured against dense")

    # ---- 15d: the sparse layer and the sparse applications ----
    Q, q, A, l, u = large_sparse(PHASE15_LAYER_N, PHASE15_LAYER_N // 2)
    rng = np.random.default_rng(seed + 15)
    gx, gy = rng.standard_normal(Q.shape[0]), rng.standard_normal(A.shape[0])
    values = (Q.tocsr().tocoo().data, A.tocsr().tocoo().data, q, l, u)
    grads, times, adjoint = {}, {}, {}
    reset_counts(ff, fr, fk)
    for dev in (DEVICE, "cpu"):
        layer = pt.sparse_qp_layer(Q, A, diff_mu=LAYER_DIFF_MU, device=dev)
        ts = [torch.tensor(v, device=dev, requires_grad=True)
              for v in values]
        calls = []
        with recording_shapes(shapes, maps):
            (x, y), fwd = timed_solve(lambda: layer(*ts))
            loss = ((torch.as_tensor(gx, device=dev) * x).sum()
                    + (torch.as_tensor(gy, device=dev) * y).sum())
            with recording_pcg(calls):
                g, bwd = timed_solve(lambda: torch.autograd.grad(loss, ts))
        rp, rd = sparse_oracle(Q, q, A, l, u, x.detach().cpu().numpy(),
                               y.detach().cpu().numpy())
        adjoint[dev] = calls[-1]
        if not (rp <= 1.1e-6 and rd <= 1.1e-6 and calls[-1][1] <= 1e-10):
            raise AssertionError(f"phase 15d: the layer's forward solve or "
                                 f"adjoint on {dev} did not converge (oracle"
                                 f" {rp}, {rd}; adjoint CG {calls[-1]})")
        grads[dev] = [t.cpu().numpy() for t in g]
        times[dev] = (fwd, bwd)
        if dev == DEVICE:
            launches["sparse_layer"] = launch_counts(ff, fr, fk)
            if not on_card(x, y, *g):
                raise AssertionError("phase 15d: the layer left the card")
    errs = [np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)
            for a, b in zip(grads[DEVICE], grads["cpu"])]
    print(f"phase 15d: sparse_qp_layer n={Q.shape[0]} m={A.shape[0]} "
          f"diff_mu {LAYER_DIFF_MU}: forward {times[DEVICE][0]:.2f} s, "
          f"backward {times[DEVICE][1]:.2f} s on the card (CPU "
          f"{times['cpu'][0]:.2f}, {times['cpu'][1]:.2f} s); adjoint CG "
          f"(iterations, relative residual) card {adjoint[DEVICE]}, CPU "
          f"{adjoint['cpu']}; card gradients against the CPU's, relative to "
          f"max|g|: "
          + ", ".join(f"{k} {e:.3e}" for k, e in
                      zip(("q_data", "a_data", "q", "l", "u"), errs)),
          flush=True)
    require_launched(launches["sparse_layer"], "phase 15d",
                     ("residuals", F64), ("ordered_sum", F64))
    if not max(errs) <= LAYER_GRAD_RTOL:
        raise AssertionError(f"phase 15d: card gradients beyond "
                             f"{LAYER_GRAD_RTOL} of the CPU's")
    N_f, p_f, density = PHASE15_F
    F, b_f = sparse_regression(N_f, p_f, density, seed + 10)
    ladder_like = pt.Settings(eps_abs=1e-6, max_iter=20000,
                              inner_max_iter=100, eps_abs_in=0.1, rho=0.02,
                              delta=0.1)
    reset_counts(ff, fr, fk)
    for name, data in (("lasso_sparse", pt.applications.lasso_sparse(
                            F, b_f, 0.05)),
                       ("huber_sparse", pt.applications.huber_sparse(
                           F, b_f, 0.5))):
        with recording_shapes(shapes, maps):
            res, wall = timed_solve(lambda: pt.solve_sparse(
                *data, settings=ladder_like))
        print(f"phase 15d: {name} F {N_f}x{p_f} ({F.nnz} nonzeros): n="
              f"{data[0].shape[0]} m={data[2].shape[0]}, "
              f"{res.info.status[0]} in {int(res.info.iterations[0])} "
              f"iterations, {wall:.2f} s", flush=True)
        check_sparse(pt, [data], res, f"phase 15d {name}")
    launches["sparse_applications"] = launch_counts(ff, fr, fk)

    # ---- 15e: mixed-precision CG (the float32 sums), ELL against the
    # scatter at 14c's shape, 14c's solve again ----
    mixed = large_sparse(PHASE14_SMALL_N, PHASE14_SMALL_N // 2, seed=7)
    reset_counts(ff, fr, fk)
    with recording_shapes(shapes, maps):
        res, wall = timed_solve(lambda: pt.solve_sparse(
            *mixed, settings=pt.Settings(cg_dtype="float32")))
    launches["sparse_cg_f32"] = launch_counts(ff, fr, fk)
    print(f"phase 15e: n={PHASE14_SMALL_N} with cg_dtype='float32': "
          f"{res.info.status[0]} in {int(res.info.iterations[0])} "
          f"iterations, {wall:.2f} s, kernel launches "
          f"{printable(launches['sparse_cg_f32'])}", flush=True)
    require_launched(launches["sparse_cg_f32"], "phase 15e cg_dtype float32",
                     ("residuals", F64), ("ordered_sum", F32))
    check_sparse(pt, [mixed], res, "phase 15e cg_dtype float32")
    big = large_sparse(PHASE14_N, PHASE14_M_INEQ)
    op = setup_sparse(*big)
    if op.ellA is None or op.ellAt is None:
        raise AssertionError("phase 15e: no ELL maps on the card")
    scatter = op._replace(ellQ=None, ellA=None, ellAt=None)
    xv = torch.randn((1, op.n), dtype=F64, device=DEVICE)
    yv = torch.randn((1, op.m), dtype=F64, device=DEVICE)
    for name, v in (("Amv", xv), ("Atmv", yv)):
        fe, fs = (lambda o=o: getattr(o, name)(v) for o in (op, scatter))
        gap = (fe() - fs()).abs().max().item()
        print(f"phase 15e: {name} at n={op.n} m={op.m}: ELL "
              f"{time_ms(fe):.5f} ms as called, {device_ms(fe):.5f} ms on "
              f"the card alone; scatter {time_ms(fs):.5f}, "
              f"{device_ms(fs):.5f}; max|ELL - scatter| {gap:.3e}",
              flush=True)
    again = first_solve["run"]()
    same = same_solve(again, first_solve)
    print(f"phase 15e: 14c's solve again through ELL: {again['iterations']}"
          f" iterations, {again['cg_iterations']} CG iterations in "
          f"{again['cg_solves']} CG solves (14c: {first_solve['iterations']},"
          f" {first_solve['cg_iterations']} in {first_solve['cg_solves']}); "
          f"{'the same bits: x, y, iterations, every CG count and residual' if same else 'DIFFERENT'}"
          f" (max|dx| "
          f"{(again['x'] - first_solve['x']).abs().max().item():.3e}; with "
          f"index_add_'s atomics two runs took 53 and 55 iterations)",
          flush=True)
    if not same:
        raise AssertionError("phase 15e: 14c's solve again gave other bits")
    times = ordered_sum_times(op)

    errs = check_path_shapes(ff, fr, shapes, "phase 15 shapes", maps)
    return launches, errs, times


def ordered_sum_times(op):
    """The ordered segment sum at 14c's shape (the operator ``op``), in
    both dtypes, over the block-Jacobi map (once a Newton step) and the
    coarse restriction's (once a CG iteration): the kernel, its plain
    version (zeros + index_add_ on the card) and the library call
    (index_add_ alone, into a tensor made once), and the bound (bytes:
    the values, order and offsets read once, the sums written once).
    Returns {dtype: [one dict a map]}."""
    from qpdo_tpu_torch.ops import ordered_sum as osum

    times = {}
    for dtype in (F32, F64):
        size = torch.empty((), dtype=dtype).element_size()
        for name in ("segPJ", "segRC"):
            seg = getattr(op, name)
            terms, targets = seg[0].shape[0], seg[2].shape[0] - 1
            v = torch.randn((1, terms), dtype=dtype, device=DEVICE)
            out = torch.zeros((1, targets), dtype=dtype, device=DEVICE)
            k = lambda: osum.ordered_segment_sum(v, seg)
            p = lambda: osum.reference_segment_sum(v, seg)
            lib_call = lambda: out.index_add_(1, seg[0], v)
            nbytes = (terms * (size + 8) + (targets + 1) * 8
                      + targets * size)
            bms, by = bound_ms(nbytes, terms,
                               PEAK_F32 if dtype == F32 else PEAK_F64)
            r = dict(map=name, B=1, terms=terms, targets=targets,
                     ms=time_ms(k), device_ms=device_ms(k),
                     plain_ms=time_ms(p), library_ms=time_ms(lib_call),
                     library_device_ms=device_ms(lib_call), bound_ms=bms,
                     bound_by=by, bytes=nbytes)
            times.setdefault(dtype, []).append(r)
            print(f"phase 15e: ordered_sum {dtype} over {name} at 14c's "
                  f"shape (B=1, {terms} terms, {targets} targets): kernel "
                  f"{r['ms']:.5f} ms as called, {r['device_ms']:.5f} on the "
                  f"card alone; plain version (zeros + index_add_) "
                  f"{r['plain_ms']:.5f}; index_add_ alone "
                  f"{r['library_ms']:.5f}, {r['library_device_ms']:.5f} on "
                  f"the card alone; bound {bms:.5f} ms (by {by}, "
                  f"{nbytes / 1e6:.2f} MB)", flush=True)
    return times


def ordered_sum_rows(times):
    """Rows of the kernels line for the ordered segment sum, both dtypes:
    the headline at 14c's block-Jacobi map, every timed map under
    "shapes"."""
    rows = []
    for dtype, maps in times.items():
        head = maps[0]
        rows.append({
            "name": "ordered_sum", "dtype": str(dtype).replace("torch.", ""),
            "route": "cuda", "source": "qpdo_tpu_torch/csrc/ordered_sum.cu",
            "replaces": "none: the order of qpdo_tpu/operators.py:772-775's "
                        "scatter-adds, which XLA's scatter keeps on the TPU",
            "launches": 0, "max_abs_err": 0.0,
            **{k: head[k] for k in ("ms", "device_ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
            "library_device_ms": head["library_device_ms"],
            "library_call": "Tensor.index_add_", "shapes": maps})
    return rows


def flat_tensors(tree):
    """The tensors of nested tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree if v is not None for t in flat_tensors(v)]


# ---------------------------------------------------------------------------
# Phase 16: the distributed paths, in child processes
# ---------------------------------------------------------------------------

PHASE16_ROW_N, PHASE16_ROW_M = 200, (100_000, 100_001)
# kernel 1 at B=1, n=200: a rank's rows of the m=100,000 row-sharded solve,
# and the unsharded solve's
TALL_FORMATION_M = (50_000, 100_000)
# phase 14e's fleet of one pattern at n=1,000, cut from 64 to 16 problems
PHASE16_FLEET_N, PHASE16_FLEET_B = 1_000, 16
PHASE16_SERVE_REQUESTS = 64
PHASE16_ARROW = dict(S=128, n0=20, ns=40)
ARROW_RTOL = 1e-10
ROW_X_BAND = 1e-8           # max|x sharded - x unsharded| / max|x|
STRUCTURED_X_BAND = 1e-9
SERVE_X_BAND = 1e-8
PHASE16_CHILD_TIMEOUT = 600  # seconds for one group of children
PHASE16_PG_TIMEOUT = 300     # seconds a collective may wait


def random_qp(n, m, seed=0):
    """tests/utils.py:random_qp (dense, no equality rows): a random
    convex QP with a PSD Q of condition 1e3 and box constraints."""
    rng = np.random.default_rng(seed)
    V = np.linalg.qr(rng.standard_normal((n, n)))[0]
    Q = (V * np.logspace(-3, 0, n)) @ V.T
    Q = 0.5 * (Q + Q.T)
    return (Q, rng.standard_normal(n), rng.standard_normal((m, n)),
            -rng.random(m), rng.random(m))


def random_arrow(S, n0, ns, seed=0):
    """tests/test_schur.py:_random_arrow as numpy, with a batch axis of
    one: (K00, Kss, Bs, r0, rs)."""
    rng = np.random.default_rng(seed)
    M0 = rng.standard_normal((n0, n0))
    Ms = rng.standard_normal((S, ns, ns))
    arrays = (M0 @ M0.T + (S + 1) * np.eye(n0),
              np.einsum("sij,skj->sik", Ms, Ms) + ns * np.eye(ns),
              0.3 * rng.standard_normal((S, ns, n0)),
              rng.standard_normal(n0), rng.standard_normal((S, ns)))
    return [torch.as_tensor(a, device=DEVICE)[None] for a in arrays]


def _keyed(counts):
    """Launch counts by (kernel, dtype) as JSON-able "kernel dtype" keys."""
    return {f"{name} {str(dt).replace('torch.', '')}": n
            for (name, dt), n in counts.items()}


def _unkeyed(counts):
    out = {}
    for key, n in counts.items():
        name, dt = key.split()
        out[(name, getattr(torch, dt))] = n
    return out


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase16_children(backend, world, out_dir, seed):
    """Run ``world`` children of this script (``--phase16-child``) with
    the environment ``torchrun`` sets; wait for all of them under
    PHASE16_CHILD_TIMEOUT, killing the rest at the first failure.  Prints
    rank 0's output and returns every rank's JSON report."""
    import os

    port = str(_free_port())
    logs, procs = [], []
    try:
        for rank in range(world):
            # the ranks share the one card: its index is every rank's
            # local device (torchrun would count LOCAL_RANK up per process)
            env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       RANK=str(rank), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(rank % torch.cuda.device_count()),
                       PYTHONFAULTHANDLER="1", PYTHONUNBUFFERED="1")
            logs.append(open(out_dir / f"{backend}_rank{rank}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "--phase16-child", backend,
                 "--seed", str(seed)],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
        deadline = time.perf_counter() + PHASE16_CHILD_TIMEOUT
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    print(texts[0], end="", flush=True)
    codes = [p.returncode for p in procs]
    if any(codes):
        for r in range(1, world):
            print(f"--- phase 16 {backend} rank {r} ---\n{texts[r][-4000:]}")
        raise AssertionError(f"phase 16 ({backend}, {world} ranks): exit "
                             f"codes {codes} (-9: stopped after another "
                             "rank failed, or at the time limit of "
                             f"{PHASE16_CHILD_TIMEOUT} s)")
    return [json.loads((out_dir / f"{backend}_rank{r}.json").read_text())
            for r in range(world)]


def phase16(pt, ff, fr, fk, card, phase4_ref, seed):
    """The distributed paths on the card, in child processes (the parent
    never joins a process group): 2 ranks over gloo on the one card (NCCL
    refuses two ranks on one GPU) and 1 rank over NCCL.  Returns the
    launches by path (summed over the ranks), the kernels' errors at the
    shapes the children gave them, and kernel 1's times at the tall
    shapes (``tall_formation``)."""
    from pathlib import Path

    out_dir = Path(__file__).resolve().parent / "build" / "phase16"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "phase4.json").write_text(json.dumps(phase4_ref))
    launches, shapes = {}, set()
    for backend, world in (("gloo", 2), ("nccl", 1)):
        t0 = time.perf_counter()
        reports = phase16_children(backend, world, out_dir, seed)
        print(f"phase 16 ({backend}, {world} ranks) took "
              f"{time.perf_counter() - t0:.1f} s, on {card}", flush=True)
        for rep in reports:
            for path, counts in rep["launches"].items():
                acc = launches.setdefault(path, collections.Counter())
                acc.update(_unkeyed(counts))
            shapes |= {(name, getattr(torch, dt), tuple(shape))
                       for name, dt, shape in rep["shapes"]}
    launches = {path: {key: counts.get(key, 0)
                       for key in launch_counts(ff, fr, fk)}
                for path, counts in launches.items()}
    for path, counts in launches.items():
        print(f"phase 16: {path}: kernel launches over the ranks "
              f"{printable(counts)}", flush=True)
    errs = check_path_shapes(ff, fr, shapes, "phase 16")
    return launches, errs, tall_formation(ff, card)


def tall_formation(ff, card):
    """Kernel 1 at B=1, n=200 and m in TALL_FORMATION_M (the row-sharded
    solve's local rows, and the unsharded solve's), in both dtypes, its
    rows split over blocks: the number of chunks S, the error against the
    plain version, the same bits on a second call, and times beside the
    library route (``torch.matmul`` + elementwise, the plain version) and
    the bound (float64 at the FP64 tensor cores' peak, which the split
    route runs on).  Returns one dict per shape and dtype."""
    from qpdo_tpu_torch.ops import fused_formation

    n = PHASE16_ROW_N
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for dtype in (F32, F64):
        for m in TALL_FORMATION_M:
            A, w, Q, sigma = formation_inputs(dtype, b=1, m=m, n=n)
            kernel = lambda: ff.fused_formation(A, w, Q, sigma)
            library = lambda: ff.reference_formation(A, w, Q, sigma)
            K, K2, ref = kernel(), kernel(), library()
            torch.cuda.synchronize()
            err = (K - ref).abs().max().item()
            rel = err / ref.abs().max().item()
            same = torch.equal(K, K2)
            elems, ops = formation_work(1, m, n)
            size = torch.empty((), dtype=dtype).element_size()
            # float64 splits run on the FP64 tensor cores: their peak
            peak = PEAK_F32 if dtype == F32 else PEAK_F64_TENSOR
            bms, by = bound_ms(size * elems, ops, peak)
            row = dict(dtype=str(dtype).replace("torch.", ""), B=1, m=m, n=n,
                       splits=fused_formation.formation_splits(1, m, n, sms),
                       ms=time_ms(kernel, reps=20, warmup=3),
                       device_ms=device_ms(kernel, calls=10, replays=3),
                       library_ms=time_ms(library, reps=20, warmup=3),
                       library_device_ms=device_ms(library, calls=10,
                                                   replays=3),
                       bound_ms=bms, bound_by=by,
                       bound_peak_tflops=peak / 1e12, max_abs_err=err,
                       rel_err=rel, same_bits=same)
            rows.append(row)
            print(f"phase 16: formation {dtype} at B=1 m={m} n={n}, rows "
                  f"split into S={row['splits']} chunks: kernel "
                  f"{row['ms']:.4f} ms as called, {row['device_ms']:.4f} ms "
                  f"on the card; library route (torch.matmul + elementwise) "
                  f"{row['library_ms']:.4f} / {row['library_device_ms']:.4f} "
                  f"ms; bound {bms:.4f} ms ({by} at {peak / 1e12:.0f} "
                  f"TFLOP/s); error relative to max|K| "
                  f"{rel:.3e} (tol {FORMATION_TOL[dtype]}), a second call "
                  f"{'bit-identical' if same else 'DIFFERENT'}, on {card}",
                  flush=True)
            if not (rel <= FORMATION_TOL[dtype] and same and row["splits"] > 1):
                raise AssertionError(f"phase 16: formation {dtype} at m={m}")
    return rows


def phase16_child(backend, seed) -> int:
    """One rank of phase 16: join the group from the environment
    (``multihost.initialize``), run the sub-phases, and write the report
    (launches by path, the kernels' shapes, times) to
    build/phase16/<backend>_rank<r>.json.  Any failed gate raises."""
    import os
    from pathlib import Path

    import torch.distributed as dist

    import qpdo_tpu_torch as pt
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_kkt as fk
    from qpdo_tpu_torch.ops import fused_residuals as fr
    from qpdo_tpu_torch.parallel import multihost

    if not torch.cuda.is_available():
        print("phase 16 child: no CUDA device", file=sys.stderr)
        return 2
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"])
                          % torch.cuda.device_count())
    out_dir = Path(__file__).resolve().parent / "build" / "phase16"
    phase4_ref = json.loads((out_dir / "phase4.json").read_text())
    print(f"rank {rank}: joining the {backend} group", flush=True)
    multihost.initialize(backend=backend, timeout=PHASE16_PG_TIMEOUT)
    mesh = multihost.global_mesh("batch")
    tag = f"{backend}, {world} rank{'s' if world > 1 else ''}"
    report = dict(launches={}, shapes=[], times={})
    shapes = set()

    def say(*args):
        """Print on rank 0 (the parent shows rank 0's output); the other
        ranks log their progress to their own files."""
        if rank == 0:
            print(*args, flush=True)
        else:
            print(f"rank {rank}:", *[str(a)[:100] for a in args], flush=True)

    @contextlib.contextmanager
    def path(name, *required):
        """Count the launches of the path run inside, and record the
        shapes the solver gives the kernels."""
        reset_counts(ff, fr, fk)
        with recording_shapes(shapes):
            yield
        torch.cuda.synchronize()
        counts = launch_counts(ff, fr, fk)
        require_launched(counts, f"phase 16 {name} ({tag}, rank {rank})",
                         *required)
        report["launches"][name] = _keyed(counts)

    say(f"phase 16 ({tag}): {dist.get_backend()} group of "
        f"{dist.get_world_size()}, mesh {mesh.mesh_dim_names} of "
        f"{mesh.size()} on {mesh.device_type}; torch {torch.__version__}")
    t_all = time.perf_counter()
    phase16a(pt, mesh, rank, world, tag, path, say, report, phase4_ref)
    if backend == "gloo":
        phase16b(pt, mesh, rank, world, tag, path, say, report)
        phase16c(pt, mesh, rank, tag, say, report)
        phase16d(pt, mesh, rank, tag, path, say, report, seed)
        phase16e(pt, mesh, rank, tag, path, say, report)
        phase16f(pt, mesh, rank, tag, path, say, report)
    report["times"]["all_s"] = time.perf_counter() - t_all
    report["shapes"] = [[name, str(dt).replace("torch.", ""), list(shape)]
                        for name, dt, shape in sorted(shapes, key=str)]
    (out_dir / f"{backend}_rank{rank}.json").write_text(json.dumps(report))
    dist.destroy_process_group()
    return 0


def _gather_full(t):
    from qpdo_tpu_torch.parallel import full_tensor

    return full_tensor(t).cpu().numpy()


def phase16a(pt, mesh, rank, world, tag, path, say, report, phase4_ref):
    """The bench family at full width through the compacted solve_batch
    of shard_problems and through solve_batch_sharded, and each rank's own
    batch through distribute_batch + solve_batch."""
    from qpdo_tpu_torch.parallel import (multihost, shard_problems,
                                         solve_batch_sharded)
    from qpdo_tpu_torch.parallel.dtensor import local_block

    d = bench_problems(B, N, M)
    problems = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                             for k, v in d.items()})
    settings = bench_settings(pt)
    backend = tag.split(',')[0]
    ref_status = np.asarray(phase4_ref["status"])
    ref_iters = np.asarray(phase4_ref["iterations"])
    # phase 4's path with the batch split: compaction decided on the
    # global count of active problems (one all-reduce a chunk)
    with path(f"batch_sharded_compact_{backend}", ("formation", F32),
              ("residuals", F32), ("residuals", F64)):
        res, wall = timed_solve(lambda: pt.solve_batch(
            shard_problems(problems, mesh), settings, compact=True))
    report["times"]["batch_sharded_compact_s"] = wall
    status, iters = (_gather_full(res.info.status_val),
                     _gather_full(res.info.iterations))
    rp, rd = oracle(d, _gather_full(res.x), _gather_full(res.y))
    gap = int(np.abs(iters.astype(int) - ref_iters).max())
    solved = int((status == pt.SOLVED).sum())
    say(f"phase 16a ({tag}): solve_batch(shard_problems(...), compact=True) "
        f"B={B} n={N} m={M}: solved {solved}/{B} in {wall:.2f} s "
        f"({B / wall:.2f} QPs/s), oracle max rp {rp.max():.3e} rd "
        f"{rd.max():.3e}; against phase 4 (B={B}, compacted): statuses "
        f"{'equal' if np.array_equal(status, ref_status) else 'DIFFER'}, "
        f"max iteration difference {gap}")
    if not (solved == B and rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6
            and np.array_equal(status, ref_status)):
        raise AssertionError(f"phase 16a ({tag}): the compacted sharded "
                             "bench solve")

    with path(f"batch_sharded_{backend}", ("formation", F32),
              ("residuals", F32), ("residuals", F64)):
        res, wall = timed_solve(
            lambda: solve_batch_sharded(problems, mesh, settings))
    report["times"]["batch_sharded_s"] = wall
    # DTensor's own full_tensor() (all_gather_into_tensor) killed the
    # process over gloo on CUDA tensors (a segmentation fault, torch
    # 2.11): the port reads whole results with parallel.full_tensor
    local = res.x.to_local()
    status, iters = (_gather_full(res.info.status_val),
                     _gather_full(res.info.iterations))
    x, y = _gather_full(res.x), _gather_full(res.y)
    if (local.device.type != torch.device(DEVICE).type
            or local.shape[0] != B // world):
        raise AssertionError(f"phase 16a ({tag}): the local block "
                             f"{tuple(local.shape)} on {local.device}")
    rp, rd = oracle(d, x, y)
    gap = int(np.abs(iters.astype(int) - ref_iters).max())
    solved = int((status == pt.SOLVED).sum())
    # the unsharded solve of this rank's block, in a batch of its size: the
    # card's batched float32 GEMMs round by batch size, so the same problem
    # takes up to 2 iterations more or fewer in a batch of 128 than of 256
    # (measured in phase 16 on an H100), and the split is held to this
    block = pt.Problem(*(local_block(a, mesh) for a in problems))
    alone = pt.solve_batch(block, settings)
    same = (torch.equal(alone.info.iterations, res.info.iterations.to_local())
            and torch.equal(alone.x, res.x.to_local()))
    say(f"phase 16a ({tag}): solve_batch_sharded B={B} n={N} m={M}: solved "
        f"{solved}/{B} in {wall:.2f} s ({B / wall:.2f} QPs/s), oracle max "
        f"rp {rp.max():.3e} rd {rd.max():.3e}; each rank's block "
        f"{'bit for bit' if same else 'NOT'} its unsharded solve (x and "
        f"iterations); against phase 4 (B={B}, compacted): statuses "
        f"{'equal' if np.array_equal(status, ref_status) else 'DIFFER'}, "
        f"max iteration difference {gap}")
    if not (solved == B and rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6
            and np.array_equal(status, ref_status) and same):
        raise AssertionError(f"phase 16a ({tag}): the sharded bench solve")

    # each rank's own problems (tests/multihost_worker.py:34-44)
    dl = bench_problems(B // world, N, M, seed=100 + rank)
    local = pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                          for k, v in dl.items()})
    with path(f"distribute_batch_{backend}", ("formation", F32),
              ("residuals", F32), ("residuals", F64)):
        res, wall = timed_solve(lambda: pt.solve_batch(
            multihost.distribute_batch(local, mesh), settings))
    st = res.info.status_val.to_local().cpu().numpy()
    rp, rd = oracle(dl, res.x.to_local().cpu().numpy(),
                    res.y.to_local().cpu().numpy())
    all_st = _gather_full(res.info.status_val)
    say(f"phase 16a ({tag}): distribute_batch of {world} x {B // world} "
        f"own problems + solve_batch: solved "
        f"{int((all_st == pt.SOLVED).sum())}/{all_st.shape[0]} in "
        f"{wall:.2f} s; rank 0's oracle max rp {rp.max():.3e} rd "
        f"{rd.max():.3e}")
    if not ((st == pt.SOLVED).all() and rp.max() <= 1.1e-6
            and rd.max() <= 1.1e-6 and (all_st == pt.SOLVED).all()):
        raise AssertionError(f"phase 16a ({tag}): distribute_batch")


def phase16b(pt, mesh, rank, world, tag, path, say, report):
    """One QP of m >> n with its rows split over the ranks."""
    import torch.distributed as dist

    from qpdo_tpu_torch.parallel import solve_row_sharded

    n = PHASE16_ROW_N
    for m in PHASE16_ROW_M:
        Q, q, A, l, u = random_qp(n, m, seed=0)
        p = pt.make_problem(Q, q, A, l, u)
        with path(f"row_sharded_m{m}", ("formation", F64),
                  ("formation_split", F64), ("residuals", F64)):
            (res, m_orig), wall = timed_solve(
                lambda: solve_row_sharded(p, pt.Settings(), mesh=mesh))
        report["times"][f"row_sharded_m{m}_s"] = wall
        its = int(res.info.iterations[0])
        parts = [torch.empty_like(res.x) for _ in range(world)]
        dist.all_gather(parts, res.x, group=mesh.get_group())
        same_x = all(torch.equal(t, parts[0]) for t in parts)
        y = _gather_full(res.y)[0]
        x = res.x[0].cpu().numpy()
        Ax = A @ x
        rp = np.abs(Ax - np.clip(Ax + y[:m], l, u)).max()
        rd = np.abs(Q @ x + q + A.T @ y[:m]).max()
        m_pad = y.shape[0]
        tail_zero = bool((y[m:] == 0).all())
        say(f"phase 16b ({tag}): solve_row_sharded n={n} m={m} (padded to "
            f"{m_pad}, {m_pad // world} rows a rank): {res.info.status[0]} in "
            f"{its} iterations, {wall:.2f} s ({wall / max(its, 1) * 1e3:.1f} "
            f"ms an iteration), oracle {rp:.3e}, {rd:.3e}; padded tail of y "
            f"{'exactly 0' if tail_zero else 'NOT 0'}; x "
            f"{'bit-identical' if same_x else 'DIFFERS'} across ranks")
        if not (res.info.status == ["solved"] and m_orig == m
                and rp <= 1.1e-6 and rd <= 1.1e-6 and tail_zero and same_x):
            raise AssertionError(f"phase 16b ({tag}): m={m}")
        if m == PHASE16_ROW_M[0] and rank == 0:
            ref, wall1 = timed_solve(
                lambda: pt.solve(p, pt.Settings(linesearch="bisect")))
            xr = ref.x[0].cpu().numpy()
            band = np.abs(x - xr).max() / np.abs(xr).max()
            its1 = int(ref.info.iterations[0])
            say(f"phase 16b ({tag}): unsharded solve on the card: "
                f"{ref.info.status[0]} in {its1} iterations, {wall1:.2f} s; "
                f"max|x sharded - x unsharded| / max|x| {band:.3e}")
            report["times"]["row_unsharded_s"] = wall1
            if not (its1 == its and band <= ROW_X_BAND):
                raise AssertionError(f"phase 16b ({tag}): against the "
                                     "unsharded solve")


def phase16c(pt, mesh, rank, tag, say, report):
    """arrow_solve_sharded at phase 15c's shape against arrow_solve."""
    from qpdo_tpu_torch.ops.schur import (ArrowSystem, arrow_solve,
                                          arrow_solve_sharded)
    from qpdo_tpu_torch.parallel.dtensor import dtensor_from_local, local_block

    K00, Kss, Bs, r0, rs = random_arrow(**PHASE16_ARROW)
    split = lambda a: dtensor_from_local(local_block(a, mesh, 1), mesh, 1,
                                         a.shape[1])
    x0_ref, xs_ref = arrow_solve(ArrowSystem(K00, Kss, Bs), r0, rs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x0, xs = arrow_solve_sharded(ArrowSystem(K00, split(Kss), split(Bs)), r0,
                                 split(rs), mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    xs = _gather_full(xs)
    scale = max(x0_ref.abs().max().item(), xs_ref.abs().max().item())
    err = max((x0 - x0_ref).abs().max().item(),
              float(np.abs(xs - xs_ref.cpu().numpy()).max())) / scale
    report["times"]["arrow_s"] = wall
    say(f"phase 16c ({tag}): arrow_solve_sharded S={PHASE16_ARROW['S']} "
        f"n0={PHASE16_ARROW['n0']} ns={PHASE16_ARROW['ns']}: max error "
        f"relative to max|x| {err:.3e} against arrow_solve (tol "
        f"{ARROW_RTOL}), {wall * 1e3:.2f} ms")
    if not err <= ARROW_RTOL:
        raise AssertionError(f"phase 16c ({tag}): {err:.3e}")


def phase16d(pt, mesh, rank, tag, path, say, report, seed):
    """Phase 15c's S=128 problem with its scenarios split over the ranks,
    against the unsharded structured solve."""
    from qpdo_tpu_torch.parallel.dtensor import dtensor_from_local, local_block
    from qpdo_tpu_torch.solver import structured

    S, n0, ns, ms = PHASE15_S, PHASE15_N0, PHASE15_NS, PHASE15_MS
    p = block_angular(S, ms, n0, ns, seed)
    ref = structured.solve_block_angular_result(
        structured.BlockAngularProblem(*p), device=DEVICE)
    fields = structured.BlockAngularProblem._fields
    split = {"Qs", "qs", "T", "W", "l", "u"}

    def leaf(name, a):
        t = torch.as_tensor(a, device=DEVICE)
        if name not in split:
            return t
        return dtensor_from_local(local_block(t, mesh, 0), mesh, 0, S)

    sp = structured.BlockAngularProblem(*(leaf(k, a)
                                          for k, a in zip(fields, p)))
    with path("structured_sharded", ("residuals", F64)):
        res, wall = timed_solve(
            lambda: structured.solve_block_angular_result(sp))
    report["times"]["structured_s"] = wall
    x0, xs, y = (res.x[0][0].cpu().numpy(), _gather_full(res.x[1])[0],
                 _gather_full(res.y)[0])
    rp, rd = block_angular_oracle(p, x0, xs, y)
    gap = max(np.abs(x0 - ref.x[0][0].cpu().numpy()).max(),
              np.abs(xs - ref.x[1][0].cpu().numpy()).max())
    its, its_ref = int(res.info.iterations[0]), int(ref.info.iterations[0])
    say(f"phase 16d ({tag}): structured S={S} split over the ranks: "
        f"{res.info.status[0]} in {its} iterations (unsharded {its_ref}), "
        f"{wall:.2f} s, max|x - x unsharded| {gap:.3e}, oracle {rp:.3e}, "
        f"{rd:.3e}")
    if not (res.info.status == ["solved"] and its == its_ref
            and gap <= STRUCTURED_X_BAND and rp <= 1.1e-6 and rd <= 1.1e-6):
        raise AssertionError(f"phase 16d ({tag}): the sharded structured solve")


def phase16e(pt, mesh, rank, tag, path, say, report):
    """Phase 14e's fleet of one pattern (cut to 16 problems) split over
    the ranks: every problem SOLVED within the oracle.  CG counts move
    with rounding (ROADMAP Queue 3), so no count is held."""
    fleet = sparse_fleet(PHASE16_FLEET_N, PHASE16_FLEET_B, seed=3)
    with path("sparse_fleet_mesh", ("residuals", F64), ("ordered_sum", F64)):
        res, wall = timed_solve(lambda: pt.solve_sparse_batch(fleet,
                                                              mesh=mesh))
    report["times"]["sparse_fleet_s"] = wall
    st = _gather_full(res.info.status_val)
    x, y = _gather_full(res.x), _gather_full(res.y)
    worst = max(max(sparse_oracle(*p[:5], x[k], y[k]))
                for k, p in enumerate(fleet))
    say(f"phase 16e ({tag}): solve_sparse_batch n={PHASE16_FLEET_N} "
        f"B={PHASE16_FLEET_B} over the mesh: solved "
        f"{int((st == pt.SOLVED).sum())}/{PHASE16_FLEET_B} in {wall:.2f} s, "
        f"oracle max {worst:.3e}")
    if not ((st == pt.SOLVED).all() and worst <= 1.1e-6):
        raise AssertionError(f"phase 16e ({tag}): the sparse fleet")


def phase16f(pt, mesh, rank, tag, path, say, report):
    """SolverService(mesh=) on every rank, 64 bench-family requests
    submitted on rank 0, against direct solves."""
    from qpdo_tpu_torch.serve import SolverService

    d = bench_problems(PHASE16_SERVE_REQUESTS, N, M, seed=7)
    one = lambda k: pt.Problem(**{key: torch.as_tensor(v[k:k + 1],
                                                       device=DEVICE)
                                  for key, v in d.items()})
    results = []
    with path("serve_mesh", ("formation", F64), ("residuals", F64)):
        svc = SolverService(max_batch=32, max_wait_ms=20, mesh=mesh)
        t0 = time.perf_counter()
        try:
            if rank == 0:
                futs = [svc.submit(one(k))
                        for k in range(PHASE16_SERVE_REQUESTS)]
                results = [f.result(PHASE16_CHILD_TIMEOUT) for f in futs]
        finally:
            svc.shutdown()
        wall = time.perf_counter() - t0
    report["times"]["serve_s"] = wall
    if rank != 0:
        return
    x = np.stack([r.x[0].cpu().numpy() for r in results])
    y = np.stack([r.y[0].cpu().numpy() for r in results])
    st = np.array([int(r.info.status_val[0]) for r in results])
    rp, rd = oracle(d, x, y)
    direct = pt.solve_batch(pt.Problem(**{k: torch.as_tensor(v, device=DEVICE)
                                          for k, v in d.items()}))
    gap = float(np.abs(x - direct.x.cpu().numpy()).max())
    stats = svc.stats()
    say(f"phase 16f ({tag}): {PHASE16_SERVE_REQUESTS} requests through "
        f"SolverService(mesh=) in {wall:.2f} s ({stats['batches']} batches): "
        f"solved {int((st == pt.SOLVED).sum())}, oracle max rp "
        f"{rp.max():.3e} rd {rd.max():.3e}, max|x - x direct| {gap:.3e}")
    if not ((st == pt.SOLVED).all() and rp.max() <= 1.1e-6
            and rd.max() <= 1.1e-6 and gap <= SERVE_X_BAND
            and stats["completed"] == PHASE16_SERVE_REQUESTS):
        raise AssertionError(f"phase 16f ({tag}): the service over the mesh")


if __name__ == "__main__":
    sys.exit(main())
