"""Command-line solver:  python -m qpdo_tpu_torch problem.qps [options]

The port of ``qpdo_tpu/__main__.py``: reads QPs in QPS/MPS format (the
Maros-Mészáros container), solves each on the matching path (dense, or
sparse with ``--sparse`` or n above ``--dense-max-n``), and prints one
JSON line per file with the JAX command line's keys, a summary line for
several files, and optionally the solution vectors.  The exit code is 0
when every file is SOLVED, else 2.

It runs on the GPU ("cuda") unless ``--cpu`` is given; without a CUDA
device and without ``--cpu`` it raises.  The given settings run on every
device as they are: the JAX command line replaces them on a TPU by a
float32 factorization (``kkt_dtype="float32"``, ``refine_steps=2``,
``mu_min >= 1e-7``, ``precond_dtype="float32"``) because a float64
Cholesky crashes that device; the port has no such override, so a run on
the card solves what ``--cpu`` solves.  Files are parsed sparse
(``read_qps(..., dense=False)``), so ``--sparse`` and large files really
take ``solve_sparse``; the JAX command line's Python reader returns dense
arrays there and solves them densely.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m qpdo_tpu_torch",
        description="Solve a QPS/MPS convex QP with the qpdo_tpu_torch "
                    "solver.")
    p.add_argument("qps", nargs="+",
                   help="path(s) to QPS file(s); several files solve "
                        "sequentially with one JSON line each plus a "
                        "summary line (the Maros-Mészáros directory "
                        "workflow: python -m qpdo_tpu_torch mm/*.QPS)")
    p.add_argument("--eps", type=float, default=1e-6,
                   help="absolute KKT tolerance (default 1e-6)")
    p.add_argument("--max-iter", type=int, default=10000)
    p.add_argument("--max-time", type=float, default=float("inf"),
                   help="wall-clock cap in seconds")
    p.add_argument("--sparse", action="store_true",
                   help="force the sparse path (default: auto by size)")
    p.add_argument("--dense-max-n", type=int, default=1500,
                   help="densify below this n (default 1500)")
    p.add_argument("--ruiz-kkt", action="store_true",
                   help="joint Q/A KKT equilibration (wide-scale Q)")
    p.add_argument("--polish", action="store_true",
                   help="solution polish: exact active-set KKT solve, "
                        "verified per problem (dense path)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is the CUDA device)")
    p.add_argument("--verbose", action="store_true",
                   help="per-iteration table")
    p.add_argument("--print-solution", action="store_true",
                   help="also print x and y as JSON arrays")
    args = p.parse_args(argv)

    import numpy as np
    import scipy.sparse as sps
    import torch

    from . import Settings
    from .io.qps import read_qps, solve_qps_data

    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("python -m qpdo_tpu_torch: no CUDA device; pass "
                           "--cpu to solve on the CPU")
    settings = Settings(eps_abs=args.eps, max_iter=args.max_iter,
                        max_time=args.max_time, ruiz_kkt=args.ruiz_kkt,
                        polish=args.polish, verbose=args.verbose)

    def solve_one(path: str) -> int:
        t0 = time.perf_counter()
        data = read_qps(path, dense=False)
        n = data.q.shape[0]
        use_sparse = args.sparse or n > args.dense_max_n
        if not use_sparse:
            data = type(data)(
                name=data.name,
                Q=data.Q.toarray() if sps.issparse(data.Q) else data.Q,
                q=data.q, c=data.c,
                A=data.A.toarray() if sps.issparse(data.A) else data.A,
                l=data.l, u=data.u, n_structural=data.n_structural)
        parse_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = solve_qps_data(data, settings=settings, device=device)
        status = int(res.info.status_val[0])  # host sync
        solve_s = time.perf_counter() - t0

        out = {
            "name": data.name, "n": int(n), "m": int(data.l.shape[0]),
            "path": "sparse" if use_sparse else "dense",
            "status": res.info.status[0], "status_val": status,
            "iterations": int(res.info.iterations[0]),
            "objective": float(res.info.objective[0]),
            "res_prim": float(res.info.res_prim_norm[0]),
            "res_dual": float(res.info.res_dual_norm[0]),
            "parse_s": round(parse_s, 3), "solve_s": round(solve_s, 3),
        }
        print(json.dumps(out), flush=True)
        if args.print_solution:
            # NaN-filled solutions (infeasible statuses) stay valid JSON
            san = lambda v: [vi if np.isfinite(vi) else None
                             for vi in v.cpu().numpy().tolist()]
            print(json.dumps({"x": san(res.x[0]), "y": san(res.y[0])}))
        return status

    statuses = [solve_one(path) for path in args.qps]
    solved = sum(st == 1 for st in statuses)
    if len(args.qps) > 1:
        print(json.dumps({"files": len(args.qps), "solved": solved,
                          "solve_rate": round(solved / len(args.qps), 4)}))
    return 0 if solved == len(args.qps) else 2


if __name__ == "__main__":
    sys.exit(main())
