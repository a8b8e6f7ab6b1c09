#!/usr/bin/env python3
"""How the iteration counts of chip_smoke.py's phase 7d move with the
rounding of the KKT kernel, on one NVIDIA GPU.

    python3 scripts/kkt_route_iterations.py [ROOT]

Phase 7d's problem (``chip_smoke.random_qp(1024, 1536)``, seed 0) with
phase 7's settings (``chip_smoke.pallas_kkt_settings``: float32 Newton
systems through the fused KKT kernel, two refinement steps, mu_min 1e-7)
through ``QPDO``: a cold solve, then a warm re-solve after the 1% change
of q of phase 7d, each held to chip_smoke's gate (SOLVED, the float64
oracle at 1.1e-6).  Three ways: on the route the package selects (the
cluster route), with the global route forced for every Newton system
(another float32 order of the same factor), and on the selected route
with q changed by one part in 1e12 (a perturbation below the solve's own
rounding).  ROOT is the checkout whose package is solved (this one by
default; give another commit unpacked with ``git archive`` to compare
two versions of the kernels on one card).  The last line is one JSON
object with the counts; the line before it the card's name and power
limit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("kkt_route_iterations: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    import qpdo_tpu_torch as pt
    from qpdo_tpu_torch.ops import fused_kkt as fk
    from qpdo_tpu_torch.ops import linalg
    if Path(fk.__file__).resolve().parents[2] != root:
        raise SystemExit(f"imported {fk.__file__}, not the package of {root}")

    n, m = cs.PHASE7D
    Q, q, A, l, u = cs.random_qp(n, m, seed=0)
    q2 = q + 0.01 * np.random.default_rng(12).standard_normal(n)
    settings = cs.pallas_kkt_settings(pt)
    selected = fk.kernel_route

    def forced(name, B, n, device=None):
        route = selected(name, B, n, device)
        return "global" if route == "cluster" else route

    rows = []
    for how, route, dq in (("selected route", selected, 0.0),
                           ("global route forced", forced, 0.0),
                           ("selected route, q changed by 1e-12", selected,
                            1e-12)):
        fk.kernel_route = linalg.kernel_route = route
        fk.fused_kkt_solve.routes.clear()
        qa, qb = q * (1.0 + dq), q2 * (1.0 + dq)
        solver = pt.QPDO()
        solver.setup(Q, qa, A, l, u, settings)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cold = solver.solve()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d = dict(Q=Q[None], q=qa[None], A=A[None], l=l[None], u=u[None])
        cs.check_solved(pt, d, cold, f"{how} (cold)")
        solver.warm_start(cold.x, cold.y)
        solver.update_q(qb)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        warm = solver.solve()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        cs.check_solved(pt, dict(d, q=qb[None]), warm, f"{how} (warm)")
        row = dict(how=how, cold=int(cold.info.iterations),
                   warm=int(warm.info.iterations), cold_s=t1 - t0,
                   warm_s=t3 - t2, routes=dict(fk.fused_kkt_solve.routes))
        print(f"kkt_route_iterations {root.name}: {row}", flush=True)
        rows.append(row)
    fk.kernel_route = linalg.kernel_route = selected
    print(cs.card_line())
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
