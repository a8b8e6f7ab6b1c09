#!/usr/bin/env python3
"""Time the two KKT kernels (Pallas kernels 3 and 4's port) of one
checkout's qpdo_tpu_torch on one NVIDIA GPU, on every route.

    python3 scripts/time_kkt_global.py [ROOT]

ROOT is the root of the checkout whose package is built and timed (this
one by default); give it another commit unpacked with ``git archive`` to
compare two versions on one card in one call, in turns.  The times are
``chip_smoke.device_ms`` of this checkout (replays of a CUDA graph of the
public wrappers ``fused_kkt_solve`` and ``chol_solve_stacked``, float32),
at the bench shape (B=256, m=150, n=100: the register route), at (32,
300, 200) (the shared-memory route) and at ``chip_smoke.LARGE_KKT_SHAPES``
(the global-memory route), on the inputs of chip_smoke.py's phases 6 and
6b.  The last line is one JSON object with every number; the line before
it the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("time_kkt_global: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_kkt as fk
    if Path(fk.__file__).resolve().parents[2] != root:
        raise SystemExit(f"imported {fk.__file__}, not the package of {root}")
    rows = []
    shapes = ((cs.B, cs.M, cs.N), (32, 300, 200), *cs.LARGE_KKT_SHAPES)
    for b, m, n in shapes:
        seed = 6 if n == cs.N else (16 if n == 200 else n)
        Q, A, w, sigma, rhs = cs.kkt_inputs(seed=seed, shape=(b, m, n))
        Khat, bhat, _ = cs.scaled_system(fk, ff, Q, A, w, sigma, rhs)
        for name, kernel in (
                ("kkt_solve", lambda: fk.fused_kkt_solve(Q, A, w, sigma, rhs)),
                ("chol_solve", lambda: fk.chol_solve_stacked(Khat, bhat))):
            times = [round(cs.device_ms(kernel, calls=20, replays=3), 5)
                     for _ in range(5)]
            row = dict(name=name, route=fk.kernel_route(name, n), B=b, m=m,
                       n=n, device_ms=min(times), runs=times)
            print(f"time_kkt_global {root.name}: {row}", flush=True)
            rows.append(row)
    print(cs.card_line())
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
