#!/usr/bin/env python3
"""Time the formation kernel (Pallas kernel 1's port) of one checkout's
qpdo_tpu_torch on one NVIDIA GPU.

    python3 scripts/time_formation.py [ROOT]

ROOT is the root of the checkout whose package is built and timed (this
one by default); give it another commit unpacked with ``git archive`` to
compare two versions on one card in one call, in turns.  The times are
``chip_smoke.device_ms`` of this checkout (replays of a CUDA graph of the
public wrapper), at the bench shape (B=256, m=150, n=100) and at B=1,
n=200, m=50,000, in float32 and float64.  The last line is one JSON
object with every number; the line before it the card's name and power
limit.
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
        print("time_formation: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    from qpdo_tpu_torch.ops import fused_formation as ff
    if Path(ff.__file__).resolve().parents[2] != root:
        raise SystemExit(f"imported {ff.__file__}, not the package of {root}")
    rows = []
    for dtype in (cs.F32, cs.F64):
        for b, m, n in ((cs.B, cs.M, cs.N), (1, 50_000, 200)):
            args = cs.formation_inputs(dtype, b=b, m=m, n=n)
            kernel = lambda: ff.fused_formation(*args)
            times = [round(cs.device_ms(kernel), 5) for _ in range(5)]
            row = dict(dtype=str(dtype).replace("torch.", ""), B=b, m=m, n=n,
                       device_ms=min(times), runs=times)
            print(f"time_formation {root.name}: {row}", flush=True)
            rows.append(row)
    print(cs.card_line())
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
