#!/usr/bin/env python3
"""Time the residual kernel (Pallas kernel 2's port) of one checkout's
qpdo_tpu_torch on one NVIDIA GPU.

    python3 scripts/time_residuals.py [ROOT]

ROOT is the root of the checkout whose package is built and timed (this
one by default); give it another commit unpacked with ``git archive`` to
compare two versions on one card in one call, in turns.  The times are
those of ``chip_smoke.py`` phase 5, taken by its ``residual_times`` (of
this checkout, so both versions are timed the same way, through the
public wrapper only), for float32 and float64 at m=150, n=100 and each of
its residual batches, beside the bound and whether the outputs equal the
plain version's bit for bit.  The last line is one JSON object with every
number; the line before it the card's name and power limit.
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
        print("time_residuals: needs a CUDA device", file=sys.stderr)
        return 2
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    spec = importlib.util.spec_from_file_location("chip_smoke_of_this_checkout",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    from qpdo_tpu_torch.ops import fused_residuals as fr
    if Path(fr.__file__).resolve().parents[2] != root:
        raise SystemExit(f"imported {fr.__file__}, not the package of {root}")
    rows = []
    for dtype in (cs.F32, cs.F64):
        for b in cs.RESIDUAL_BATCHES:
            args = cs.residual_inputs(dtype, b=b)
            equal = not cs.bitwise_differs(fr.fused_residuals(*args),
                                           fr.reference_residuals(*args))
            row = dict(cs.residual_times(fr, dtype, b),
                       dtype=str(dtype).replace("torch.", ""),
                       bound_ms=cs.residual_bound(b, cs.M, cs.N, dtype)[0],
                       bitwise_equal=equal)
            print(f"time_residuals {root.name}: {row}", flush=True)
            rows.append(row)
    print(cs.card_line())
    print(json.dumps({"root": str(root), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
