#!/usr/bin/env python3
"""Kernel 1's time on the card for a forced number of row chunks S, at the
tall shapes of the row-sharded solve (B=1, n=200, m = 50,000 and 100,000)
in float32 and float64, beside the S that ``formation_splits`` picks:
the data for choosing its constants.  Times are ``chip_smoke.device_ms``
(replays of a CUDA graph).  Run from the repository root on a machine
with a CUDA device and nvcc:

    python3 scripts/sweep_formation_splits.py
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from qpdo_tpu_torch import kernels  # noqa: E402
from qpdo_tpu_torch.ops import fused_formation as ff  # noqa: E402

SPLITS = (1, 22, 44, 66, 87, 132, 176, 264)


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_formation_splits: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line())
    kernels.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype in (torch.float32, torch.float64):
        for m in (50_000, 100_000):
            A, w, Q, sigma = cs.formation_inputs(dtype, b=1, m=m, n=200)
            K = torch.empty((1, 200, 200), dtype=dtype, device=A.device)
            times = {}
            for splits in SPLITS:
                partial = (torch.empty((1, splits, 200, 200), dtype=dtype,
                                       device=A.device) if splits > 1 else None)

                def call(splits=splits, partial=partial):
                    kernels.launch("formation", dtype,
                                   (A, w, Q, sigma, K, partial),
                                   (1, m, 200, splits))
                times[splits] = cs.device_ms(call, calls=10, replays=3)
            print(f"{dtype} B=1 m={m} n=200: formation_splits picks "
                  f"{ff.formation_splits(1, m, 200, sms)}; device_ms by S "
                  + ", ".join(f"{s}: {t:.4f}" for s, t in times.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
