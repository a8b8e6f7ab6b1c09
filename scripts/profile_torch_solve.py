#!/usr/bin/env python3
"""Where the time of one qpdo_tpu_torch solve goes on one NVIDIA GPU.

    python3 scripts/profile_torch_solve.py [bench_ns] [pallas_kkt]

Solves the bench family of chip_smoke.py (B=256, n=100, m=150, seed 0)
with ``solve_batch(..., compact=True)`` under one of its two
configurations: ``bench_ns`` (chip_smoke phase 4: hybrid float32 warmup,
Newton-Schulz solves, bisection linesearch) or ``pallas_kkt`` (phase 7:
float64 state, every Newton solve the fused KKT kernel, sort linesearch).
For each it prints

* the wall time of an unprofiled solve (after one warm-up solve), the
  number of masked steps and their batch sizes, and the launches of the
  port's own kernels;
* from ``torch.profiler`` over one further solve: the number of device
  kernels launched, their summed device time, the card's busy share
  (device time over the unprofiled wall time) and the kernels that take
  the most device time;

with the card's name and power limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402


def profile(name: str) -> None:
    import qpdo_tpu_torch as pt
    from qpdo_tpu_torch.ops import fused_formation as ff
    from qpdo_tpu_torch.ops import fused_kkt as fk
    from qpdo_tpu_torch.ops import fused_residuals as fr
    from qpdo_tpu_torch.solver import core

    settings = {"bench_ns": cs.bench_settings,
                "pallas_kkt": cs.pallas_kkt_settings}[name](pt)
    d = cs.bench_problems(cs.B, cs.N, cs.M)
    problems = pt.Problem(**{k: torch.as_tensor(v, device=cs.DEVICE)
                             for k, v in d.items()})

    def solve():
        res = pt.solve_batch(problems, settings, compact=True)
        torch.cuda.synchronize()
        return res

    solve()                                   # build, warm up
    steps = collections.Counter()
    step = core.step

    def counting_step(op, stg, s, *rest):
        steps[(str(s.x.dtype).replace("torch.", ""), s.x.shape[0])] += 1
        return step(op, stg, s, *rest)

    core.step = counting_step
    try:
        cs.reset_counts(ff, fr, fk)
        t0 = time.perf_counter()
        res = solve()
        wall = time.perf_counter() - t0
    finally:
        core.step = step
    n_steps = sum(steps.values())
    counts = {name: {str(dtype).replace("torch.", ""): n
                     for dtype, n in fn.launches.items()}
              for name, fn in (("formation", ff.fused_formation),
                               ("residuals", fr.fused_residuals),
                               ("kkt_solve", fk.fused_kkt_solve))}
    print(f"{name}: unprofiled solve {wall:.4f} s, {cs.B / wall:.2f} QPs/s, "
          f"mean iterations {res.info.iterations.float().mean().item():.2f},"
          f" {n_steps} masked steps {dict(steps)}, {wall / n_steps * 1e3:.2f}"
          f" ms per step, the port's kernels launched {counts}")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        solve()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(e.count for e in rows)
    dev_s = sum(e.self_device_time_total for e in rows) / 1e6
    print(f"{name}: profiled solve: {launches} device kernels "
          f"({launches / n_steps:.0f} per step), device time {dev_s:.4f} s, "
          f"busy share {dev_s / wall:.3f} of the unprofiled wall")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d} x "
              f"{e.self_device_time_total / e.count:8.2f} us  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_solve: needs a CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line())
    for name in sys.argv[1:] or ["bench_ns", "pallas_kkt"]:
        profile(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
