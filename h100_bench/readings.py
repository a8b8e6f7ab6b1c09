"""The readings that the limits of a cell's check are set from (not run by
the benchmark's own runs).

    python3 h100_bench/readings.py --workload <cell> --seeds 11,12,13 --units 2 --dtype float64
    python3 h100_bench/readings.py --workload <cell> --seeds 11,12,13 --units 1 --dtype float32

For each seed, in one process, without the set-up's warm-up solve:
``--units`` units of its traffic at the cell's own size,
untimed, then the check; one JSON line
per seed with the numbers the check compares.  ``--dtype float64`` reads
the program as the configuration states it (the lower readings);
``--dtype float32`` is the control: the same program on the same inputs
through its float32 path (problems and warm starts cast to float32), the
precision below the configuration's float64 (the upper readings).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--dtype", choices=("float64", "float32"), default="float64")
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from h100_bench import harness

    cell = harness.Cell.find(args.workload, ROOT)
    dtype = getattr(torch, args.dtype)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cell, seed, args.device, dtype)
        run.state = None        # the fleet driver's set-up is only a warm-up
        index = run.driver.FIRST_UNIT
        for _ in range(args.units):
            res, key = run.driver.unit(run, run.state, index)
            run.units.append(harness.Unit(key, res.x, res.y, res.info.status_val,
                                          res.info.iterations))
            index += 1
        attempted, failed, checks = harness.judge(run)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype, "attempted": attempted,
                          "failed": failed,
                          "iterations_max": int(run.units[-1].iterations.max()),
                          "seconds": time.perf_counter() - t0,
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
