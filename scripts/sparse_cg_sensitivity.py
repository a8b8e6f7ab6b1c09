#!/usr/bin/env python3
"""How far a CG-route sparse solve of qpdo_tpu_torch follows one path
under rounding, on the CPU, float64.

    python3 scripts/sparse_cg_sensitivity.py [n] [draws]

Solves the instance of examples/large_sparse.py at size n (default 1,000:
the card-against-CPU problem of chip_smoke.py phase 14c) with
``solve_sparse(..., device="cpu")`` at the library defaults, once as it
is and ``draws - 1`` times (default 8 in all) with the values of A
multiplied by 1 + 1e-15 z, z standard normal from seeds 101, 102, ...;
prints each status and iteration count and their spread.  The CG stops at
the Eisenstat-Walker tolerance (up to 1e-2 relative), so a relative
change of 1e-15 in A can move the count: the scatter adds of the card
(atomics) make such changes from run to run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the generator of phase 14)
import qpdo_tpu_torch as pt  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    draws = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    Q, q, A, l, u = chip_smoke.large_sparse(n, n // 2)
    counts = []
    for k in range(draws):
        A2 = A.copy()
        if k:
            rng = np.random.default_rng(100 + k)
            A2.data = A2.data * (1 + 1e-15 * rng.standard_normal(A2.nnz))
        res = pt.solve_sparse(Q, q, A2, l, u, device="cpu")
        counts.append(int(res.info.iterations[0]))
        print(f"draw {k}: {res.info.status[0]} in {counts[-1]} iterations",
              flush=True)
    print(f"n={n}: iterations {min(counts)}-{max(counts)} over {draws} "
          f"draws (spread {max(counts) - min(counts)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
