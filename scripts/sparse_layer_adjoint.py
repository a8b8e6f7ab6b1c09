#!/usr/bin/env python3
"""Whether the adjoint solve of qpdo_tpu_torch's sparse layer converges,
on the CPU, float64.

    python3 scripts/sparse_layer_adjoint.py [n]

Solves the instance of examples/large_sparse.py at size n (default 1,000:
the problem of chip_smoke.py phase 15d) with ``solve_sparse(...,
device="cpu")`` at the library defaults, takes the active set of the
solution as ``sparse_qp_layer``'s backward pass does, and for each
diff_mu in 1e-8 (the default, max(mu_min, 1e-8)), 1e-6, 1e-4, 1e-3 and
1e-2 solves the adjoint system K u = gx + A'W gy (K = Q + A' diag(act /
diff_mu) A, W = act / diff_mu, gx and gy normal from seed 15) with the
layer's own call, ``SparseOperator.newton_solve`` at cg_tol 1e-10 and
cg_max_iter 2000 on the unscaled data.  Prints cond(K), the CG's
iterations and final relative residual, and the error of u and of the
dual cotangent v = W (A u - gy) against numpy's dense solve of the same
K, each relative to its largest entry.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the generator of phase 15d)
import qpdo_tpu_torch as pt  # noqa: E402
from qpdo_tpu_torch import operators  # noqa: E402
from qpdo_tpu_torch.solver.sparse import setup_sparse  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000
    Q, q, A, l, u = chip_smoke.large_sparse(n, n // 2)
    rng = np.random.default_rng(15)
    gx, gy = rng.standard_normal(Q.shape[0]), rng.standard_normal(A.shape[0])
    res = pt.solve_sparse(Q, q, A, l, u, device="cpu")
    x, y = res.x[0].numpy(), res.y[0].numpy()
    z = A @ x + y
    act = ((z < l) | (z > u)).astype(float)
    print(f"n={n} m={A.shape[0]}: {res.info.status[0]} in "
          f"{int(res.info.iterations[0])} iterations, {int(act.sum())} "
          f"active rows")
    op0 = setup_sparse(Q, q, A, l, u, 0.0, 0, device="cpu")
    settings = pt.Settings(cg_tol=1e-10, cg_max_iter=2000)
    t = lambda v: torch.from_numpy(np.asarray(v, float)).reshape(1, -1)
    seen = []
    pcg = operators.pcg

    def recording(*args, **kwargs):
        out = pcg(*args, **kwargs)
        seen.append((int(out[1][0]), float(out[2][0])))
        return out

    operators.pcg = recording
    try:
        for mu in (1e-8, 1e-6, 1e-4, 1e-3, 1e-2):
            W = act / mu
            rhs = gx + A.T @ (W * gy)
            K = (Q + A.T @ A.multiply(W[:, None])).toarray()
            exact = np.linalg.solve(K, rhs)
            got = op0.newton_solve(t(act), t(np.full(len(l), mu)),
                                   torch.zeros(1, dtype=torch.float64),
                                   t(rhs), settings)[0].numpy()
            v, v_exact = W * (A @ got - gy), W * (A @ exact - gy)
            its, rel = seen[-1]
            rel_err = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
            print(f"diff_mu {mu:.0e}: cond(K) {np.linalg.cond(K):.3e}, CG "
                  f"{its} iterations to relative residual {rel:.3e}; error "
                  f"of u {rel_err(got, exact):.3e}, of v "
                  f"{rel_err(v, v_exact):.3e}")
    finally:
        operators.pcg = pcg
    return 0


if __name__ == "__main__":
    sys.exit(main())
