#!/usr/bin/env python3
"""Cold and warm-started iteration counts of qpdo_tpu (JAX) and
qpdo_tpu_torch (PyTorch) on the same problems, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/warm_start_parity.py [problems] [step]

Solves the first ``problems`` (default 12) QPs of the bench family
(n=100, m=150, seed 0) with both packages under ``kkt_dtype="float32",
mu_min=1e-7, refine_steps=2`` (the configuration of chip_smoke.py's phase
7 without the fused kernel, which the JAX package would run in interpret
mode), then re-solves them with q perturbed by ``step`` (default 0.01)
times a standard normal draw (seed 7), warm-started from the cold
solution.  Prints status and iteration counts per problem: the JAX
package is the arbiter of what a warm start should cost.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import qpdo_tpu as qt  # noqa: E402
import qpdo_tpu_torch as pt  # noqa: E402
from qpdo_tpu.parallel.batch import solve_batch as jax_solve_batch  # noqa: E402


def main() -> int:
    nprob = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    step = float(sys.argv[2]) if len(sys.argv) > 2 else 0.01
    B, n, m = 256, 100, 150
    rng = np.random.default_rng(0)
    Mx = rng.standard_normal((B, n, n))
    d = dict(Q=np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
             q=rng.standard_normal((B, n)), A=rng.standard_normal((B, m, n)),
             l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))
    q2 = d["q"] + step * np.random.default_rng(7).standard_normal((B, n))
    d = {k: v[:nprob] for k, v in d.items()}
    q2 = q2[:nprob]
    kw = dict(kkt_dtype="float32", mu_min=1e-7, refine_steps=2,
              pallas_residuals=True)

    jp = qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})
    cold = jax_solve_batch(jp, qt.Settings(**kw), compact=True)
    warm = jax_solve_batch(jp._replace(q=jnp.asarray(q2)), qt.Settings(**kw),
                           x0=cold.x, y0=cold.y, compact=True)
    rows = {"jax": (np.asarray(cold.info.iterations),
                    np.asarray(warm.info.status_val),
                    np.asarray(warm.info.iterations))}
    tp = pt.Problem(**{k: torch.as_tensor(v) for k, v in d.items()})
    for name, extra in (("torch", {}), ("torch pallas_kkt",
                                        {"pallas_kkt": True})):
        s = pt.Settings(**kw, **extra)
        cold = pt.solve_batch(tp, s, compact=True)
        warm = pt.solve_batch(tp._replace(q=torch.as_tensor(q2)), s,
                              x0=cold.x, y0=cold.y, compact=True)
        rows[name] = (cold.info.iterations.numpy(),
                      warm.info.status_val.numpy(),
                      warm.info.iterations.numpy())
    for name, (c, st, w) in rows.items():
        print(f"{name}: cold iterations {c.tolist()} (mean {c.mean():.2f}); "
              f"warm-started after a {step} change of q: statuses "
              f"{sorted(set(st.tolist()))}, iterations {w.tolist()} "
              f"(mean {w.mean():.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
