#!/usr/bin/env python3
"""How far the inexact dense Newton modes follow one path, in qpdo_tpu
(JAX) and qpdo_tpu_torch (PyTorch) on the CPU, float64.

    JAX_PLATFORMS=cpu python3 scripts/dense_mode_sensitivity.py

Prints three things:

1. ``kkt_solver="inv", kkt_cg_fixed=6`` (library defaults otherwise,
   ``max_iter=3000``) on ``random_qp(40, 60, seed)`` for seeds 21..30 of
   ``tests/utils.py``: status and iterations per problem, solved one by
   one and as one batch, in both packages.
2. ``kkt_solver="cg"`` and ``"inv"`` on the same batch: iterations.
3. The CG of the "cg" mode at its first Newton step (seed 21, Jacobi
   preconditioner, relative tolerance 1e-2): the iterate of a numpy CG on
   K against the same CG on K (1 + 1e-15), both against the iterate's
   size.
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
sys.path.insert(0, str(REPO / "tests"))

import qpdo_tpu as qt  # noqa: E402
import qpdo_tpu_torch as pt  # noqa: E402
from qpdo_tpu.operators import DenseOperator  # noqa: E402
from qpdo_tpu.ops.linalg import form_kkt  # noqa: E402
from qpdo_tpu.parallel.batch import solve_batch as jax_solve_batch  # noqa: E402
from qpdo_tpu.solver import core as jcore  # noqa: E402
from qpdo_tpu.solver.scaling import scale_problem  # noqa: E402
from utils import random_qp  # noqa: E402

SEEDS = range(21, 31)


def batch_of(problems):
    keys = ("Q", "q", "A", "l", "u")
    d = {k: np.stack([p[i] for p in problems]) for i, k in enumerate(keys)}
    d["c"] = np.zeros(len(problems))
    return d


def both_batched(d, **kw):
    s = qt.Settings(**kw)
    jr = jax_solve_batch(qt.Problem(**{k: jnp.asarray(v)
                                       for k, v in d.items()}), s)
    tr = pt.solve_batch(pt.Problem(**{k: torch.from_numpy(v)
                                      for k, v in d.items()}),
                        pt.Settings(**kw))
    return ((np.asarray(jr.info.status_val), np.asarray(jr.info.iterations)),
            (tr.info.status_val.numpy(), tr.info.iterations.numpy()))


def cg(K, b, dinv, tol, max_iter):
    x = np.zeros_like(b)
    r, z = b.copy(), dinv * b
    p, rz = z.copy(), b @ (dinv * b)
    k = 0
    while np.linalg.norm(r) > tol * np.linalg.norm(b) and k < max_iter:
        Kp = K @ p
        a = rz / (p @ Kp)
        x, r = x + a * p, r - a * Kp
        z = dinv * r
        rz, rz_old = r @ z, rz
        p = z + rz / rz_old * p
        k += 1
    return x, k


def main() -> int:
    problems = [random_qp(40, 60, seed=s) for s in SEEDS]
    kw = dict(kkt_solver="inv", kkt_cg_fixed=6, max_iter=3000)
    print(f"1. {kw}, seeds {SEEDS.start}..{SEEDS.stop - 1}, one by one:")
    for seed, p in zip(SEEDS, problems):
        jr = qt.solve(qt.make_problem(*p), qt.Settings(**kw))
        tr = pt.solve(pt.make_problem(*p, device="cpu"), pt.Settings(**kw))
        print(f"   seed {seed}: JAX {int(jr.info.status_val)} "
              f"{int(jr.info.iterations)}, port {int(tr.info.status_val)} "
              f"{int(tr.info.iterations)}")
    d = batch_of(problems)
    (js, ji), (ts, ti) = both_batched(d, **kw)
    print(f"   as one batch: JAX statuses {js.tolist()} iterations "
          f"{ji.tolist()}\n                 port statuses {ts.tolist()} "
          f"iterations {ti.tolist()}")
    for mode in ("cg", "inv"):
        (js, ji), (ts, ti) = both_batched(d, kkt_solver=mode)
        print(f"2. kkt_solver={mode!r}, one batch: JAX {ji.tolist()}, "
              f"port {ti.tolist()} (all SOLVED: "
              f"{bool(np.all(js == 1) and np.all(ts == 1))})")

    # 3. the first Newton step's system of the "cg" mode, seed 21
    s = qt.Settings(kkt_solver="cg")
    sp = scale_problem(qt.make_problem(*problems[0]), s.scaling)
    st = jcore.init_state(sp, s, None, None, False, False)
    op = DenseOperator(sp=sp)
    w = st.Ax + st.mu * (st.ybar - 0.5 * st.y)
    active = ((w <= op.l) | (w >= op.u)).astype(jnp.float64)
    K = np.asarray(form_kkt(sp.data.Q, sp.data.A, active, st.mu, st.sigma,
                            True))
    b = np.random.default_rng(0).standard_normal(K.shape[0])
    dinv = 1.0 / np.diag(K)
    x1, k1 = cg(K, b, dinv, 1e-2, 160)
    x2, k2 = cg(K * (1 + 1e-15), b, dinv, 1e-2, 160)
    print(f"3. CG to 1e-2 on the first step's K (cond {np.linalg.cond(K):.1f}"
          f"): {k1} and {k2} iterations, iterates differ by "
          f"{np.abs(x1 - x2).max():.3e} of max|x| {np.abs(x1).max():.3e} "
          f"(relative {np.abs(x1 - x2).max() / np.abs(x1).max():.2e})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
