#!/usr/bin/env python3
"""The small batch of chip_smoke.py's phase 9 through both packages on the
CPU: qpdo_tpu (JAX, float64, its Pallas kernels in interpret mode) and
qpdo_tpu_torch (the kernels' plain versions).

    JAX_PLATFORMS=cpu python3 scripts/phase9_reference.py [draws] [variant ...]

For every variant of ``chip_smoke.variants`` (or the ones named) prints
the statuses and iteration counts per problem of the 16-problem batch
(``bench_problems(16, 40, 60, seed=1)``) in each package, and both
packages' counts on the same batch with A multiplied entry by entry by
1 + 1e-15 s (s = +-1 at random; ``draws`` draws, 2 unless told):
rounding-level changes of the data.  It names the problems whose counts
differ by more than 3 between the packages or move by more than 3 under
a perturbation in either package.  Phase 9 holds the card
to the CPU port within 3 iterations on every other problem: on these
the variant's path moves with rounding in the reference itself, so
there the card is held to the status alone.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import qpdo_tpu as qt  # noqa: E402
import qpdo_tpu_torch as pt  # noqa: E402
from qpdo_tpu.parallel.batch import _solve_batch_compact  # noqa: E402


def main() -> int:
    args = sys.argv[1:]
    draws = int(args.pop(0)) if args and args[0].isdigit() else 2
    only = set(args)
    ds = chip_smoke.bench_problems(16, 40, 60, seed=1)
    for name, settings, _, _ in chip_smoke.variants(pt):
        if only and name not in only:
            continue
        js = qt.Settings(**dataclasses.asdict(settings))
        jr = _solve_batch_compact(
            qt.Problem(**{k: jnp.asarray(v) for k, v in ds.items()}), js,
            None, None, False, False)
        tr = pt.solve_batch(pt.Problem(**{k: torch.from_numpy(v)
                                          for k, v in ds.items()}),
                            settings, compact=True)
        ji = np.asarray(jr.info.iterations).astype(int)
        ti = tr.info.iterations.numpy().astype(int)
        far = set(np.flatnonzero(np.abs(ji - ti) > 3).tolist())
        for draw in range(1, draws + 1):
            sign = np.random.default_rng(draw).choice([-1.0, 1.0],
                                                      ds["A"].shape)
            dp = dict(ds, A=ds["A"] * (1.0 + 1e-15 * sign))
            pr = _solve_batch_compact(
                qt.Problem(**{k: jnp.asarray(v) for k, v in dp.items()}), js,
                None, None, False, False)
            pi = np.asarray(pr.info.iterations).astype(int)
            qi = pt.solve_batch(
                pt.Problem(**{k: torch.from_numpy(v) for k, v in dp.items()}),
                settings, compact=True).info.iterations.numpy().astype(int)
            print(f"{name}: A perturbed (draw {draw}): JAX statuses "
                  f"{np.asarray(pr.info.status_val).tolist()} iterations "
                  f"{pi.tolist()}, port iterations {qi.tolist()}", flush=True)
            far |= set(np.flatnonzero(np.abs(ji - pi) > 3).tolist())
            far |= set(np.flatnonzero(np.abs(ti - qi) > 3).tolist())
        far = sorted(far)
        print(f"{name}: JAX statuses {np.asarray(jr.info.status_val).tolist()}"
              f" iterations {ji.tolist()}", flush=True)
        print(f"{name}: port statuses {tr.info.status_val.tolist()} "
              f"iterations {ti.tolist()}", flush=True)
        print(f"{name}: problems more than 3 iterations apart (between the "
              f"packages or under a perturbation): {far}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
