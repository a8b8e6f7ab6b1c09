"""Options of the PyTorch port's step against the JAX package on the CPU,
float64: ``fused_newton_rhs`` (the Newton solve forms its own
right-hand side), ``accel_gamma`` (inertial prox centers) and
``linesearch="bisect_chunk"``.

* One step from a common state (eight steps in) agrees to 1e-12 relative
  in every field.  The fused right-hand side rides the formation GEMM as
  an extra column in the JAX package and is computed apart here; the
  two agree to rounding.
* Full solves give JAX's statuses and iteration counts, x and y within
  1e-8; with ``pallas_kkt`` (a float32 fused solve in both packages, not
  bit for bit) statuses equal, iterations within 5 and the oracle at 1e-6,
  as in tests/test_torch_slice.py.  One step with a float32 formation is
  held to 1e-4, the bound of that file's one-step test.
* ``pwa_root_bisect_chunk`` gives JAX's root to 1e-12 on random hinge
  sets, with clustered breakpoints and with a root beyond 4^20.
"""

import numpy as np
import pytest
import torch

import jax

import qpdo_tpu as qt
from qpdo_tpu.ops import linesearch as jls
from qpdo_tpu.solver import core as jcore

from qpdo_tpu_torch import convert
from qpdo_tpu_torch.ops import linesearch as tls
from qpdo_tpu_torch.solver import core as tcore

from torch_parity import (assert_same, assert_states_close, family,
                          jax_states, oracle, rel_err, scaled_pair,
                          solve_both)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


_BASE = qt.Settings(pallas_residuals=True)


@pytest.fixture(scope="module")
def common_state():
    """A batch eight plain steps in (both packages' scaled problems)."""
    jsp, tsp = scaled_pair(family(4, 20, 30, seed=91), _BASE)
    return jsp, tsp, jax_states(jsp, _BASE, steps=8)


@pytest.mark.parametrize("extra", [
    dict(fused_newton_rhs=True),
    dict(fused_newton_rhs=True, pallas_formation=True,
         kkt_dtype="float32", mu_min=1e-7),
    # CG run well past n, so that rounding does not move its iterate
    dict(fused_newton_rhs=True, kkt_solver="cg", kkt_cg_fixed=60),
    dict(accel_gamma=0.5),
    dict(linesearch="bisect_chunk"),
])
def test_one_step_matches_jax(common_state, extra):
    settings = _BASE.replace(**extra)
    jsp, tsp, js = common_state
    ts = tcore.step(tsp, convert.settings(settings), convert.state(js, "cpu"))
    js = jax.jit(jax.vmap(lambda sp, s: jcore.step(sp, settings, s)))(jsp, js)
    # a float32 factor refined once against float32 matvecs: to that
    # accuracy (the bound of tests/test_torch_slice.py's one-step test)
    assert_states_close(ts, js, 1e-4 if settings.kkt_dtype else 1e-12)


@pytest.mark.parametrize("extra", [dict(fused_newton_rhs=True),
                                   dict(accel_gamma=0.5),
                                   dict(linesearch="bisect_chunk")])
def test_solve_matches_jax(extra):
    d = family(4, 20, 30, seed=92)
    jr, tr = solve_both(d, qt.Settings(pallas_residuals=True, **extra),
                        compact=True)
    assert np.all(tr.info.status_val.numpy() == qt.SOLVED)
    assert_same(tr, jr)


def test_fused_rhs_with_the_fused_kkt_solve():
    d = family(2, 20, 30, seed=93)
    settings = qt.Settings(kkt_dtype="float32", mu_min=1e-7, refine_steps=2,
                           pallas_kkt=True, pallas_residuals=True,
                           fused_newton_rhs=True)
    jr, tr = solve_both(d, settings)
    np.testing.assert_array_equal(tr.info.status_val.numpy(),
                                  np.asarray(jr.info.status_val))
    assert np.all(tr.info.status_val.numpy() == qt.SOLVED)
    diff = np.abs(tr.info.iterations.numpy().astype(int)
                  - np.asarray(jr.info.iterations).astype(int))
    assert diff.max() <= 5, diff
    rp, rd = oracle(d, tr.x.numpy(), tr.y.numpy())
    assert rp.max() <= 1e-6 and rd.max() <= 1e-6


def test_bisect_chunk_root_matches_jax():
    rng = np.random.default_rng(94)
    B, m2 = 6, 40
    eta = rng.random(B) + 0.1
    beta = -rng.random(B) * 10.0
    delta = rng.standard_normal((B, m2))
    alpha = rng.standard_normal((B, m2))
    delta[1] = 0.0                          # no hinge: an affine phi
    alpha[2] = 1e-3 * rng.random(m2)        # clustered breakpoints
    eta[3], beta[3] = 1e-9, -1e4            # a root beyond 4^20
    delta[3] = 0.0
    beta[4] = 1.0                           # phi(0) > 0: root below 0
    jt = jax.jit(jax.vmap(jls.pwa_root_bisect_chunk))(eta, beta, delta, alpha)
    tt = tls.pwa_root_bisect_chunk(*[torch.from_numpy(a) for a in
                                     (eta, beta, delta, alpha)])
    assert np.all(np.isfinite(tt.numpy()))
    assert rel_err(tt, jt) <= 1e-12
    assert float(tt[3]) > 4.0 ** 20
