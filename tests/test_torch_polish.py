"""The solution polish of the PyTorch port (``Settings.polish``: one
saddle solve on the identified active set, accepted per problem only
where the recomputed residuals verify it) against the JAX package on the
CPU, float64.

* ``saddle_solve`` (LU in float64 or float32, refined in float64) and
  ``saddle_polish_solve`` to 1e-10; a singular saddle system gives that
  problem the zero vector and leaves the others alone.
* ``polish_state``'s acceptance, problem by problem: a running problem
  latches SOLVED, a SOLVED one is replaced only by a strictly better
  point, an infeasible one is never touched; the state equals JAX's to
  1e-12.
* ``polish=True`` solves (pure float64, cold and warm-started): JAX's
  statuses and iteration counts, x within 1e-8; the bench configuration
  with a float32 warmup and polish (tests/test_pallas_inloop.py:63-95)
  within 2 iterations per problem and the oracle at 1.1e-6.
"""

import numpy as np
import pytest
import torch

import jax

import qpdo_tpu as qt
from qpdo_tpu.ops import linalg as jlinalg
from qpdo_tpu.solver import core as jcore

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.ops import linalg as tlinalg
from qpdo_tpu_torch.solver import core as tcore

from torch_parity import (assert_same, assert_states_close, family,
                          jax_states, oracle, rel_err, scaled_pair,
                          solve_both)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _saddle_inputs(B=3, n=16, m=24, seed=81):
    d = family(B, n, m, seed)
    rng = np.random.default_rng(seed + 1)
    act = (rng.random((B, m)) < 0.4).astype(np.float64)
    return (d["Q"], d["A"], act, rng.standard_normal((B, n)),
            rng.standard_normal((B, m)), d)


@pytest.mark.parametrize("lu_dtype", [None, "float32"])
def test_saddle_solve_matches_jax(lu_dtype):
    Q, A, act, r1, r2, _ = _saddle_inputs()
    jv1, jv2 = jax.jit(jax.vmap(lambda *a: jlinalg.saddle_solve(
        *a, 1e-8, 2, lu_dtype)))(Q, A, act, r1, r2)
    v1, v2 = tlinalg.saddle_solve(_t(Q), _t(A), _t(act), _t(r1), _t(r2),
                                  1e-8, 2, lu_dtype)
    assert v1.dtype == torch.float64
    assert rel_err(v1, jv1) <= 1e-10 and rel_err(v2, jv2) <= 1e-10


def test_saddle_polish_solve_matches_jax_and_a_singular_system_stays_put():
    Q, A, act, _, bnd, d = _saddle_inputs()
    # problem 1: Q = 0 and no active row, so the saddle matrix is singular
    Q[1] = 0.0
    act[1] = 0.0
    jx, jy = jax.jit(jax.vmap(lambda a, b, c, e, f: jlinalg.saddle_polish_solve(
        a, b, c, e, f, 1e-8)))(Q, A, d["q"], act, bnd)
    xp, yp = tlinalg.saddle_polish_solve(_t(Q), _t(A), _t(d["q"]), _t(act),
                                         _t(bnd), 1e-8)
    assert torch.all(xp[1] == 0) and torch.all(yp[1] == 0)
    assert np.all(np.asarray(jx)[1] == 0)
    keep = [0, 2]
    assert rel_err(xp[keep], np.asarray(jx)[keep]) <= 1e-10
    assert rel_err(yp[keep], np.asarray(jy)[keep]) <= 1e-10
    assert torch.all(yp[act == 0] == 0)


def test_polish_state_acceptance_matches_jax():
    settings = qt.Settings(polish=True)
    jsp, tsp = scaled_pair(family(4, 20, 30, seed=82), settings)
    js = jax_states(jsp, settings, steps=40)
    # 0 running, 1 SOLVED with residuals no polish can beat, 2 primal
    # infeasible, 3 SOLVED with large residuals
    status = np.array([qt.UNSOLVED, qt.SOLVED, qt.PRIMAL_INFEASIBLE,
                       qt.SOLVED], np.int32)
    rp = np.asarray(js.res_prim_norm).copy()
    rp[1], rp[3] = 0.0, 1e-3
    js = js._replace(status=jax.numpy.asarray(status),
                     res_prim_norm=jax.numpy.asarray(rp))
    jout = jax.jit(jax.vmap(lambda sp, s: jcore.polish_state(
        sp, settings, s)))(jsp, js)
    tin = convert.state(js, "cpu")
    tout = tcore.polish_state(tsp, convert.settings(settings), tin)
    assert tout.status.tolist() == [qt.SOLVED, qt.SOLVED,
                                    qt.PRIMAL_INFEASIBLE, qt.SOLVED]
    moved = (tout.x != tin.x).any(dim=1).tolist()
    assert moved == [True, False, False, True]
    assert_states_close(tout, jout, 1e-12)
    # off: nothing happens
    assert tcore.polish_state(tsp, pt.Settings(), tin) is tin


def test_polish_solves_match_jax():
    d = family(5, 30, 45, seed=83)
    settings = qt.Settings(polish=True, pallas_residuals=True)
    jr, tr = solve_both(d, settings)
    assert np.all(tr.info.status_val.numpy() == qt.SOLVED)
    assert_same(tr, jr)


def test_warm_started_polish_takes_no_iteration():
    d = family(4, 30, 45, seed=84)
    settings = qt.Settings(polish=True)
    sol = pt.solve_batch(pt.Problem(**{k: _t(v) for k, v in d.items()}),
                         convert.settings(settings))
    jr, tr = solve_both(d, settings, x0=sol.x.numpy(), y0=sol.y.numpy())
    assert_same(tr, jr)
    assert np.all(tr.info.iterations.numpy() == 0)
    assert np.all(tr.info.status_val.numpy() == qt.SOLVED)


def test_bench_configuration_with_polish():
    d = family(6, 40, 60, seed=7)
    settings = qt.Settings(eps_abs=1e-6, max_iter=300, inner_max_iter=50,
                           eps_abs_in=0.1, rho=0.02, delta=0.1,
                           refine_steps=2, kkt_dtype="float32",
                           hybrid_warmup=True, mu_min=1e-7,
                           cert_dtype="float32", linesearch="bisect",
                           linesearch_dtype="float32",
                           phase2_gemm_dtype="float32", hard_rows=8,
                           polish=True, warmup_eps=1e-3,
                           pallas_formation=True, pallas_residuals=True)
    jr, tr = solve_both(d, settings, compact=True)
    for status in (np.asarray(jr.info.status_val), tr.info.status_val.numpy()):
        assert np.all(status == qt.SOLVED)
    for x, y in ((np.asarray(jr.x), np.asarray(jr.y)),
                 (tr.x.numpy(), tr.y.numpy())):
        rp, rd = oracle(d, x, y)
        assert rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6
    diff = np.abs(tr.info.iterations.numpy().astype(int)
                  - np.asarray(jr.info.iterations).astype(int))
    assert diff.max() <= 2, diff
