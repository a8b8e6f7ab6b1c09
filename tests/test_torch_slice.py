"""The PyTorch port's first slice, the batched dense solve with straggler
compaction, against the JAX package on the CPU.

* Pure float64 (``hybrid_warmup=False``, ``kkt_dtype=None``, kernel
  flags on), kkt_solver "ns" and "chol" (chol also without compaction),
  B=6, n=30, m=45: statuses and iteration counts identical per problem,
  x and y within 1e-8.
* The bench's mixed configuration (the case of
  tests/test_batch.py::test_batched_ns_mode_bench_path plus both kernel
  flags): every problem SOLVED in both packages and within the numpy
  float64 oracle's 1.1e-6, iteration counts within 2 of JAX's per problem
  (the largest difference observed is 2: the float32 warmup's matrix
  products sum in another order on the two CPU backends).
* The second slice, ``pallas_kkt=True`` under the configuration of
  tests/test_pallas_inloop.py (float32 KKT, mu_min 1e-7, two refinement
  sweeps): every Newton solve is the fused kernel (JAX: interpret mode,
  padded to n=128; the port: its plain version).  The two are not bit for
  bit equal, so, as in the JAX package's own test, statuses must be equal,
  iteration counts within 5 and the oracle within 1e-6; one step from a
  common state agrees to float32-factor accuracy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.parallel.batch import _solve_batch_compact, solve_batch
from qpdo_tpu.solver import core as jcore
from qpdo_tpu.solver.scaling import scale_problem as j_scale

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.ops import fused_kkt
from qpdo_tpu_torch.solver import core as tcore
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _family(B, n, m, seed):
    """The bench problem family (bench.py:344-352)."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


def _solve_both(d, settings, compact=True):
    jp = qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})
    if compact:
        jr = _solve_batch_compact(jp, settings, None, None, False, False)
    else:
        jr = solve_batch(jp, settings)
    tr = pt.solve_batch(pt.Problem(**{k: torch.from_numpy(v)
                                      for k, v in d.items()}),
                        convert.settings(settings), compact=compact)
    return jr, tr


def _oracle(d, x, y):
    """The numpy float64 KKT oracle of bench.py:482-490, per problem."""
    Ax = np.einsum("bmn,bn->bm", d["A"], x)
    rp = np.abs(Ax - np.clip(Ax + y, d["l"], d["u"])).max(axis=1)
    rd = np.abs(np.einsum("bij,bj->bi", d["Q"], x) + d["q"]
                + np.einsum("bmn,bm->bn", d["A"], y)).max(axis=1)
    return rp, rd


@pytest.mark.parametrize("solver,compact", [("ns", True), ("chol", True),
                                            ("chol", False)])
def test_pure_f64_slice_matches_jax(solver, compact):
    d = _family(6, 30, 45, seed=5)
    settings = qt.Settings(hybrid_warmup=False, kkt_dtype=None,
                           kkt_solver=solver, pallas_formation=True,
                           pallas_residuals=True)
    jr, tr = _solve_both(d, settings, compact)
    np.testing.assert_array_equal(tr.info.status_val.numpy(),
                                  np.asarray(jr.info.status_val))
    assert np.all(np.asarray(jr.info.status_val) == qt.SOLVED)
    np.testing.assert_array_equal(tr.info.iterations.numpy(),
                                  np.asarray(jr.info.iterations))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(tr.y.numpy(), np.asarray(jr.y), rtol=0,
                               atol=1e-8)


def test_bench_mixed_configuration_matches_jax():
    d = _family(12, 40, 60, seed=17)
    settings = qt.Settings(eps_abs=1e-6, max_iter=400, inner_max_iter=50,
                           eps_abs_in=0.1, rho=0.02, delta=0.1,
                           refine_steps=2, kkt_dtype="float32",
                           hybrid_warmup=True, mu_min=1e-7,
                           linesearch="bisect", linesearch_dtype="float32",
                           phase2_gemm_dtype="float32", warmup_eps=1e-4,
                           warmup_refine_steps=0, kkt_solver="ns",
                           kkt_ns_steps=5, kkt_inv_refresh=False,
                           pallas_formation=True, pallas_residuals=True)
    jr, tr = _solve_both(d, settings)
    for status in (np.asarray(jr.info.status_val), tr.info.status_val.numpy()):
        assert np.all(status == qt.SOLVED)
    for x, y in ((np.asarray(jr.x), np.asarray(jr.y)),
                 (tr.x.numpy(), tr.y.numpy())):
        rp, rd = _oracle(d, x, y)
        assert rp.max() <= 1.1e-6 and rd.max() <= 1.1e-6
    diff = np.abs(tr.info.iterations.numpy().astype(int)
                  - np.asarray(jr.info.iterations).astype(int))
    assert diff.max() <= 2, diff
    # phase 1 ran in float32 for every problem, phase 2 in float64
    assert np.all(tr.info.warmup_iterations.numpy() > 0)
    assert tr.x.dtype == torch.float64


PALLAS_KKT = dict(kkt_dtype="float32", mu_min=1e-7, refine_steps=2,
                  pallas_kkt=True, pallas_residuals=True)


def test_pallas_kkt_slice_matches_jax(monkeypatch):
    d = _family(3, 30, 45, seed=23)
    settings = qt.Settings(**PALLAS_KKT)
    calls = []
    solve = fused_kkt.fused_kkt_solve
    monkeypatch.setattr("qpdo_tpu_torch.ops.fused_kkt.fused_kkt_solve",
                        lambda *a: calls.append(1) or solve(*a))
    jr, tr = _solve_both(d, settings)
    np.testing.assert_array_equal(tr.info.status_val.numpy(),
                                  np.asarray(jr.info.status_val))
    assert np.all(tr.info.status_val.numpy() == qt.SOLVED)
    diff = np.abs(tr.info.iterations.numpy().astype(int)
                  - np.asarray(jr.info.iterations).astype(int))
    assert diff.max() <= 5, diff
    for x, y in ((np.asarray(jr.x), np.asarray(jr.y)),
                 (tr.x.numpy(), tr.y.numpy())):
        rp, rd = _oracle(d, x, y)
        assert rp.max() <= 1e-6 and rd.max() <= 1e-6
    # every Newton solve went through the fused solve: three calls a step
    assert len(calls) >= 3 * int(tr.info.iterations.max())
    assert tr.x.dtype == torch.float64


def test_pallas_kkt_one_step_matches_jax():
    """One step of both packages from the state 6 plain steps in."""
    d = _family(4, 24, 36, seed=29)
    base = qt.Settings(kkt_dtype="float32", mu_min=1e-7, refine_steps=2,
                       pallas_residuals=True)
    jp = qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})
    sp = jax.jit(jax.vmap(lambda p: j_scale(p, base.scaling)))(jp)
    s = jax.jit(jax.vmap(lambda a: jcore.init_state(a, base, None, None,
                                                    False, False)))(sp)
    step = jax.jit(jax.vmap(lambda a, b: jcore.step(a, base, b)))
    for _ in range(6):
        s = step(sp, s)
    settings = base.replace(pallas_kkt=True)
    js = jax.jit(jax.vmap(lambda a, b: jcore.step(a, settings, b)))(sp, s)
    ts = tcore.step(convert.scaled_problem(sp, "cpu"),
                    convert.settings(settings), convert.state(s, "cpu"))
    for name in pt.types.SolverState._fields:
        a, b = getattr(ts, name), getattr(js, name)
        if a is None:
            assert b is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            # the direction comes from a float32 factor refined twice
            # against float32 matvecs (largest difference measured: 1.2e-5
            # of max|x|)
            scale = max(np.abs(b).max(), 1e-300)
            assert np.abs(a - b).max() <= 1e-4 * scale, name
