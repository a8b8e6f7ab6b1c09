"""The PyTorch port's types, its conversion of the JAX package's data, and
one solver step from a converted state, on the CPU.

One ``core.step`` of both packages from the same state agrees to 1e-12
relative in float64 (kernel flags on: the JAX residual kernel in
interpret mode, the port's plain version).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.solver import core as jcore
from qpdo_tpu.solver.scaling import scale_problem as j_scale

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.solver import core as tcore
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]


def test_settings_fields_and_defaults_match_jax():
    jf = [(f.name, f.default) for f in dataclasses.fields(qt.Settings)]
    tf = [(f.name, f.default) for f in dataclasses.fields(pt.Settings)]
    assert len(tf) == 72
    assert tf == jf
    s = pt.Settings().replace(kkt_solver="ns", eps_abs=1e-8)
    assert (s.kkt_solver, s.eps_abs) == ("ns", 1e-8)


def test_convert_settings_keeps_every_field():
    js = qt.Settings(kkt_solver="ns", kkt_ns_steps=5, hybrid_warmup=True,
                     phase2_gemm_dtype="float32", pallas_residuals=True)
    ts = convert.settings(js)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def test_import_brings_in_no_jax():
    code = ("import sys, qpdo_tpu_torch, qpdo_tpu_torch.convert, "
            "qpdo_tpu_torch.kernels, qpdo_tpu_torch.parallel.batch; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'qpdo_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _jax_states(settings, B=5, n=24, m=36, seed=7, steps=6):
    """A batched JAX problem, its scaling and a state ``steps`` steps in."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    p = qt.Problem(Q=jnp.asarray(Q), q=jnp.asarray(rng.standard_normal((B, n))),
                   A=jnp.asarray(rng.standard_normal((B, m, n))),
                   l=jnp.asarray(-rng.random((B, m))),
                   u=jnp.asarray(rng.random((B, m))), c=jnp.zeros(B))
    sp = jax.vmap(lambda q: j_scale(q, settings.scaling))(p)
    s = jax.vmap(lambda a: jcore.init_state(a, settings, None, None,
                                            False, False))(sp)
    step = jax.jit(jax.vmap(lambda a, b: jcore.step(a, settings, b)))
    for _ in range(steps):
        s = step(sp, s)
    return p, sp, s, step


def test_convert_problem_and_state():
    settings = qt.Settings(kkt_solver="ns")
    p, sp, s, _ = _jax_states(settings, steps=1)
    tp = convert.problem(p, "cpu")
    assert tp.Q.shape == (5, 24, 24) and tp.A.shape == (5, 36, 24)
    assert tp.Q.dtype == torch.float64
    tsp = convert.scaled_problem(sp, "cpu")
    np.testing.assert_array_equal(tsp.scaling.Einv.numpy(),
                                  np.asarray(sp.scaling.Einv))
    ts = convert.state(s, "cpu")
    assert ts.kkt_cache.shape == (5, 24, 24)
    assert ts.iter.dtype == torch.int32 and ts.sigma.shape == (5,)
    for name in pt.types.SolverState._fields:
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(s, name)))


@pytest.mark.parametrize("solver", ["ns", "chol"])
def test_one_step_matches_jax(solver):
    # chol runs the plain formation here: the JAX Pallas formation rounds
    # to float32 in interpret mode (tests/test_torch_ops.py)
    settings = qt.Settings(kkt_solver=solver, pallas_residuals=True,
                           pallas_formation=(solver == "ns"))
    _, sp, s, step = _jax_states(settings)
    js = step(sp, s)
    ts = tcore.step(convert.scaled_problem(sp, "cpu"), convert.settings(settings),
                    convert.state(s, "cpu"))
    assert (solver == "ns") == (ts.kkt_cache is not None)
    for name in pt.types.SolverState._fields:
        a, b = getattr(ts, name), getattr(js, name)
        if a is None:
            assert b is None, name
            continue
        a, b = a.numpy(), np.asarray(b)
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            scale = max(np.abs(b).max(), 1e-300)
            assert np.abs(a - b).max() <= 1e-12 * scale, name
