"""The PyTorch port's utilities (``utils/checkpoint.py``,
``utils/debug.py``, ``utils/profiling.py``) and the import rule of its
command line, on the CPU.

* A checkpoint round trip gives every tensor back bit for bit, None
  fields and the incremental KKT pair included, on ``like``'s device; a
  checkpoint of another structure is refused before any leaf is taken.
* ``debug_nans`` makes the loop (``core.run_loop`` and the full-batch
  chunks of ``solve_batch(compact=True)``) raise FloatingPointError at a
  NaN in the state and costs nothing when off.
* ``newton_system_residual`` is ~0 on a real Newton direction of the
  dense and the sparse operator, and ``linesearch_residual`` ~0 at the
  linesearch's root and equal to the JAX package's function.
* ``PhaseTimer`` accumulates, and ``trace`` writes a profiler file.
* ``python -m qpdo_tpu_torch --help`` in a new process imports no JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax.numpy as jnp

from qpdo_tpu.utils import debug as jdebug

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.ops.fused_residuals import reference_residuals
from qpdo_tpu_torch.ops.linesearch import pwa_root
from qpdo_tpu_torch.solver import core
from qpdo_tpu_torch.solver.scaling import scale_problem
from qpdo_tpu_torch.solver.sparse import setup_sparse
from qpdo_tpu_torch.utils import checkpoint, debug, profiling

from torch_parity import family, torch_problem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dense():
    """A small batch of the bench family, scaled, with a state 5 steps in
    (the incremental KKT pair carried)."""
    settings = pt.Settings(kkt_update_rows=4)
    sp = scale_problem(torch_problem(family(3, 12, 9, seed=2)), 10)
    s = core.init_state(sp, settings)
    for _ in range(5):
        s = core.step(sp, settings, s)
    assert isinstance(s.kkt_cache, tuple)
    return sp, settings, s


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def test_checkpoint_round_trip(dense, tmp_path):
    sp, settings, s = dense
    res = pt.solve(pt.make_problem(*[a[0] for a in family(1, 8, 6, 1)
                                     .values()][:5], device="cpu"))
    for tree, name in ((s, "state"), (res, "result"), (sp, "scaled")):
        path = str(tmp_path / f"{name}.npz")
        checkpoint.save_pytree(path, tree)
        back = checkpoint.load_pytree(path, tree)
        assert type(back) is type(tree)
        a_leaves, b_leaves = [], []
        checkpoint._flatten(back, a_leaves)
        checkpoint._flatten(tree, b_leaves)
        assert len(a_leaves) == len(b_leaves) > 0
        for a, b in zip(a_leaves, b_leaves):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(_bits(a), _bits(b))
    path = str(tmp_path / "r.npz")
    checkpoint.save_result(path, res)
    assert torch.equal(_bits(checkpoint.load_result(path, res).x),
                       _bits(res.x))


def test_checkpoint_refuses_another_structure(dense, tmp_path):
    sp, settings, s = dense
    path = str(tmp_path / "state.npz")
    checkpoint.save_pytree(path, s)
    with pytest.raises(ValueError, match="treedef mismatch"):
        checkpoint.load_pytree(path, s._replace(kkt_cache=None))
    with pytest.raises(ValueError, match="treedef mismatch"):
        checkpoint.load_pytree(path, sp)


def test_debug_nans_raises_in_the_loop(dense):
    sp, settings, s = dense
    bad = s._replace(x=s.x.clone())
    bad.x[1, 0] = float("nan")
    core.run_loop(sp, settings, bad, 8)          # off: no check
    with debug.debug_nans():
        with pytest.raises(FloatingPointError, match="x"):
            core.run_loop(sp, settings, bad, 8)
        core.run_loop(sp, settings, s, 8)        # a finite state passes
    assert not debug._check_nans


def test_debug_nans_checks_the_full_batch_chunks_of_compact(monkeypatch):
    # the full-batch phase of solve_batch(compact=True) checks after each
    # chunk: the NaN is caught before the compaction phase (core.run_loop,
    # made to fail here) is reached
    problems = torch_problem(family(3, 12, 9, seed=2))
    q = problems.q.clone()
    q[1, 0] = float("nan")
    bad = problems._replace(q=q)
    settings = pt.Settings(max_iter=64)

    def compaction(*args, **kwargs):
        raise AssertionError("the compaction phase was reached")

    monkeypatch.setattr(core, "run_loop", compaction)
    with debug.debug_nans():
        with pytest.raises(FloatingPointError):
            pt.solve_batch(bad, settings, compact=True)


def _newton_direction(op, settings, s):
    """The direction of core.step from state ``s`` and its residual
    block."""
    sig = s.sigma
    (_, rpi, w, active, rdi, *_) = reference_residuals(
        s.Ax, s.y, s.mu, s.ybar, op.l, op.u, op.E, op.Einv, s.Qx, op.q,
        s.Aty, s.x, s.xbar, op.Dinv, sig, op.cinv)
    ytilde = (rpi / s.mu) * (2.0 - active)
    rhs = -(rdi + op.Atmv(ytilde))
    dx = op.newton_solve(active, s.mu, sig, rhs, settings)
    dy = ytilde + active * (op.Amv(dx) / s.mu)
    return dx, dy, active, rpi, rdi


def test_newton_system_residual_vanishes_on_a_real_step(dense):
    sp, settings, s = dense
    op = core.as_operator(sp)
    dx, dy, active, rpi, rdi = _newton_direction(op, pt.Settings(), s)
    a1, a2 = debug.newton_system_residual(sp, s, pt.Settings(), dx, dy,
                                          active, rpi, rdi)
    assert a1.shape == (3,) and float(a1.max()) < 1e-10
    assert float(a2.max()) < 1e-10
    rng = np.random.default_rng(0)
    n, m = 30, 20
    B = sps.random(n, n, density=0.2, random_state=1)
    sop = setup_sparse((B.T @ B + sps.eye(n)).tocsr(), rng.standard_normal(n),
                       sps.random(m, n, density=0.3, random_state=2),
                       -np.ones(m), np.ones(m), device="cpu")
    stg = pt.Settings(cg_tol=1e-14)
    st = core.init_state(sop, stg)
    for _ in range(3):
        st = core.step(sop, stg, st)
    dx, dy, active, rpi, rdi = _newton_direction(sop, stg, st)
    a1, a2 = debug.newton_system_residual(sop, st, stg, dx, dy, active,
                                          rpi, rdi)
    assert float(a1.max()) < 1e-9 and float(a2.max()) < 1e-9


def test_linesearch_residual_vanishes_at_the_root_and_matches_jax():
    rng = np.random.default_rng(4)
    B, k = 4, 30
    eta = rng.random(B) + 0.5
    delta = rng.standard_normal((B, k))
    alpha = rng.standard_normal((B, k))
    # psi'(0) < 0: the root lies at a positive step
    beta = -np.sum(np.abs(delta * alpha), axis=1) - rng.random(B) - 0.1
    t = lambda v: torch.from_numpy(v)
    tau = pwa_root(t(eta), t(beta), t(delta), t(alpha))
    got = debug.linesearch_residual(tau, t(eta), t(beta), t(delta), t(alpha))
    assert float(got.abs().max()) < 1e-12
    ref = [float(jdebug.linesearch_residual(
        jnp.asarray(float(tau[b])), eta[b], beta[b], jnp.asarray(delta[b]),
        jnp.asarray(alpha[b]))) for b in range(B)]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


def test_phase_timer_and_trace(tmp_path):
    timer = profiling.PhaseTimer()
    out = []
    for _ in range(2):
        with timer.phase("sleep", out):
            time.sleep(0.01)
            out.append(torch.ones(3))
    with timer.phase("fast"):
        pass
    assert timer.counts == {"sleep": 2, "fast": 1}
    assert timer.times["sleep"] >= 0.02
    assert list(timer.summary()) == ["sleep", "fast"]
    profiling.sync((torch.ones(2), (torch.zeros(1),)))   # CPU: nothing to wait
    with profiling.trace(str(tmp_path)):
        torch.ones(64) @ torch.ones(64)
    assert [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]


def test_the_command_line_imports_no_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['qpdo_tpu_torch', '--help']\n"
            "try:\n"
            "    runpy.run_module('qpdo_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert not any(m == 'qpdo_tpu' or m.startswith('qpdo_tpu.')\n"
            "               for m in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "usage: python -m qpdo_tpu_torch" in proc.stdout
