"""The host-driven solve of the PyTorch port (``solver/driver.py``:
``Settings.verbose`` and ``Settings.max_time``) and its printing
(``utils/printing.py``) against the JAX package on the CPU, float64.

* Every printed line equals JAX's, except the header's device word.
* A verbose solve returns what the silent one does (status, iterations,
  x within 1e-12), and its table has JAX's rows: the iteration column and
  the subproblem separators.
* ``max_time=1e-4`` at ``eps_abs=1e-14`` ends in MAX_TIME_REACHED after
  the first chunk; ``max_time=120`` ends SOLVED with the silent solve's
  iteration count.  ``QPDO`` takes the same route; the hybrid warmup is
  driven in chunks too, and agrees with JAX's driver within 2 iterations.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

import qpdo_tpu as qt
from qpdo_tpu.utils import printing as jprinting

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import constants as tc
from qpdo_tpu_torch.solver import driver
from qpdo_tpu_torch.utils import printing as tprinting

from utils import random_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_QP = random_qp(30, 45, seed=3)


def _lines(mod, name, *args, **kw):
    out = []
    getattr(mod, name)(*args, out=out.append, **kw)
    return out


def test_every_printed_line_matches_jax():
    jh = _lines(jprinting, "print_header")
    th = _lines(tprinting, "print_header", "GPU")
    assert [l.replace("TPU", "GPU") for l in jh] == th
    assert _lines(tprinting, "print_header", "CPU")[1] == jh[1].replace(
        "TPU", "CPU")
    assert all(len(l) == len(j) for l, j in zip(th, jh))
    for args in ((0, 0.0, 0.0, 2.99, 0.0, 2.99, 0.0),
                 (123456, -3.14159e5, 1.2e-7, 3.4e+2, 9.9e-9, 1.0, 0.5)):
        assert (_lines(tprinting, "print_iteration", *args)
                == _lines(jprinting, "print_iteration", *args))
    for it, capped in ((15, False), (65, True)):
        assert (_lines(tprinting, "print_subproblem_separator", it, capped)
                == _lines(jprinting, "print_subproblem_separator", it,
                          capped))
    for status in (qt.SOLVED, qt.PRIMAL_INFEASIBLE, qt.DUAL_INFEASIBLE,
                   qt.MAX_ITER_REACHED, tc.MAX_TIME_REACHED,
                   tc.PRIMAL_DUAL_INFEASIBLE, qt.NON_CVX, 12345):
        for run_time in (None, 0.25, 3.5):
            args = (status, 1.03e-8, 4.4e-11, 1e-6, -3.2926)
            assert (_lines(tprinting, "print_final_message", *args,
                           run_time=run_time)
                    == _lines(jprinting, "print_final_message", *args,
                              run_time=run_time))


def _solve(pkg, settings, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if pkg is qt:
            res = qt.solve(qt.make_problem(*_QP), settings, **kw)
        else:
            res = pt.solve(pt.make_problem(*_QP, device="cpu"), settings,
                           **kw)
    return res, buf.getvalue().splitlines()


def test_verbose_returns_the_silent_result():
    silent, printed = _solve(pt, pt.Settings())
    assert printed == []
    loud, table = _solve(pt, pt.Settings(verbose=True))
    assert int(loud.info.status_val) == int(silent.info.status_val) == qt.SOLVED
    assert int(loud.info.iterations) == int(silent.info.iterations)
    assert (loud.x - silent.x).abs().max() <= 1e-12
    assert "QPDO on CPU" in table[1]
    assert table[-7] == ("| QPDO finished successfully."
                         "                                              |")


def _rows(table):
    """(iteration column, separator lines) of a printed table."""
    body = [l for l in table if l[:6].strip().isdigit()]
    iters = [int(l[:6]) for l in body if "|-" not in l]
    return iters, [l for l in body if "|-" in l]


@pytest.mark.parametrize("interval", [1, 7])
def test_verbose_table_matches_jax(interval):
    jr, jtable = _solve(qt, qt.Settings(verbose=True,
                                        print_interval=interval))
    tr, ttable = _solve(pt, pt.Settings(verbose=True,
                                        print_interval=interval))
    assert int(tr.info.iterations) == int(jr.info.iterations)
    titers, tseps = _rows(ttable)
    jiters, jseps = _rows(jtable)
    assert titers == jiters and tseps == jseps
    assert titers[1] == interval and (interval > 1 or len(tseps) >= 3)
    # the closing box: status, tolerances and objective lines
    assert ttable[-7:-3] == jtable[-7:-3]


def test_max_time_stops_the_solve():
    settings = dict(max_time=1e-4, eps_abs=1e-14)
    jr, _ = _solve(qt, qt.Settings(**settings))
    tr, _ = _solve(pt, pt.Settings(**settings))
    assert int(jr.info.status_val) == int(tr.info.status_val)
    assert int(tr.info.status_val) == tc.MAX_TIME_REACHED
    assert int(tr.info.iterations) == driver._TIME_CHUNK
    assert tr.info.status == ["max time exceeded"]


def test_generous_max_time_solves_as_the_silent_loop():
    silent, _ = _solve(pt, pt.Settings())
    timed, _ = _solve(pt, pt.Settings(max_time=120.0))
    assert int(timed.info.status_val) == qt.SOLVED
    assert int(timed.info.iterations) == int(silent.info.iterations)
    assert (timed.x - silent.x).abs().max() <= 1e-12


def test_qpdo_verbose_prints_and_solves():
    Q, q, A, l, u = _QP
    buf = io.StringIO()
    solver = pt.QPDO()
    solver.setup(Q, q, A, l, u, pt.Settings(verbose=True, print_interval=10),
                 device="cpu")
    with contextlib.redirect_stdout(buf):
        res = solver.solve()
    silent = pt.QPDO()
    silent.setup(Q, q, A, l, u, device="cpu")
    ref = silent.solve()
    assert int(res.info.status_val) == qt.SOLVED
    assert int(res.info.iterations) == int(ref.info.iterations)
    assert "QPDO on CPU" in buf.getvalue()
    assert float(res.info.solve_time) > 0


def test_hybrid_warmup_through_the_driver():
    settings = dict(hybrid_warmup=True, warmup_eps=1e-3, kkt_dtype="float32",
                    mu_min=1e-7, phase2_gemm_dtype="float32",
                    anchor_every=10, max_time=120.0)
    jr, _ = _solve(qt, qt.Settings(**settings))
    tr, _ = _solve(pt, pt.Settings(**settings))
    assert int(tr.info.status_val) == int(jr.info.status_val) == qt.SOLVED
    assert 0 < int(tr.info.warmup_iterations) < int(tr.info.iterations)
    assert abs(int(tr.info.iterations) - int(jr.info.iterations)) <= 2
    assert abs(int(tr.info.warmup_iterations)
               - int(jr.info.warmup_iterations)) <= 2


def test_the_driver_takes_one_problem():
    Q, q, A, l, u = _QP
    p = pt.make_problem(Q, q, A, l, u, device="cpu")
    two = pt.Problem(*[torch.cat([a, a]) for a in p])
    with pytest.raises(ValueError, match="batch of one"):
        pt.solve(two, pt.Settings(max_time=10.0))
