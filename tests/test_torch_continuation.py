"""The PyTorch port's continuation ladders (``qpdo_tpu_torch.continuation``)
against the JAX package's (``qpdo_tpu.continuation``) on the CPU,
float64.

* ``grid1d_prolong`` and ``grid2d_interp`` (with and without the
  Dirichlet pad) equal JAX's to the last bit (the same numpy code).
* A two-level LISWET ladder (n = 60, 120, the family of
  tests/test_continuation.py, through ``solve_sparse``: the banded scan
  route) and a dense identity ladder (a ramp of q over three levels,
  through ``solve``): every level in JAX's status and iterations, x and y
  within 1e-8 relative to max(1, max|entry|) (the multipliers of the
  second-difference rows grow like n^2); the ladder's run time on the
  finest result.
* A resume from a snapshot after a stop between levels: the recorded
  level is skipped (None with ``return_all``), the snapshot keeps the
  keys ``level``, ``x``, ``y``, and the rest of the ladder is the
  uninterrupted ladder's, bit for bit.  The reference's fault is
  mirrored: a level that ended unsolved is banked all the same and
  skipped on resume.
* ``refine_final``: a no-op where the finest level passes the oracle;
  where it does not (a finest level cut at its iteration cap), one warm
  re-solve of that level from its own point, bit for bit.
"""

import numpy as np
import pytest
import torch

import qpdo_tpu as qt

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert

from test_continuation import liswet, restrict_liswet
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LADDER = qt.Settings(eps_abs=1e-6, max_iter=20000, inner_max_iter=100,
                     eps_abs_in=0.1, rho=0.2, delta=1e-4, theta=0.9)
LEVELS = (60, 120)


def _ladder():
    fine = liswet(LEVELS[-1], np.random.default_rng(3))
    return [restrict_liswet(fine, n) for n in LEVELS[:-1]] + [fine]


def _prolong(x, y, i):
    return qt.grid1d_prolong(LEVELS[i], LEVELS[i + 1], order=2)(x, y)


def _same(t_res, j_res):
    assert int(t_res.info.status_val[0]) == int(j_res.info.status_val)
    assert int(t_res.info.iterations[0]) == int(j_res.info.iterations)
    for a, b in ((t_res.x, j_res.x), (t_res.y, j_res.y)):
        b = np.asarray(b)
        np.testing.assert_allclose(a[0].numpy(), b, rtol=0,
                                   atol=1e-8 * max(1.0, np.abs(b).max()))


def test_prolongations_equal_jax():
    rng = np.random.default_rng(0)
    x, y = rng.standard_normal(50), rng.standard_normal(48)
    for a, b in zip(pt.grid1d_prolong(50, 97, order=2)(x, y),
                    qt.grid1d_prolong(50, 97, order=2)(x, y)):
        assert np.array_equal(a, b)
    v = rng.standard_normal(36)
    for boundary in (None, 0.0):
        assert np.array_equal(pt.grid2d_interp(6, 13, v, boundary),
                              qt.grid2d_interp(6, 13, v, boundary))


@pytest.fixture(scope="module")
def ladders():
    """The LISWET ladder through both packages (return_all)."""
    problems = _ladder()
    jr = qt.solve_continuation(problems, LADDER, prolong=_prolong,
                               return_all=True)
    tr = pt.solve_continuation(problems, convert.settings(LADDER),
                               prolong=_prolong, return_all=True,
                               device="cpu")
    return problems, jr, tr


def test_sparse_ladder_matches_jax(ladders):
    _, jr, tr = ladders
    for t, j in zip(tr, jr):
        _same(t, j)
    assert tr[-1].info.status == ["solved"]
    assert float(tr[-1].info.run_time[0]) > 0.0


def test_dense_identity_ladder_matches_jax():
    rng = np.random.default_rng(5)
    n, m = 40, 30
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.1 * np.eye(n)
    A = rng.standard_normal((m, n))
    q1 = rng.standard_normal(n)
    ramp = [(Q, a * q1, A, -np.ones(m), np.ones(m)) for a in (0.25, 0.5, 1.0)]
    jr = qt.solve_continuation([qt.make_problem(*p) for p in ramp],
                               qt.Settings(), return_all=True)
    tr = pt.solve_continuation([pt.make_problem(*p, device="cpu")
                                for p in ramp], pt.Settings(),
                               return_all=True)
    for t, j in zip(tr, jr):
        _same(t, j)


class _Stop(Exception):
    pass


def _stop_after(level):
    def hook(i, _res):
        if i == level:
            raise _Stop
    return hook


def test_resume_from_a_snapshot(ladders, tmp_path):
    problems, _, plain = ladders
    settings = convert.settings(LADDER)
    path = str(tmp_path / "ladder.npz")
    with pytest.raises(_Stop):
        pt.solve_continuation(problems, settings, prolong=_prolong,
                              progress=_stop_after(0), resume_path=path,
                              device="cpu")
    snap = np.load(path)
    assert sorted(snap.files) == ["level", "x", "y"]
    assert int(snap["level"]) == 0 and snap["x"].shape == (LEVELS[0],)
    seen = []
    out = pt.solve_continuation(problems, settings, prolong=_prolong,
                                return_all=True, resume_path=path,
                                progress=lambda i, r: seen.append(i),
                                device="cpu")
    assert seen == [1] and out[0] is None
    # the snapshot holds level 0's solution exactly, so the resumed finest
    # level is the uninterrupted ladder's (which matches JAX's)
    assert torch.equal(out[1].x, plain[1].x)
    assert int(out[1].info.iterations[0]) == int(plain[1].info.iterations[0])
    # the finest level recorded: a warm re-solve of it from itself
    again = pt.solve_continuation(problems, settings, prolong=_prolong,
                                  return_all=True, resume_path=path,
                                  device="cpu")
    assert again[0] is None and again[1].info.status == ["solved"]


def test_resume_banks_an_unsolved_level(tmp_path):
    """The reference's fault (continuation.py:186), mirrored: level 0
    stops at its iteration cap, is written to the snapshot as done, and a
    resumed ladder skips it and prolongs its unsolved point."""
    problems = _ladder()
    capped = convert.settings(LADDER.replace(max_iter=5))
    path = str(tmp_path / "ladder.npz")
    status = []
    with pytest.raises(_Stop):
        pt.solve_continuation(problems, capped, prolong=_prolong,
                              resume_path=path,
                              progress=lambda i, r: (status.append(
                                  r.info.status_val[0].item()),
                                  _stop_after(0)(i, r)),
                              device="cpu")
    assert status == [pt.MAX_ITER_REACHED]
    assert int(np.load(path)["level"]) == 0
    seen = []
    out = pt.solve_continuation(problems, capped, prolong=_prolong,
                                return_all=True, resume_path=path,
                                progress=lambda i, r: seen.append(i),
                                device="cpu")
    assert seen == [1] and out[0] is None


def test_refine_final(ladders):
    problems, _, plain = ladders
    refined = pt.solve_continuation(problems, convert.settings(LADDER),
                                    prolong=_prolong, refine_final=True,
                                    device="cpu")
    assert torch.equal(refined.x, plain[-1].x)
    assert int(refined.info.iterations[0]) == int(
        plain[-1].info.iterations[0])
    # a finest level cut at its cap fails the oracle: one warm re-solve of
    # that level from its own point, as in continuation.py:202-218
    capped = convert.settings(LADDER.replace(max_iter=40))
    first = pt.solve_continuation(problems, capped, prolong=_prolong,
                                  device="cpu")
    assert first.info.status == ["maximum iterations reached"]
    tr = pt.solve_continuation(problems, capped, prolong=_prolong,
                               refine_final=True, device="cpu")
    again = pt.solve_sparse(*problems[-1], settings=capped, x0=first.x,
                            y0=first.y, device="cpu")
    assert torch.equal(tr.x, again.x) and not torch.equal(tr.x, first.x)
    assert int(tr.info.iterations[0]) == int(again.info.iterations[0])


def test_empty_ladder_raises():
    with pytest.raises(ValueError):
        pt.solve_continuation([], pt.Settings())
