"""The PyTorch port's validation against the JAX package's: the same
inputs raise the same ``ValueError`` texts and warn the same
``UnsafeSettingsWarning`` texts.
"""

import warnings

import numpy as np
import pytest

import qpdo_tpu as qt
from qpdo_tpu import validate as jvalidate

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import validate as tvalidate
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _qp(n=30, m=45, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    Q = M @ M.T / n + 0.1 * np.eye(n)
    return (Q, rng.standard_normal(n), rng.standard_normal((m, n)),
            -rng.random(m), rng.random(m))


BAD_SETTINGS = [
    dict(max_iter=0), dict(inner_max_iter=0), dict(eps_abs=0.0),
    dict(eps_abs_in=-1.0), dict(eps_prim_inf=-1e-3), dict(eps_dual_inf=-1.0),
    dict(rho=1.0), dict(theta=0.0), dict(delta=1.0), dict(mu_min=0.0),
    dict(sigma_init=0.0), dict(sigma_upd=1.5), dict(sigma_min=1.0),
    dict(scaling=-1), dict(refine_steps=-1), dict(kkt_solver="lu"),
    dict(kkt_ns_steps=0), dict(kkt_solver="ns", kkt_update_rows=4),
    dict(linesearch="golden"), dict(warmup_stall_exit=1.0),
    dict(full_step_gamma=0.0), dict(accel_gamma=1.0), dict(polish_delta=0.0),
    dict(kkt_escalate_rtol=-1.0), dict(cg_tol=0.0), dict(precond="ilu"),
]


# five groups, so that this file stays a small unit of the parallel run
@pytest.mark.parametrize("group", range(5))
def test_validate_settings_raises_like_jax(group):
    for kw in BAD_SETTINGS[group::5]:
        with pytest.raises(ValueError) as jerr:
            jvalidate.validate_settings(qt.Settings(**kw))
        with pytest.raises(ValueError) as terr:
            tvalidate.validate_settings(pt.Settings(**kw))
        assert str(terr.value) == str(jerr.value), kw


UNSAFE = [
    (dict(kkt_dtype="float32", mu_min=1e-8, kkt_pcg_refine=0), 1),
    (dict(kkt_dtype="float32", mu_min=1e-8, banded_escalate_rtol=0.0), 1),
    (dict(kkt_dtype="float32", mu_min=1e-7, banded_algo="cr",
          banded_cr_fallback_rtol=0.0, banded_pcg_refine=0), 1),
    (dict(kkt_dtype="float32", mu_min=1e-7), 0),
    (dict(), 0),
]


@pytest.mark.parametrize("kw,count", UNSAFE)
def test_validate_settings_warns_like_jax(kw, count):
    seen = []
    for mod, cls in ((jvalidate, qt.Settings), (tvalidate, pt.Settings)):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            mod.validate_settings(cls(**kw))
        assert all(issubclass(w.category, mod.UnsafeSettingsWarning)
                   for w in rec)
        seen.append([str(w.message) for w in rec])
    assert len(seen[1]) == count
    assert seen[0] == seen[1]
    assert pt.UnsafeSettingsWarning is tvalidate.UnsafeSettingsWarning


def test_validate_data_raises_like_jax():
    Q, q, A, l, u = _qp(4, 6)
    cases = []
    bad_u = u.copy()
    bad_u[3] = l[3] - 1.0
    cases.append((Q, q, A, l, bad_u))
    nan_l = l.copy()
    nan_l[0] = np.nan
    cases.append((Q, q, A, nan_l, u))
    for Q_, q_, A_, l_, u_ in cases:
        with pytest.raises(ValueError) as jerr:
            jvalidate.validate_data(qt.make_problem(Q_, q_, A_, l_, u_))
        with pytest.raises(ValueError) as terr:
            tvalidate.validate_data(pt.make_problem(Q_, q_, A_, l_, u_,
                                                    device="cpu"))
        assert str(terr.value) == str(jerr.value)
    tp = pt.make_problem(Q, q, A, l, u, device="cpu")
    tvalidate.validate_data(tp)
    with pytest.raises(ValueError, match="q must have length"):
        tvalidate.validate_data(tp._replace(q=tp.q[:, :3]))
    with pytest.raises(ValueError, match="l/u must have length"):
        tvalidate.validate_data(tp._replace(u=tp.u[:, :5]))
    with pytest.raises(ValueError, match="Q must be square"):
        tvalidate.validate_data(tp._replace(Q=tp.Q[:, :3]))
    with pytest.raises(ValueError, match="Lower bound at index 3"):
        pt.solve(pt.make_problem(*cases[0], device="cpu"))
