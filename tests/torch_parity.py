"""Helpers of the PyTorch port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package (jitted and vmapped, as
its own batch solver runs them) and through the port (batched, on the
CPU).  States are handed from JAX to the port with
``qpdo_tpu_torch.convert``, so that one step can be held from a common
state.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.parallel.batch import _solve_batch_compact, solve_batch
from qpdo_tpu.solver import core as jcore
from qpdo_tpu.solver.scaling import scale_problem as j_scale

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert


def family(B, n, m, seed):
    """The bench problem family (bench.py:344-352) as numpy float64."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    Q = np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)
    return dict(Q=Q, q=rng.standard_normal((B, n)),
                A=rng.standard_normal((B, m, n)),
                l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))


def stacked(problems):
    """A batch from a list of (Q, q, A, l, u) tuples of one shape."""
    keys = ("Q", "q", "A", "l", "u")
    d = {k: np.stack([p[i] for p in problems]) for i, k in enumerate(keys)}
    d["c"] = np.zeros(len(problems))
    return d


def jax_problem(d):
    return qt.Problem(**{k: jnp.asarray(v) for k, v in d.items()})


def torch_problem(d):
    return pt.Problem(**{k: torch.from_numpy(np.array(v))
                         for k, v in d.items()})


def solve_both(d, settings, compact=False, x0=None, y0=None):
    """One batch through both packages' batch solvers."""
    jx0 = None if x0 is None else jnp.asarray(x0)
    jy0 = None if y0 is None else jnp.asarray(y0)
    if compact:
        jr = _solve_batch_compact(jax_problem(d), settings, jx0, jy0,
                                  x0 is not None, y0 is not None)
    else:
        jr = solve_batch(jax_problem(d), settings, jx0, jy0)
    tr = pt.solve_batch(
        torch_problem(d), convert.settings(settings),
        x0=None if x0 is None else torch.from_numpy(np.array(x0)),
        y0=None if y0 is None else torch.from_numpy(np.array(y0)),
        compact=compact)
    return jr, tr


def oracle(d, x, y):
    """The numpy float64 KKT oracle of bench.py:482-490, per problem."""
    Ax = np.einsum("bmn,bn->bm", d["A"], x)
    rp = np.abs(Ax - np.clip(Ax + y, d["l"], d["u"])).max(axis=1)
    rd = np.abs(np.einsum("bij,bj->bi", d["Q"], x) + d["q"]
                + np.einsum("bmn,bm->bn", d["A"], y)).max(axis=1)
    return rp, rd


def assert_same(tr, jr, atol=1e-8):
    """Statuses and iteration counts equal per problem, x and y within
    ``atol``."""
    np.testing.assert_array_equal(tr.info.status_val.numpy(),
                                  np.asarray(jr.info.status_val))
    np.testing.assert_array_equal(tr.info.iterations.numpy(),
                                  np.asarray(jr.info.iterations))
    np.testing.assert_allclose(tr.x.numpy(), np.asarray(jr.x), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(tr.y.numpy(), np.asarray(jr.y), rtol=0,
                               atol=atol)


def scaled_pair(d, settings):
    """(JAX batched ScaledProblem, the port's)."""
    jsp = jax.jit(jax.vmap(
        lambda p: j_scale(p, settings.scaling, settings.ruiz_kkt)))(
            jax_problem(d))
    return jsp, convert.scaled_problem(jsp, "cpu")


def jax_states(jsp, settings, steps=0):
    """The JAX package's batched initial state, ``steps`` steps in."""
    s = jax.jit(jax.vmap(lambda sp: jcore.init_state(
        sp, settings, None, None, False, False)))(jsp)
    step = jax.jit(jax.vmap(lambda sp, st: jcore.step(sp, settings, st)))
    for _ in range(steps):
        s = step(jsp, s)
    return s


def rel_err(a, b):
    """max|a - b| / max(1, max|b|) of a tensor and an array."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(1.0, np.abs(b).max())


def assert_states_close(ts, js, rtol):
    """Every field of a port state against a JAX state: integer fields
    equal, float fields (and each array of a tuple cache) within
    ``rtol`` relative to max(1, max|field|)."""
    for name in pt.types.SolverState._fields:
        a, b = getattr(ts, name), getattr(js, name)
        if a is None:
            assert b is None, name
            continue
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for x, y in pairs:
            if x.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=name)
            else:
                assert rel_err(x, y) <= rtol, (name, rel_err(x, y))
