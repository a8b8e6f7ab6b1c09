"""The PyTorch port's scenario-sharded structured solve
(``solver.structured``: the scenario-leading leaves DTensors split over
the ranks of a gloo group on the CPU; every sum over the scenarios one
all-reduce) against the JAX package's ``solve_block_angular`` on leaves
sharded over a mesh of as many virtual CPU devices
(tests/test_structured.py:test_sharded_scenarios_match): the same
status and iterations, x within 1e-9."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import qpdo_tpu as qt
from qpdo_tpu.solver.structured import BlockAngularProblem, solve_block_angular

import torch_parity_data as data
from torch_dist import Ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-9
SPLIT = ("Qs", "qs", "T", "W", "l", "u")


@pytest.fixture(scope="module")
def ranks():
    return Ranks("structured_sharded", 4, timeout=900)


def _jax(ndev, settings, warm=False):
    p = data.random_bap(S=8, ms=10, n0=5, ns=6, seed=4)
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("sc",))

    def put(name, a):
        a = jnp.asarray(a)
        spec = P("sc", *([None] * (a.ndim - 1))) if name in SPLIT else P()
        return jax.device_put(a, NamedSharding(mesh, spec))

    p = BlockAngularProblem(**{k: put(k, v) for k, v in p.items()})
    solve = jax.jit(lambda pp, w: solve_block_angular(pp, settings, w))
    out = solve(p, None)
    if warm:
        out = solve(p, out[:3])
    return out


def _hold(ours, ref):
    x0, xs, y, info = ref
    assert ours["status"] == int(info.status_val) == qt.SOLVED
    assert ours["iterations"] == int(info.iterations)
    np.testing.assert_allclose(ours["x0"][0], np.asarray(x0), atol=TOL)
    np.testing.assert_allclose(ours["xs"][0], np.asarray(xs), atol=TOL)


@pytest.mark.parametrize("ndev", [2, 4])
def test_matches_jax(ranks, ndev):
    ref = _jax(ndev, qt.Settings(**data.STRUCTURED))
    ours = ranks.result()[0][("structured", ndev)]
    _hold(ours, ref)
    np.testing.assert_allclose(ours["y"][0], np.asarray(ref[2]), atol=TOL)


def test_default_settings_match_jax(ranks):
    """Scaling, the certificates and the sorted linesearch (its hinges
    gathered from every rank) over 4 ranks."""
    _hold(ranks.result()[0][("default", 4)], _jax(4, qt.Settings()))


def test_warm_start_matches_jax(ranks):
    ref = _jax(2, qt.Settings(**data.STRUCTURED), warm=True)
    _hold(ranks.result()[0][("warm", 2)], ref)


def test_x0_is_the_same_on_every_rank(ranks):
    values = ranks.result()
    for key, v in values[0].items():
        for w in values[1:]:
            if key in w:
                np.testing.assert_array_equal(w[key]["x0"], v["x0"])
