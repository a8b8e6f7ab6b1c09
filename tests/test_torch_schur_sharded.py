"""The PyTorch port's scenario-sharded arrow solve
(``ops/schur.arrow_solve_sharded``: the scenarios split over the ranks of
a gloo group on the CPU, one all-reduce for the Schur complement) against
the JAX package's ``arrow_solve_sharded`` (shard_map over a mesh of as
many virtual CPU devices), on the systems of tests/test_schur.py: within
1e-10 relative, x0 the same on every rank."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from qpdo_tpu.ops.schur import ArrowSystem, arrow_solve_sharded

import torch_parity_data as data
from torch_dist import Ranks
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-10


@pytest.fixture(scope="module")
def ranks():
    return Ranks("schur_sharded", 4, timeout=900)


@functools.lru_cache(maxsize=None)
def _jax(S, seed, ndev):
    K00, Kss, Bs, r0, rs = (jnp.asarray(a)
                            for a in data.random_arrow(S=S, seed=seed))
    mesh = Mesh(np.asarray(jax.devices()[:ndev]), ("scenario",))
    x0, xs = arrow_solve_sharded(ArrowSystem(K00, Kss, Bs), r0, rs, mesh)
    return np.asarray(x0), np.asarray(xs)


def _hold(ours, ref):
    x0, xs = ref
    scale = max(np.abs(x0).max(), np.abs(xs).max())
    assert np.abs(ours["x0"][0] - x0).max() <= RTOL * scale
    assert np.abs(ours["xs"][0] - xs).max() <= RTOL * scale


@pytest.mark.parametrize("S,seed,ndev", [(16, 0, 2), (16, 0, 4),
                                         (8, 3, 4)])
def test_matches_jax(ranks, S, seed, ndev):
    _hold(ranks.result()[0][(S, ndev)], _jax(S, seed, ndev))


@pytest.mark.parametrize("S,seed", [(16, 0), (8, 3)])
def test_own_scenarios_per_rank(ranks, S, seed):
    """Each rank passes its own scenarios as plain tensors: the same
    solve, and each rank holds its block of xs."""
    values = ranks.result()
    _hold(values[0][(S, "own")], _jax(S, seed, 4))
    per = S // 4
    for r, v in enumerate(values):
        np.testing.assert_array_equal(
            v[(S, "own")]["local"], values[0][(S, "own")]["xs"][:, r * per:(r + 1) * per])


def test_x0_is_the_same_on_every_rank(ranks):
    values = ranks.result()
    for key, v in values[0].items():
        for w in values[1:]:
            if key in w:
                np.testing.assert_array_equal(w[key]["x0"], v["x0"])
