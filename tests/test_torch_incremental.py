"""The incremental KKT cache of the PyTorch port
(``Settings.kkt_update_rows``: K_tilde = Q + A' diag(w_applied) A carried
across steps, the k most-changed rows added each step) against the JAX
package on the CPU, float64.

* ``kkt_cache_build`` to 1e-12; ``newton_system_solve_cached`` to 1e-12,
  on weights where many |dw| tie: the rows taken are JAX's (``top_k``
  puts the lower index first among equals; ``top_rows`` sorts stably).
* Full solves with ``kkt_update_rows=12``, plain and compacted: JAX's
  statuses and iteration counts, x and y within 1e-8.
* ``convert.state`` keeps the pair cache of a JAX state, and a step from
  it agrees to 1e-12; compaction moves the pair with the rest of the
  state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import qpdo_tpu as qt
from qpdo_tpu.ops import linalg as jlinalg
from qpdo_tpu.solver import core as jcore

from qpdo_tpu_torch import convert
from qpdo_tpu_torch.ops import linalg as tlinalg
from qpdo_tpu_torch.parallel import batch as tbatch
from qpdo_tpu_torch.solver import core as tcore

from torch_parity import (assert_same, assert_states_close, family,
                          jax_states, rel_err, scaled_pair, solve_both)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B=4, n=16, m=24, seed=71):
    rng = np.random.default_rng(seed)
    d = family(B, n, m, seed)
    w = rng.choice([0.0, 0.5, 2.0, 10.0], size=(B, m))
    return d["Q"], d["A"], w, rng


@pytest.mark.parametrize("kkt_dtype", [None, "float32"])
def test_kkt_cache_build_matches_jax(kkt_dtype):
    Q, A, w, _ = _inputs()
    jK, jw = jax.vmap(lambda a, b, c: jlinalg.kkt_cache_build(
        a, b, c, kkt_dtype))(Q, A, w)
    tK, tw = tlinalg.kkt_cache_build(_t(Q), _t(A), _t(w), kkt_dtype)
    assert tK.dtype == (torch.float64 if kkt_dtype is None else torch.float32)
    tol = 1e-12 if kkt_dtype is None else 1e-6
    assert rel_err(tK, jK) <= tol
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_top_rows_takes_the_lower_index_among_ties():
    v = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 2.0],
                      [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    assert tlinalg.top_rows(v, 4).tolist() == [[1, 2, 4, 5], [0, 1, 2, 3]]
    _, jidx = jax.vmap(lambda r: jax.lax.top_k(r, 4))(jnp.asarray(v.numpy()))
    np.testing.assert_array_equal(np.asarray(jidx),
                                  tlinalg.top_rows(v, 4).numpy())


def test_cached_newton_solve_matches_jax_with_tied_rows():
    Q, A, w_app, rng = _inputs()
    B, m = w_app.shape
    # the new weights move whole groups of rows by the same |dw|
    w = w_app.copy()
    w[:, :6] += 1.5
    w[:, 6:12] -= 0.5 * (w_app[:, 6:12] > 0)
    w[:, 20:] += 1.5
    sigma = np.full(B, 1e-3)
    rhs = rng.standard_normal((B, Q.shape[-1]))

    def jone(Qb, Ab, wab, wb, sb, rb):
        cache = jlinalg.kkt_cache_build(Qb, Ab, wab)
        return jlinalg.newton_system_solve_cached(Qb, Ab, wb, sb, rb, cache,
                                                  True, 2, None, 5)

    jdx, (jK, jw) = jax.jit(jax.vmap(jone))(Q, A, w_app, w, sigma, rhs)
    cache = tlinalg.kkt_cache_build(_t(Q), _t(A), _t(w_app))
    dx, (tK, tw) = tlinalg.newton_system_solve_cached(
        _t(Q), _t(A), _t(w), _t(sigma), _t(rhs), cache, True, 2, None, 5)
    # the same five rows were added: w_applied is JAX's bit for bit
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert rel_err(tK, jK) <= 1e-12
    assert rel_err(dx, jdx) <= 1e-12


@pytest.mark.parametrize("compact", [False, True])
def test_incremental_solve_matches_jax(compact):
    d = family(5, 30, 45, seed=72)
    settings = qt.Settings(kkt_update_rows=12, pallas_residuals=True)
    jr, tr = solve_both(d, settings, compact=compact)
    assert np.all(tr.info.status_val.numpy() == qt.SOLVED)
    assert_same(tr, jr)


def test_state_with_the_pair_cache_converts_and_steps_as_jax():
    settings = qt.Settings(kkt_update_rows=8)
    jsp, tsp = scaled_pair(family(3, 20, 30, seed=73), settings)
    js = jax_states(jsp, settings, steps=5)
    ts = convert.state(js, "cpu")
    assert isinstance(ts.kkt_cache, tuple) and len(ts.kkt_cache) == 2
    assert_states_close(ts, js, 0.0)
    js = jax.jit(jax.vmap(lambda sp, s: jcore.step(sp, settings, s)))(jsp, js)
    ts = tcore.step(tsp, convert.settings(settings), ts)
    assert_states_close(ts, js, 1e-12)


def test_compaction_moves_the_pair_cache():
    settings = qt.Settings(kkt_update_rows=8)
    jsp, tsp = scaled_pair(family(4, 20, 30, seed=74), settings)
    s = convert.state(jax_states(jsp, settings, steps=3), "cpu")
    idx = torch.tensor([2, 0])
    sub = tbatch._take(s, idx)
    assert isinstance(sub.kkt_cache, tuple)
    assert torch.equal(sub.kkt_cache[0], s.kkt_cache[0][idx])
    assert torch.equal(sub.kkt_cache[1], s.kkt_cache[1][idx])
    moved = sub._replace(kkt_cache=tuple(2.0 * a for a in sub.kkt_cache))
    back = tbatch._put(s, idx, moved)
    for k in (0, 1):
        assert torch.equal(back.kkt_cache[k][idx], moved.kkt_cache[k])
        assert torch.equal(back.kkt_cache[k][[1, 3]], s.kkt_cache[k][[1, 3]])
    # and masked() picks the pair per problem
    mask = torch.tensor([True, False, True, False])
    mixed = tcore.masked(back, s, mask)
    assert torch.equal(mixed.kkt_cache[0][2], moved.kkt_cache[0][0])
    assert torch.equal(mixed.kkt_cache[1][1], s.kkt_cache[1][1])
    assert torch.equal(mixed.kkt_cache[1][0], moved.kkt_cache[1][1])
