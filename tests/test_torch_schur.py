"""The PyTorch port's arrow (block-angular) Schur-complement solve
(``qpdo_tpu_torch.ops.schur``) against the JAX package's
(``qpdo_tpu.ops.schur``) and against a dense solve, on the CPU, float64,
on the systems of tests/test_schur.py (``_random_arrow``) as a batch.

* ``arrow_solve`` of a batch of two systems: each problem's residual in
  the assembled dense K within 1e-8 relative (the JAX test's check), and
  x within 1e-12 relative of JAX's ``arrow_solve`` of that system.
* ``arrow_to_dense`` equals JAX's, per problem, bit for bit.
* ``arrow_solve_sharded`` raises NotImplementedError naming the
  distributed slice.
"""

import numpy as np
import pytest
import torch

from qpdo_tpu.ops import schur as jschur

from qpdo_tpu_torch.ops import schur as tschur

from test_schur import _random_arrow
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _batch(seeds, S=8):
    """Two JAX systems of tests/test_schur.py and their stacked port
    counterpart."""
    jax_side = [_random_arrow(S=S, seed=s) for s in seeds]
    stack = lambda k: torch.from_numpy(np.stack([np.asarray(k(j))
                                                 for j in jax_side]))
    system = tschur.ArrowSystem(K00=stack(lambda j: j[0].K00),
                                Kss=stack(lambda j: j[0].Kss),
                                Bs=stack(lambda j: j[0].Bs))
    return jax_side, system, stack(lambda j: j[1]), stack(lambda j: j[2])


def test_arrow_solve_matches_jax_and_the_dense_solve():
    jax_side, system, r0, rs = _batch((0, 3))
    x0, xs = tschur.arrow_solve(system, r0, rs)
    assert x0.shape == r0.shape and xs.shape == rs.shape
    K = tschur.arrow_to_dense(system).numpy()
    for b, (jsys, jr0, jrs) in enumerate(jax_side):
        r = np.concatenate([np.asarray(jr0), np.asarray(jrs).ravel()])
        x = np.concatenate([x0[b].numpy(), xs[b].numpy().ravel()])
        assert np.abs(K[b] @ x - r).max() <= 1e-8 * max(1.0, np.abs(r).max())
        jx0, jxs = jschur.arrow_solve(jsys, jr0, jrs)
        ref = np.concatenate([np.asarray(jx0), np.asarray(jxs).ravel()])
        assert np.abs(x - ref).max() <= 1e-12 * max(1.0, np.abs(ref).max())


def test_arrow_to_dense_equals_jax():
    jax_side, system, _, _ = _batch((1, 2), S=3)
    K = tschur.arrow_to_dense(system).numpy()
    for b, (jsys, _, _) in enumerate(jax_side):
        assert np.array_equal(K[b], np.asarray(jschur.arrow_to_dense(jsys)))


def test_arrow_solve_sharded_waits_for_the_distributed_slice():
    """The sharded solve, ported since (tests/test_torch_schur_sharded.py
    holds it over 2 and 4 ranks against JAX): over a mesh of one rank it
    is ``arrow_solve``, and xs is a DTensor of the whole system."""
    from torch_dist import one_rank_mesh

    _, system, r0, rs = _batch((0, 1), S=2)
    x0_ref, xs_ref = tschur.arrow_solve(system, r0, rs)
    with one_rank_mesh("scenario") as mesh:
        x0, xs = tschur.arrow_solve_sharded(system, r0, rs, mesh)
        assert xs.shape == xs_ref.shape
        np.testing.assert_allclose(x0.numpy(), x0_ref.numpy(), rtol=0,
                                   atol=1e-14)
        np.testing.assert_allclose(xs.to_local().numpy(), xs_ref.numpy(),
                                   rtol=0, atol=1e-14)
