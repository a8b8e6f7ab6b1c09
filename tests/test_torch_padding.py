"""The PyTorch port's padding and heterogeneous solving
(``qpdo_tpu_torch/utils/padding.py``) against the JAX package's
(``qpdo_tpu/utils/padding.py``), on the CPU in float64.

Padding is inert: a padded solve takes the unpadded solve's statuses and
iterations, with x and y within the reference tests' tolerances
(tests/test_padding.py): 1e-12 for one problem, 1e-10 for a padded batch
(3.9e-12 found: the batched matmuls of another shape sum in another
order).  ``solve_heterogeneous`` gives the JAX package's status and
iterations per problem, with x within 1e-8.
"""

import numpy as np
import pytest
import torch

import qpdo_tpu as qt
from qpdo_tpu.utils import padding as jpad

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.utils import padding as tpad

from utils import kkt_residuals, random_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _pair(n, m, seed):
    Q, q, A, l, u = random_qp(n, m, seed=seed)
    return (pt.make_problem(Q, q, A, l, u, device="cpu"),
            qt.make_problem(Q, q, A, l, u))


def test_pad_problem_matches_jax():
    tp, jp = _pair(20, 15, 0)
    tpp, jpp = tpad.pad_problem(tp, 32, 24), jpad.pad_problem(jp, 32, 24)
    for name in pt.Problem._fields:
        np.testing.assert_array_equal(getattr(tpp, name).numpy()[0],
                                      np.asarray(getattr(jpp, name)), name)
    with pytest.raises(ValueError, match="smaller than"):
        tpad.pad_problem(tp, 16, 24)


def test_padding_is_inert():
    tp, _ = _pair(20, 15, 0)
    res = pt.solve(tp)
    res_p = tpad.unpad_result(pt.solve(tpad.pad_problem(tp, 32, 24)), 20, 15)
    assert res_p.info.status == ["solved"]
    assert int(res_p.info.iterations) == int(res.info.iterations)
    assert res_p.x.shape == (1, 20) and res_p.y.shape == (1, 15)
    np.testing.assert_allclose(res_p.x.numpy(), res.x.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res_p.y.numpy(), res.y.numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(res_p.info.objective.numpy(),
                               res.info.objective.numpy(), rtol=1e-12)


def test_padding_keeps_the_infeasibility_certificate():
    Q = np.array([[1.0, 0.0], [0.0, 0.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    p = pt.make_problem(Q, [1.0, 0.0], A, [-np.inf, 1.0, 1.0],
                        [0.0, 3.0, 3.0], device="cpu")
    res = tpad.unpad_result(pt.solve(tpad.pad_problem(p, 8, 8),
                                     pt.Settings(max_iter=100)), 2, 3)
    assert int(res.info.status_val) == pt.PRIMAL_INFEASIBLE
    dy = res.prim_inf_cert.numpy()[0]
    assert np.max(np.abs(A.T @ dy)) / np.max(np.abs(dy)) <= 1e-4


def test_padded_batch_is_inert():
    """A whole batch padded at once (bench.py's QPDO_BENCH_PAD path in the
    JAX package) solves as the unpadded batch, the padded tail at zero."""
    B, n, m = 6, 20, 30
    rng = np.random.default_rng(5)
    M = rng.standard_normal((B, n, n))
    probs = pt.Problem(
        Q=torch.tensor(np.einsum("bij,bkj->bik", M, M) / n + 0.1 * np.eye(n)),
        q=torch.tensor(rng.standard_normal((B, n))),
        A=torch.tensor(rng.standard_normal((B, m, n))),
        l=torch.tensor(-rng.random((B, m))), u=torch.tensor(rng.random((B, m))),
        c=torch.zeros(B, dtype=torch.float64))
    padded = tpad.pad_problem(probs, 32, 40)
    assert padded.A.shape == (B, 40, 32)
    res, res_p = pt.solve_batch(probs), pt.solve_batch(padded)
    assert torch.equal(res_p.info.status_val, res.info.status_val)
    assert torch.equal(res_p.info.iterations, res.info.iterations)
    np.testing.assert_allclose(res_p.x[:, :n].numpy(), res.x.numpy(), rtol=0,
                               atol=1e-10)
    assert not res_p.x[:, n:].any() and not res_p.y[:, m:].any()


def test_bucketing_matches_jax():
    sizes = [(10, 8, 1), (12, 6, 2), (40, 33, 3), (9, 7, 4)]
    pairs = [_pair(n, m, s) for n, m, s in sizes]
    tb = tpad.bucket_problems([p for p, _ in pairs], n_mult=16, m_mult=16)
    jb = jpad.bucket_problems([p for _, p in pairs], n_mult=16, m_mult=16)
    assert set(tb) == set(jb) == {(16, 16), (48, 48)}
    for key, (stacked, idxs) in tb.items():
        assert idxs == jb[key][1]
        for name in pt.Problem._fields:
            np.testing.assert_array_equal(
                getattr(stacked, name).numpy(),
                np.asarray(getattr(jb[key][0], name)), name)
    two = pt.Problem(*(torch.cat([a, a]) for a in pairs[0][0]))
    with pytest.raises(ValueError, match="batch of one"):
        tpad.bucket_problems([two])


def test_solve_heterogeneous_matches_jax():
    sizes = [(15, 10, 5), (20, 30, 6), (50, 40, 7), (17, 12, 8)]
    data = [random_qp(n, m, seed=s) for n, m, s in sizes]
    tres = pt.solve_heterogeneous(
        [pt.make_problem(*d, device="cpu") for d in data])
    jres = jpad.solve_heterogeneous([qt.make_problem(*d) for d in data])
    for (n, m, _), d, tr, jr in zip(sizes, data, tres, jres):
        assert tr.x.shape == (1, n) and tr.y.shape == (1, m)
        assert tr.info.status == ["solved"]
        assert int(tr.info.status_val) == int(jr.info.status_val)
        assert int(tr.info.iterations) == int(jr.info.iterations)
        np.testing.assert_allclose(tr.x.numpy()[0], np.asarray(jr.x), rtol=0,
                                   atol=1e-8)
        rp, rd = kkt_residuals(*d, tr.x.numpy()[0], tr.y.numpy()[0])
        assert rp <= 1e-6 and rd <= 1e-6
