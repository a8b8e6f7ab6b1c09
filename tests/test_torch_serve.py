"""The PyTorch port's ``SolverService``: micro-batched serving matches
direct solves, on the CPU in float64.  The cases of tests/test_serve.py
that run on one device, in two files (this one and
tests/test_torch_serve_sessions.py).  One request is also held against
the JAX package's direct solve, x within 1e-8 (the same iterations run in
both packages); a request against the port's direct solve within 1e-10
(tests/test_serve.py's tolerance: padding changes the matmuls' shapes).
"""

import queue as queue_mod
import threading

import numpy as np
import pytest

import qpdo_tpu as qt

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.serve import SolverService

from utils import kkt_residuals, random_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _problem(Q, q, A, l, u):
    return pt.make_problem(Q, q, A, l, u, device="cpu")


@pytest.fixture(scope="module")
def service():
    svc = SolverService(max_batch=8, max_wait_ms=30)
    yield svc
    svc.shutdown()


def test_single_request_matches_direct(service):
    data = random_qp(20, 15, seed=0)
    res = service.solve(_problem(*data), timeout=300)
    direct = pt.solve(_problem(*data))
    jdirect = qt.solve(qt.make_problem(*data))
    assert res.info.status == ["solved"]
    assert res.x.shape == (1, 20) and res.y.shape == (1, 15)
    np.testing.assert_allclose(res.x.numpy(), direct.x.numpy(), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.x.numpy()[0], np.asarray(jdirect.x),
                               rtol=0, atol=1e-8)


def test_concurrent_mixed_sizes(service):
    sizes = [(12, 9), (20, 15), (40, 28), (12, 9), (33, 40), (20, 15)]
    datas = [random_qp(n, m, seed=10 + i) for i, (n, m) in enumerate(sizes)]
    futures = [None] * len(datas)

    def submit(i):
        futures[i] = service.submit(_problem(*datas[i]))

    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for (n, m), data, fut in zip(sizes, datas, futures):
        res = fut.result(timeout=300)
        assert res.x.shape == (1, n) and res.info.status == ["solved"]
        rp, rd = kkt_residuals(*data, res.x.numpy()[0], res.y.numpy()[0])
        assert rp <= 1e-6 and rd <= 1e-6


def test_warm_request(service):
    p = _problem(*random_qp(18, 14, seed=30))
    cold = service.solve(p, timeout=300)
    warm = service.solve(p, x0=cold.x, y0=cold.y, timeout=300)
    assert warm.info.status == ["solved"]
    assert int(warm.info.iterations) < int(cold.info.iterations)


def test_infeasible_request(service):
    Q = np.array([[1.0, 0.0], [0.0, 0.0]])
    A = np.array([[1.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    p = _problem(Q, [1.0, 0.0], A, [-np.inf, 1, 1], [0.0, 3, 3])
    res = service.solve(p, timeout=300)
    assert int(res.info.status_val) == pt.PRIMAL_INFEASIBLE


def test_per_request_settings_override(service):
    """A request-level Settings override is applied, and batches apart
    from default-settings requests."""
    p = _problem(*random_qp(20, 15, seed=41))
    f_over = service.submit(p, settings=pt.Settings(max_iter=1))
    f_def = service.submit(p)
    assert int(f_over.result(timeout=300).info.status_val) \
        == pt.MAX_ITER_REACHED
    assert f_def.result(timeout=300).info.status == ["solved"]


def test_shutdown_rejects():
    svc = SolverService()
    svc.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        svc.submit(_problem(np.eye(2), [0, 0], np.eye(2), [-1, -1], [1, 1]))


def test_backpressure_bounded_queue():
    """A full request queue raises queue.Full on a non-blocking submit
    instead of growing without bound."""
    svc = SolverService(max_batch=4, max_wait_ms=5, max_pending=2)
    p = _problem(np.eye(2), [0.0, 0.0], np.eye(2), [-1, -1], [1, 1])
    futs = []
    with pytest.raises(queue_mod.Full):
        for _ in range(64):
            futs.append(svc.submit(p, block=False))
    for f in futs:
        assert f.result(timeout=300).info.status == ["solved"]
    svc.shutdown()
