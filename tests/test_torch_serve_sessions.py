"""The PyTorch port's ``SolverService``, second half: priorities, the
counters, shutdown, the per-session warm-start cache, the errors a batch
meets, cancelled requests, a mesh of one rank, and a stress test of the
shared counters.  On
the CPU in float64; tests/test_torch_serve.py has the first half.
"""

import sys
import threading

import numpy as np
import pytest

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.serve import SolverService

from utils import kkt_residuals, random_qp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _problem(Q, q, A, l, u):
    return pt.make_problem(Q, q, A, l, u, device="cpu")


def _tiny(k=2):
    return _problem(np.eye(k), np.zeros(k), np.eye(k), -np.ones(k),
                    np.ones(k))


def test_priority_ordering():
    """Higher-priority requests are dequeued before lower-priority ones
    queued earlier (max_batch=1, so dequeue order is completion order)."""
    svc = SolverService(max_batch=1, max_wait_ms=0)
    p, low, high = _problem(*random_qp(40, 30, seed=1)), _tiny(3), _tiny(3)
    order = []
    first = svc.submit(p)          # occupies the worker
    f_low = svc.submit(low, priority=0)
    f_high = svc.submit(high, priority=5)
    f_low.add_done_callback(lambda f: order.append("low"))
    f_high.add_done_callback(lambda f: order.append("high"))
    for f in (first, f_low, f_high):
        f.result(timeout=300)
    svc.shutdown()
    assert order == ["high", "low"]


def test_stats_counters():
    svc = SolverService(max_batch=8, max_wait_ms=20)
    p = _problem(*random_qp(10, 8, seed=50))
    for f in [svc.submit(p) for _ in range(5)]:
        f.result(timeout=300)
    s = svc.stats()
    svc.shutdown()
    assert (s["submitted"], s["completed"], s["failed"]) == (5, 5, 0)
    assert s["by_status"] == {"solved": 5}
    assert s["batches"] >= 1 and s["mean_batch_size"] > 0
    assert s["mean_latency_s"] > 0 and s["queue_depth"] == 0


def test_shutdown_serves_admitted_requests():
    """Every Future admitted before shutdown() resolves."""
    svc = SolverService(max_batch=8, max_wait_ms=1)
    futs = [svc.submit(_tiny()) for _ in range(16)]
    svc.shutdown(wait=True)
    assert not svc._worker.is_alive()
    for f in futs:
        assert f.result(timeout=300).info.status == ["solved"]


def test_session_warm_start_cache():
    """A named session warm-starts from its last solved solution: the
    MPC-style re-solve takes fewer iterations than the cold solve and
    meets the KKT oracle; another session or other dimensions miss."""
    svc = SolverService(max_batch=4, max_wait_ms=5)
    try:
        Q, q, A, l, u = random_qp(30, 20, seed=9)
        r1 = svc.submit(_problem(Q, q, A, l, u),
                        session="mpc-client-7").result(120)
        assert r1.info.status == ["solved"]
        r2 = svc.submit(_problem(Q, q + 1e-3, A, l, u),
                        session="mpc-client-7").result(120)
        assert r2.info.status == ["solved"]
        assert int(r2.info.iterations) < int(r1.info.iterations)
        rp, rd = kkt_residuals(Q, q + 1e-3, A, l, u, r2.x.numpy()[0],
                               r2.y.numpy()[0])
        assert rp <= 1e-6 and rd <= 1e-6
        assert svc.stats()["session_warm_hits"] == 1
        r3 = svc.submit(_problem(Q, q + 1e-3, A, l, u),
                        session="other").result(120)
        assert r3.info.status == ["solved"]
        r4 = svc.submit(_problem(*random_qp(12, 8, seed=10)),
                        session="mpc-client-7").result(120)
        assert r4.info.status == ["solved"]
        assert svc.stats()["session_warm_hits"] == 1
    finally:
        svc.shutdown()


def test_session_lru_eviction():
    svc = SolverService(max_batch=2, max_wait_ms=2, max_sessions=2)
    try:
        p = _problem(*random_qp(16, 10, seed=11))
        for name in ("a", "b", "c"):      # "a" evicted at the third insert
            svc.submit(p, session=name).result(120)
        assert svc.submit(p, session="a").result(120) is not None
        assert svc.stats()["session_warm_hits"] == 0
        svc.submit(p, session="c").result(120)
        assert svc.stats()["session_warm_hits"] == 1
    finally:
        svc.shutdown()


def test_an_error_reaches_the_futures_of_its_batch_only():
    """An exception raised while a batch solves is set on that batch's
    Futures; a request of another batch in the same micro-batch is
    served, and so is the next one: the worker goes on."""
    svc = SolverService(max_batch=8, max_wait_ms=50)
    try:
        bad = svc.submit(_tiny(), settings=pt.Settings(kkt_dtype="bfloat16"))
        good = svc.submit(_tiny())
        with pytest.raises(NotImplementedError, match="bfloat16"):
            bad.result(timeout=300)
        assert good.result(timeout=300).info.status == ["solved"]
        assert svc.submit(_tiny()).result(timeout=300).info.status \
            == ["solved"]
        s = svc.stats()
        assert (s["failed"], s["completed"]) == (1, 2)
    finally:
        svc.shutdown()


def test_a_cancelled_request_is_skipped():
    """A Future its caller cancelled while queued is not solved, and the
    requests queued with it are served (max_batch=1: the first request
    holds the worker while the others wait)."""
    svc = SolverService(max_batch=1, max_wait_ms=0)
    try:
        p, tiny = _problem(*random_qp(40, 30, seed=2)), _tiny()
        first = svc.submit(p)
        futs = [svc.submit(tiny) for _ in range(3)]
        assert futs[1].cancel()
        first.result(timeout=300)
        for k in (0, 2):
            assert futs[k].result(timeout=300).info.status == ["solved"]
        assert futs[1].cancelled()
    finally:
        svc.shutdown()
    assert svc.stats()["completed"] == 3


def test_a_mesh_is_refused():
    """The mesh, no longer refused (tests/test_torch_serve_mesh.py holds
    it over 2 ranks against JAX): a service over a mesh of one rank
    serves a request as the plain service does."""
    from torch_dist import one_rank_mesh

    Q, q, A, l, u = random_qp(6, 5, seed=3)
    ref = pt.solve(_problem(Q, q, A, l, u))
    with one_rank_mesh("batch") as mesh:
        svc = SolverService(max_batch=4, max_wait_ms=5, mesh=mesh)
        try:
            out = svc.submit(_problem(Q, q, A, l, u)).result(timeout=300)
        finally:
            svc.shutdown()
    assert out.info.status == ["solved"]
    np.testing.assert_allclose(out.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-12)


def test_counters_under_contention():
    """32 threads submit 4 requests each, with a shortened switch
    interval: every request is served once and the shared counters and
    session cache lose no update."""
    svc = SolverService(max_batch=16, max_wait_ms=2, max_sessions=8)
    futs, lock = [], threading.Lock()

    def client(i):
        for k in range(4):
            f = svc.submit(_tiny(2 + k % 2), session=f"s{i % 12}")
            with lock:
                futs.append(f)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        results = [f.result(timeout=300) for f in futs]
    finally:
        sys.setswitchinterval(old)
        svc.shutdown()
    assert len(results) == 128
    assert all(r.info.status == ["solved"] for r in results)
    s = svc.stats()
    assert (s["submitted"], s["completed"], s["failed"]) == (128, 128, 0)
    assert s["by_status"] == {"solved": 128}
    assert s["batches"] * s["mean_batch_size"] == pytest.approx(128)
    assert len(svc._sessions) <= 8
