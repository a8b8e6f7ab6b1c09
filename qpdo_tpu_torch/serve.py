"""Micro-batching solver service: the serving runtime.

Port of ``qpdo_tpu/serve.py``.  The reference's serving
story is a process-global workspace behind a MEX singleton
(interfaces/mex/qpdo_mex.c:22); here a service turns a stream of QP
requests into lock-step batched solves on the device of the requests'
tensors:

- requests queue up; a worker thread drains them in micro-batches (up to
  ``max_batch``, waiting at most ``max_wait_ms`` for stragglers),
- higher-``priority`` requests are served first (FIFO within a priority),
- problems are padded to shape buckets (``utils/padding.py``), so that
  requests of many sizes share a few batch shapes,
- warm-started and cold requests batch separately (their init paths
  differ), as do requests of different dtypes or devices and requests
  carrying per-request ``settings`` overrides: one batch runs one
  settings object, so each distinct override is a batch of its own (the
  port compiles nothing per settings value; an override costs a smaller
  batch, not a compilation),
- callers get ``concurrent.futures.Future``s; results are those of the
  equivalent direct ``solve`` call (padding is inert); an exception in the
  worker, a kernel's ``KernelError`` included, is set on the Futures of
  the batch it struck,
- ``stats()`` exposes counters (submitted/completed/failed, per-status
  totals, batch count and mean size, queue depth, latency) for
  monitoring.

One worker on one device, or, with ``mesh`` (a 1-D ``DeviceMesh``),
one service in front of every rank of a process group.  JAX's service is
one process in front of a multi-device mesh; ``torch.distributed`` runs
one process per device, so every rank constructs the service: rank 0
owns the queue and the micro-batching, pads each batch group to a
multiple of the mesh size by repeating its last problem (as the JAX
package does), and broadcasts it; every rank solves its block of the
group on its service thread, and rank 0 gathers the results and resolves
the Futures.  The other ranks run a follower loop on their service
thread until ``shutdown()`` on rank 0 broadcasts the stop; ``submit`` is
for rank 0 only.  Each rank issues its collectives from its service
thread alone, so they come in the same order on every rank.

PyTorch's TF32 switches are process-wide: a batch whose settings ask for
another ``matmul_precision`` than a solve running at the same time in
another thread switches it for both.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .parallel.batch import _solve_batch
from .parallel.dtensor import group_of
from .types import Problem, Result, Settings, tree_map
from .utils.padding import _round_up, pad_problem, unpad_result


@dataclass
class _Request:
    problem: Problem
    x0: object
    y0: object
    future: Future
    shape: Tuple[int, int]
    settings: Optional[Settings] = None
    t_submit: float = 0.0
    session: Optional[str] = None


@dataclass(order=True)
class _Prioritized:
    """PriorityQueue entry: min-heap on (-priority, seq): higher priority
    first, FIFO within a priority level."""
    neg_priority: int
    seq: int
    request: _Request = field(compare=False)


def _warm_rows(reqs, attr: str, size: int, like: torch.Tensor):
    """The warm-start points of ``reqs`` as one (len(reqs), size) tensor
    beside ``like``, each zero-padded from its own length."""
    out = torch.zeros((len(reqs), size), dtype=like.dtype, device=like.device)
    for k, r in enumerate(reqs):
        v = torch.as_tensor(getattr(r, attr), dtype=like.dtype,
                            device=like.device).reshape(-1)
        out[k, :v.shape[0]] = v
    return out


class SolverService:
    """Threaded micro-batching QP solver front-end.  A request is one
    problem: a ``Problem`` that is a batch of one, as ``make_problem``
    builds it; its result is a batch of one, as ``solve`` returns it."""

    def __init__(self, settings: Optional[Settings] = None,
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 n_mult: int = 32, m_mult: int = 32,
                 max_pending: int = 1024, max_sessions: int = 1024,
                 mesh=None, mesh_axis: str = "batch"):
        self._settings = settings or Settings()
        # a 1-D DeviceMesh: micro-batches are padded to a multiple of its
        # size and split over its ranks (see the module docstring)
        self._mesh = mesh
        self._group = None if mesh is None else group_of(mesh)
        self._rank = 0 if mesh is None else dist.get_rank(self._group)
        # per-session warm-start cache (LRU-bounded): the serving analogue
        # of the reference's long-lived MEX workspace whose iterate
        # survives across solves (qpdo_mex.c:22 + qpdo_warm_start,
        # qpdo.c:217-299), keyed per client session for MPC-style streams
        self._sessions: "OrderedDict[str, tuple]" = OrderedDict()
        self._max_sessions = max_sessions
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._n_mult = n_mult
        self._m_mult = m_mult
        # Bounded queue = backpressure: submit() blocks (or raises, see
        # ``block``) once max_pending requests are in flight instead of
        # letting an overload grow memory without bound.
        self._queue: "queue.PriorityQueue[_Prioritized]" = \
            queue.PriorityQueue(maxsize=max_pending)
        self._lock = threading.Lock()
        self._seq = 0
        self._stop = threading.Event()
        self._stats = {"submitted": 0, "completed": 0, "failed": 0,
                       "batches": 0, "batched_requests": 0,
                       "latency_sum_s": 0.0, "by_status": {},
                       "session_warm_hits": 0}
        self._worker = threading.Thread(
            target=self._run if self._rank == 0 else self._follow,
            daemon=True)
        self._worker.start()

    # -- client API --------------------------------------------------------

    def submit(self, problem: Problem, x0=None, y0=None, *,
               settings: Optional[Settings] = None, priority: int = 0,
               session: Optional[str] = None, block: bool = True,
               timeout: Optional[float] = None) -> Future:
        """Enqueue a QP; returns a Future[Result].

        ``settings`` overrides the service-wide settings for this request
        (it then batches only with requests of equal settings).  Higher
        ``priority`` requests are dequeued first (FIFO within a level).
        With ``block=False`` (or on ``timeout``), a full queue raises
        ``queue.Full`` instead of waiting, so callers can shed load.

        ``session`` names a warm-start stream: when no explicit ``x0/y0``
        is given, the request warm-starts from the session's last SOLVED
        solution of matching dimensions, and its own solution updates the
        cache on completion.  Sequential use (wait for each result before
        the next submit) gets the hits; concurrent same-session submits
        are safe but may cold-start."""
        if self._rank != 0:
            raise RuntimeError("SolverService over a mesh: submit on rank 0; "
                               f"this is rank {self._rank}")
        if problem.Q.dim() != 3 or problem.Q.shape[0] != 1:
            raise ValueError("submit takes one problem (a batch of one, as "
                             f"make_problem builds it), got Q "
                             f"{tuple(problem.Q.shape)}")
        if session is not None and x0 is None and y0 is None:
            with self._lock:
                cached = self._sessions.get(session)
                if cached is not None and cached[0].shape[0] == problem.n \
                        and cached[1].shape[0] == problem.m:
                    x0, y0 = cached
                    self._sessions.move_to_end(session)
                    self._stats["session_warm_hits"] += 1
        fut: Future = Future()
        req = _Request(problem=problem, x0=x0, y0=y0, future=fut,
                       shape=(problem.n, problem.m), settings=settings,
                       t_submit=time.perf_counter(), session=session)
        # The lock makes submit/shutdown atomic: once shutdown() has set
        # the stop event (under this lock), no request can be enqueued
        # afterwards, so the worker's final drain serves every admitted
        # Future and none is stranded.
        with self._lock:
            if self._stop.is_set():
                raise RuntimeError("service is shut down")
            self._seq += 1
            self._queue.put(_Prioritized(-priority, self._seq, req),
                            block=block, timeout=timeout)
            self._stats["submitted"] += 1
        return fut

    def solve(self, problem: Problem, x0=None, y0=None,
              timeout: Optional[float] = None) -> Result:
        """Blocking convenience wrapper."""
        return self.submit(problem, x0, y0).result(timeout)

    def shutdown(self, wait: bool = True) -> None:
        """Stop admitting requests; the worker serves what was admitted
        and ends.  Over a mesh, rank 0's worker then stops the followers;
        on another rank this waits (with ``wait``) for that stop."""
        with self._lock:
            self._stop.set()
        if wait:
            self._worker.join()

    def stats(self) -> dict:
        """Monitoring snapshot: request/batch counters, per-status totals,
        current queue depth, mean batch size and mean submit->result
        latency."""
        with self._lock:
            s = dict(self._stats)
            s["by_status"] = dict(self._stats["by_status"])
        s["queue_depth"] = self._queue.qsize()
        s["mean_batch_size"] = (s.pop("batched_requests") / s["batches"]
                                if s["batches"] else 0.0)
        s["mean_latency_s"] = (s.pop("latency_sum_s") / s["completed"]
                               if s["completed"] else 0.0)
        return s

    # -- worker ------------------------------------------------------------

    def _drain_nowait(self) -> list:
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait().request)
            except queue.Empty:
                return out

    def _collect(self) -> Tuple[Sequence[_Request], bool]:
        """Block for one request, then drain up to max_batch within the
        micro-batching window.  Returns (batch, stop).  After shutdown,
        anything still queued (admitted before the stop event) is drained
        and served so no Future is stranded."""
        while True:
            try:
                first = self._queue.get(timeout=0.05).request
                break
            except queue.Empty:
                if self._stop.is_set():
                    # re-check the queue *after* seeing the stop event: a
                    # submit that won the race enqueued before stop was set
                    return self._drain_nowait(), True
        batch = [first]
        deadline = time.perf_counter() + self._max_wait
        while len(batch) < self._max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining).request)
            except queue.Empty:
                break
        return batch, False

    def _run(self) -> None:
        while True:
            batch, stop = self._collect()
            if batch:
                self._dispatch(batch)
            if stop:
                if self._mesh is not None:
                    self._broadcast_header(None)
                return

    def _dispatch(self, batch: Sequence[_Request]) -> None:
        # group by (padded shape, dtype, device, warm-ness, settings
        # override): one batched solve runs one init path and one settings
        # object, and stacking mixed dtypes or devices is not possible
        groups = {}
        for req in batch:
            if not req.future.set_running_or_notify_cancel():
                continue                  # cancelled by its caller: skip
            Q = req.problem.Q
            key = (_round_up(req.shape[0], self._n_mult),
                   _round_up(req.shape[1], self._m_mult),
                   Q.dtype, Q.device, req.x0 is not None, req.y0 is not None,
                   req.settings)
            groups.setdefault(key, []).append(req)
        for key, reqs in groups.items():
            try:
                self._solve_group(key, reqs)
            except Exception as e:  # noqa: BLE001 - the worker must go on
                # the Futures of this group carry the error to its callers
                for req in reqs:
                    if not req.future.done():
                        with self._lock:
                            self._stats["failed"] += 1
                        req.future.set_exception(e)

    def _solve_group(self, key, reqs: Sequence[_Request]) -> None:
        n_pad, m_pad, _dt, _dev, warm_x, warm_y, override = key
        padded = [pad_problem(r.problem, n_pad, m_pad) for r in reqs]
        problems = tree_map(lambda *xs: torch.cat(xs), *padded)
        x0 = _warm_rows(reqs, "x0", n_pad, problems.q) if warm_x else None
        y0 = _warm_rows(reqs, "y0", m_pad, problems.q) if warm_y else None
        settings = override or self._settings
        if self._mesh is None:
            res = _solve_batch(problems, settings, x0, y0)
        else:
            res = self._solve_split(problems, settings, x0, y0)
        statuses = res.info.status      # reads the batch on the host
        now = time.perf_counter()
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_requests"] += len(reqs)
        for k, req in enumerate(reqs):
            one = tree_map(lambda a: a[k:k + 1], res)
            out = unpad_result(one, req.shape[0], req.shape[1])
            status = statuses[k]
            with self._lock:
                self._stats["completed"] += 1
                self._stats["latency_sum_s"] += now - req.t_submit
                by = self._stats["by_status"]
                by[status] = by.get(status, 0) + 1
                if req.session is not None and status == "solved":
                    self._sessions[req.session] = (out.x[0], out.y[0])
                    self._sessions.move_to_end(req.session)
                    while len(self._sessions) > self._max_sessions:
                        self._sessions.popitem(last=False)
            req.future.set_result(out)

    # -- over a mesh: rank 0 leads, every rank solves its block -------------

    def _src(self) -> int:
        return dist.get_global_rank(self._group, 0)

    def _broadcast_header(self, header):
        box = [header]
        dist.broadcast_object_list(box, src=self._src(), group=self._group)
        return box[0]

    def _solve_split(self, problems: Problem, settings: Settings, x0, y0):
        """Rank 0's side: pad the group to a multiple of the mesh size by
        repeating its last problem, broadcast it, solve this rank's block,
        gather every block.  Returns the results of the unpadded group."""
        size = dist.get_world_size(self._group)
        B = problems.q.shape[0]
        pad = (-B) % size

        def padded(a):
            return torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]) if pad \
                else a

        tensors = [padded(a) for a in (*problems, x0, y0) if a is not None]
        self._broadcast_header(dict(
            settings=settings, warm=(x0 is not None, y0 is not None),
            shapes=[tuple(t.shape) for t in tensors], dtype=problems.q.dtype))
        res = self._solve_block(tensors, settings, x0 is not None,
                                y0 is not None)
        return tree_map(lambda a: a[:B], res)

    def _follow(self) -> None:
        """The service thread of a rank other than 0: take part in every
        group rank 0 broadcasts, until it broadcasts the stop (None)."""
        device = (torch.device("cuda", torch.cuda.current_device())
                  if self._mesh.device_type == "cuda" else torch.device("cpu"))
        while True:
            header = self._broadcast_header(None)
            if header is None:
                return
            tensors = [torch.empty(shape, dtype=header["dtype"], device=device)
                       for shape in header["shapes"]]
            try:
                self._solve_block(tensors, header["settings"],
                                  *header["warm"])
            except Exception:  # noqa: BLE001 - rank 0 sets it on the Futures
                pass

    def _solve_block(self, tensors, settings: Settings, warm_x: bool,
                     warm_y: bool) -> Result:
        """Every rank: receive the group (rank 0 sends it), solve this
        rank's block, and gather the blocks of every rank.  A rank whose
        solve raised reports it through one all-reduce, so that no rank
        waits for a block that never comes; rank 0 then raises (the
        group's Futures get the error)."""
        g, src = self._group, self._src()
        for t in tensors:
            dist.broadcast(t, src=src, group=g)
        size, rank = dist.get_world_size(g), dist.get_rank(g)
        per = tensors[0].shape[0] // size
        block = [t[rank * per:(rank + 1) * per] for t in tensors]
        problems = Problem(*block[:6])
        x0 = block[6] if warm_x else None
        y0 = block[6 + warm_x] if warm_y else None
        res, error = None, None
        try:
            res = _solve_batch(problems, settings, x0, y0)
        except Exception as e:  # noqa: BLE001 - reported to every rank
            error = e
        failed = torch.tensor([float(error is not None)],
                              device=tensors[0].device)
        dist.all_reduce(failed, op=dist.ReduceOp.MAX, group=g)
        if float(failed) > 0:
            if error is not None:
                raise error
            raise RuntimeError("SolverService: the solve failed on another "
                               "rank of the mesh")

        def gather(a):
            parts = [torch.empty_like(a) for _ in range(size)]
            dist.all_gather(parts, a.contiguous(), group=g)
            return torch.cat(parts)

        return tree_map(gather, res)
