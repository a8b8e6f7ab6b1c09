"""Profiling and timing utilities.

Port of ``qpdo_tpu/utils/profiling.py``, the counterpart of the
reference's PROFILING timers (qpdo_tic/qpdo_toc, src/util.c:181-268):
wall-clock phase timers that wait for the device, plus a
``torch.profiler`` trace context for kernel-level inspection.

Spans and records of the batched solve.  While a ``torch.profiler``
profile records in this process (``recording``), and only then, the
solver marks its layer boundaries with ``record_function`` ranges named
``qpdo.<layer>`` (then at most a few stable words, such as a batch size):

- ``qpdo.solve_batch <B>``: one ``solve_batch`` call (``parallel/batch.py``);
- ``qpdo.scale``: Ruiz scaling (``solver/scaling.scale_problem``);
- ``qpdo.polish``, ``qpdo.finalize``: a polish of the state, the
  un-scaling (``core.polish_state``, ``core.finalize``);
- ``qpdo.chunk <b>``: one chunk of masked steps of a batch of b, with its
  refresh where one runs;
- ``qpdo.check``: a host read of the active problems, where the host
  waits for the device;
- ``qpdo.compact <K>``: one compaction round: K problems gathered, run to
  the end and scattered back;
- ``qpdo.step <b>``: one step of a batch of b, with its mask;
- ``qpdo.residuals``: the residual block (kernel 2) and its norms;
- ``qpdo.newton``: the Newton solve: the KKT kernel's launches, the
  refinement sweeps, their casts and matvecs;
- ``qpdo.linesearch``: the exact linesearch;
- ``qpdo.launch <entry> <dtype> <sizes>``: one launch of a hand-written
  kernel (``kernels.launch``).

Each top-level ``solve_batch`` call made while recording leaves one
``SolveRecord`` (``records()``): its counts, taken from tensor shapes
alone, and, on a CUDA device, the device seconds of the solve, of its
compaction rounds and of its Newton solves, from CUDA event pairs on the
current stream that are read only by ``records()``.  An event pair times
its span on the device, idle time inside it included: small where the
card is busy (~97% of a fleet solve of n = 505 at B = 1,024 on an H100).

An operator's use::

    with profiling.trace(log_dir):
        res = solve_batch(problems, settings, compact=True)
    print(profiling.records()[-1])

With no profiler recording, a span site costs one flag check: no
``record_function`` is entered, no event recorded and nothing read back
from the device, so results and launches are those of an untraced solve.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _tensors(v)]
    return []


def sync(tree) -> None:
    """Wait until the work that produces the tensors of ``tree`` (a tensor
    or nested tuples of them) is done: ``torch.cuda.synchronize`` on each
    CUDA device that holds one."""
    for index in sorted({t.get_device() for t in _tensors(tree)
                         if t.is_cuda}):
        torch.cuda.synchronize(index)


@dataclass
class PhaseTimer:
    """Accumulating named phase timers (seconds)."""

    times: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str, tree=None):
        """Time the block; with ``tree``, the clock stops only once the
        device has produced its tensors (``sync``)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if tree is not None:
                sync(tree)
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return dict(sorted(self.times.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and CUDA where a
    device is present), written to ``log_dir`` as a Chrome/TensorBoard
    trace file (``*.pt.trace.json``).  The solver's spans and records are
    on while it runs."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


# ---------------------------------------------------------------------------
# Spans and records of the batched solve
# ---------------------------------------------------------------------------

MAX_RECORDS = 256          # the oldest records go first beyond this
_TIMED = ("qpdo.solve_batch", "qpdo.compact", "qpdo.newton")


@dataclass
class SolveRecord:
    """One top-level ``solve_batch`` call made while a profiler recorded.

    ``steps``/``rows``: masked steps and the rows they stepped (the sum of
    each step's batch size) in the full-batch phase; ``compact_steps``/
    ``compact_rows`` the same inside compaction rounds; ``rounds`` the
    compaction rounds; ``checks`` the host reads of the active count.
    ``solve_s``, ``compact_s``, ``newton_s``: device seconds of the solve,
    of its compaction rounds and of its Newton solves, summed (None off a
    CUDA device)."""

    batch: int
    thread: int
    steps: int = 0
    rows: int = 0
    compact_steps: int = 0
    compact_rows: int = 0
    rounds: int = 0
    checks: int = 0
    solve_s: Optional[float] = None
    compact_s: Optional[float] = None
    newton_s: Optional[float] = None
    # span name -> [(start, end) CUDA events], until records() reads them
    _events: Optional[dict] = field(default=None, repr=False)
    _compacting: int = field(default=0, repr=False)


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_current = threading.local()        # .record: the open SolveRecord


def recording() -> bool:
    """Whether a ``torch.profiler`` profile records in this process (the
    solver's spans and records are on exactly then)."""
    return _autograd_profiler._is_profiler_enabled


def _word(w) -> str:
    if isinstance(w, torch.dtype):
        return str(w).rsplit(".", 1)[-1]
    if isinstance(w, (tuple, list)):
        return ",".join(str(int(s)) for s in w)
    return str(w)


class _Span:
    """A ``record_function`` range that keeps the counts of the open
    record and, for the spans of ``_TIMED`` on a CUDA device, its event
    pairs."""

    __slots__ = ("name", "label", "size", "device", "rec", "owner", "fn",
                 "start")

    def __init__(self, name, words, device):
        self.name, self.device = name, device
        self.size = int(words[0]) if words and isinstance(words[0], int) else 0
        self.label = " ".join((name, *map(_word, words)))
        self.owner, self.start = False, None

    def __enter__(self):
        self.fn = torch.profiler.record_function(self.label)
        self.fn.__enter__()
        rec = getattr(_current, "record", None)
        if self.name == "qpdo.solve_batch":
            if rec is not None:          # a nested call counts once
                rec = None
            else:
                rec = SolveRecord(batch=self.size,
                                  thread=threading.get_ident())
                if self.device is not None and self.device.type == "cuda":
                    rec._events = {name: [] for name in _TIMED}
                _current.record, self.owner = rec, True
        self.rec = rec
        if rec is None:
            return self
        if self.name == "qpdo.step":
            if rec._compacting:
                rec.compact_steps += 1
                rec.compact_rows += self.size
            else:
                rec.steps += 1
                rec.rows += self.size
        elif self.name == "qpdo.compact":
            rec.rounds += 1
            rec._compacting += 1
        elif self.name == "qpdo.check":
            rec.checks += 1
        if rec._events is not None and self.name in _TIMED:
            # the record's solve runs on a CUDA device, and so do its parts
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if self.start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                rec._events[self.name].append((self.start, end))
            if self.name == "qpdo.compact":
                rec._compacting -= 1
            if self.owner:
                _current.record = None
                if exc[0] is None:
                    _records.append(rec)
        return self.fn.__exit__(*exc)


_OFF = contextlib.nullcontext()


def span(name: str, *words, device=None):
    """The span ``name`` followed by ``words`` (a dtype by its short name,
    a sequence of ints joined by commas) while ``recording``; a context
    that does nothing otherwise.  ``device``: the device whose current
    stream takes the event pair of a timed span."""
    if not recording():
        return _OFF
    return _Span(name, words, device)


def spanned(name: str):
    """Run the decorated function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return wrap


_lock = threading.Lock()


def _settle(rec: SolveRecord) -> None:
    """Turn the record's event pairs into device seconds, once."""
    if rec._events is None:
        return
    seconds = {}
    for name, pairs in rec._events.items():
        for _, end in pairs:
            end.synchronize()
        seconds[name] = sum(s.elapsed_time(e) for s, e in pairs) / 1e3
    rec.solve_s, rec.compact_s, rec.newton_s = (seconds[n] for n in _TIMED)
    rec._events = None


def records() -> List[SolveRecord]:
    """The records of the top-level ``solve_batch`` calls made while a
    profiler recorded, oldest first (at most ``MAX_RECORDS``).  Waits for
    the device where a record still holds unread events."""
    with _lock:
        out = list(_records)
        for rec in out:
            _settle(rec)
    return out


def clear_records() -> None:
    """Forget every record."""
    with _lock:
        _records.clear()
