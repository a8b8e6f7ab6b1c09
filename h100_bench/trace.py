"""The traced run's profiler and the reading of its trace.

``Tracer`` runs ``torch.profiler`` over whole units at the start of the
window, in two phases of at least ``TRACE_SECONDS`` each:

* ``device``: CUDA activity alone, bracketed by two one-element device
  copies.  The device's busy time (the union of its kernels, copies and
  fills) and the traced window (from the first bracket's start to the
  last's end) come from this phase, and so do the kernels by name and
  their count a unit.  Recording no host ops, it slows the host's issue
  far less than the second phase.
* ``host``: host and device activity, under one span ``h100_bench.window``.
  While it runs, every launch of the port's hand-written kernels
  (``qpdo_tpu_torch.kernels.launch``, the one place the port launches
  them) is wrapped in a span ``h100_bench.launch <entry> <dtype> <sizes>``,
  so that each device kernel can be traced back to the entry and shape
  that launched it (the rooflines), and each idle gap is named by what the
  host was doing.  Recording every host op slows the host's issue, so this
  phase's idle gaps are longer than an untraced run's.

``summarize`` reduces both traces to what the per-layer readers take.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch
from torch.autograd import DeviceType

TRACE_SECONDS = 2.0
WINDOW = "h100_bench.window"
LAUNCH = "h100_bench.launch"
PHASES = ("device", "host")


class Tracer:
    """Profile whole units from the window's start, phase after phase,
    each until ``seconds`` have passed (``done`` after a unit says whether
    every phase is over)."""

    def __init__(self, device, seconds: float = TRACE_SECONDS):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.seconds = seconds
        self.phase = 0
        self.units = dict.fromkeys(PHASES, 0)
        self.profs = {}
        self.mark = torch.zeros(2, device=self.device)

    def start(self):
        name = PHASES[self.phase]
        acts = [torch.profiler.ProfilerActivity.CUDA] if self.cuda else []
        if name == "host" or not self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        prof = self.profs[name] = torch.profiler.profile(activities=acts)
        prof.start()
        if name == "device":
            self._bracket()
        else:
            self.span = torch.profiler.record_function(WINDOW)
            self.span.__enter__()
            self._wrap_launch()
        self.t0 = time.perf_counter()

    def done(self) -> bool:
        """Count one traced unit; end the phase once its units reach
        ``seconds``, and start the next.  True once every phase is over."""
        self.units[PHASES[self.phase]] += 1
        if time.perf_counter() - self.t0 < self.seconds:
            return False
        self.stop()
        self.phase += 1
        if self.phase == len(PHASES):
            return True
        self.start()
        return False

    def stop(self):
        name = PHASES[self.phase]
        if name == "device":
            self._bracket()
        else:
            self._unwrap_launch()
            self.span.__exit__(None, None, None)
        self.profs[name].stop()

    def _bracket(self):
        """A one-element device copy, waited for: the device phase's
        trace starts and ends with one."""
        self.mark[1:].copy_(self.mark[:1])
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _wrap_launch(self):
        from qpdo_tpu_torch import kernels

        self._kernels, self._launch = kernels, kernels.launch
        launch = self._launch

        def spanned(name, dtype, tensors, sizes):
            label = (f"{LAUNCH} {name} {str(dtype).rsplit('.', 1)[-1]} "
                     + ",".join(str(int(s)) for s in sizes))
            with torch.profiler.record_function(label):
                return launch(name, dtype, tensors, sizes)

        kernels.launch = spanned

    def _unwrap_launch(self):
        self._kernels.launch = self._launch


@dataclasses.dataclass
class Summary:
    """What the per-layer readers read from a trace: from the device phase
    the window, the busy time, the units, the kernels and the top device
    ops; from the host phase the idle gaps and the launches."""

    window_s: float
    busy_s: float
    units: int
    kernels: int                       # device kernels launched
    device_ops: list                   # [(name, seconds)], by total time
    idle_gaps: list                    # [(host activity, seconds)]
    # (entry, dtype, sizes tuple) -> [launches, device seconds]
    launches: dict
    event_kinds: dict                  # phase -> {_kind: events}, for the log


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and arguments."""
    name = name.removeprefix("void ")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:width]


def _union(intervals):
    """Merged (start, end) intervals of a sorted list."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def busy_union(intervals, lo, hi):
    """The merged intervals of ``intervals`` clipped to [lo, hi], and
    their total length."""
    clipped = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                     if e > lo and s < hi)
    merged = _union(clipped)
    return merged, sum(e - s for s, e in merged)


def _innermost(spans, points):
    """For each sorted point, the name of the innermost span (start, end,
    name), nested as one thread's are, that contains it; None where none
    does."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _kind(e) -> str:
    """What a trace event is: "device" (a kernel, copy or fill on the
    card), "runtime" (a CUDA runtime or driver call), "host" (an op or a
    span on the host) or "other" (an annotation's device-side copy, the
    profiler's own bookkeeping)."""
    if e.device_type() == DeviceType.CUDA:
        return "other" if e.is_user_annotation() else "device"
    name = e.name()
    if name.startswith("cu"):
        return "runtime"
    return "other" if e.device_index() < 0 else "host"


def _events(prof):
    """(kind counts, device, runtime by correlation id, runtime calls,
    host spans) of a stopped profiler's trace."""
    kinds = collections.Counter()
    device, runtime, calls, host = [], {}, [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        kinds[kind] += 1
        start = e.start_ns()
        end = start + e.duration_ns()
        if kind == "device":
            name = e.name()
            work = "copy" if name.startswith(("Memcpy", "Memset")) else "kernel"
            device.append((start, end, name, work, e.correlation_id()))
        elif kind == "runtime":
            runtime[e.correlation_id()] = (start, e.start_thread_id())
            calls.append((start, end, e.name(), e.start_thread_id()))
        elif kind == "host":
            host.append((start, end, e.name(), e.start_thread_id()))
    return kinds, device, runtime, calls, host


def _device_phase(prof, top):
    """(window, busy, kernels, top ops, kinds): the window runs from the
    start of the trace's first device activity (the opening bracket) to
    the end of its last (the closing one)."""
    kinds, device, *_ = _events(prof)
    if not device:
        return None
    lo = min(d[0] for d in device)
    hi = max(d[1] for d in device)
    _, busy = busy_union([(s, e) for s, e, *_ in device], lo, hi)
    kernels = [d for d in device if d[3] == "kernel"]
    by_name = collections.Counter()
    for s, e, name, _, _ in kernels:
        by_name[short_name(name)] += (e - s) / 1e9
    return ((hi - lo) / 1e9, busy / 1e9, len(kernels), by_name.most_common(top),
            dict(kinds))


def _host_phase(prof, top):
    """(idle gaps, launches, kinds) of the host phase, in its span
    ``WINDOW``; None where it holds none."""
    kinds, device, runtime, calls, host = _events(prof)
    window = [(s, e, t) for s, e, n, t in host if n == WINDOW]
    if not window:
        return None
    lo, hi, thread = window[0]
    host = [h for h in host if h[2] != WINDOW]
    merged, _ = busy_union([(s, e) for s, e, *_ in device], lo, hi)
    kernels = [d for d in device if d[3] == "kernel" and lo <= d[0] < hi]

    # idle gaps inside the window, named by the innermost host span on the
    # window's thread at their middle: a port op, a runtime call, or the
    # benchmark's own span (a launch span by its entry)
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    ours = [(s, e, " ".join(n.split(" ")[:2])) for s, e, n, t in host if t == thread]
    ours += [(s, e, n) for s, e, n, t in calls if t == thread]
    names = _innermost(ours, [(s + e) // 2 for s, e in gaps])
    idle = collections.Counter()
    for (s, e), name in zip(gaps, names):
        idle[name or "host between spans"] += (e - s) / 1e9

    # device time of each kernel entry's launches: a kernel belongs to the
    # launch span that holds the host call that launched it
    spans = sorted((s, e, n) for s, e, n, t in host if n.startswith(LAUNCH))
    starts = [s[0] for s in spans]
    launches = {}
    for s, e, n in spans:
        _, entry, dtype, sizes = n.split(" ")
        key = (entry, dtype, tuple(int(x) for x in sizes.split(",")))
        launches.setdefault(key, [0, 0.0])[0] += 1
    for s, e, name, kind, corr in kernels:
        call = runtime.get(corr)
        if call is None:
            continue
        i = bisect.bisect_right(starts, call[0]) - 1
        if i >= 0 and spans[i][1] >= call[0]:
            _, entry, dtype, sizes = spans[i][2].split(" ")
            key = (entry, dtype, tuple(int(x) for x in sizes.split(",")))
            launches[key][1] += (e - s) / 1e9
    return idle.most_common(top), launches, dict(kinds)


def summarize(tracer: Tracer, top: int = 10) -> Summary | None:
    """Reduce a finished tracer's two traces; None where either holds
    nothing to read."""
    dev = _device_phase(tracer.profs["device"], top)
    host = _host_phase(tracer.profs["host"], top)
    if dev is None or host is None:
        return None
    window_s, busy_s, kernels, device_ops, dev_kinds = dev
    idle_gaps, launches, host_kinds = host
    return Summary(
        window_s=window_s, busy_s=busy_s, units=tracer.units["device"],
        kernels=kernels, device_ops=device_ops, idle_gaps=idle_gaps,
        launches=launches, event_kinds={"device": dev_kinds, "host": host_kinds})
