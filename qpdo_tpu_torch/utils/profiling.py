"""Profiling and timing utilities.

Port of ``qpdo_tpu/utils/profiling.py``, the counterpart of the
reference's PROFILING timers (qpdo_tic/qpdo_toc, src/util.c:181-268):
wall-clock phase timers that wait for the device, plus a
``torch.profiler`` trace context for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict

import torch


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
    trace file (``*.pt.trace.json``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
