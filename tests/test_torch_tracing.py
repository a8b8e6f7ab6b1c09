"""The port's spans and records of the batched solve
(``qpdo_tpu_torch/utils/profiling.py``) on the CPU.  No JAX.

* Under a profiler, a compacted ``solve_batch`` with stragglers gives the
  span tree solve > chunk > step > residuals, newton, linesearch and
  solve > compact > chunk > step, and one record whose counts equal the
  steps counted by hand.
* With no profiler, the same solve enters no ``record_function``, records
  nothing and returns the same bits.
* The operator's ``profiling.trace(dir)`` turns them on and writes its
  trace file.
"""

import collections
import threading

import numpy as np
import pytest
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.solver import core
from qpdo_tpu_torch.utils import profiling

from torch_threads import one_torch_thread  # noqa: F401  (autouse)

B, K = 8, 2                      # K = max(1, B // 4): the compaction batch


def stragglers(B, n, m, seed):
    """Problems whose Hessians span four decades: they finish at different
    iterations, so a compacted solve of them runs a compaction round."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    scale = np.logspace(-3, 1, B)[:, None, None]
    d = dict(Q=np.einsum("bij,bkj->bik", M, M) / n * scale + 1e-4 * np.eye(n),
             q=rng.standard_normal((B, n)), A=rng.standard_normal((B, m, n)),
             l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))
    return pt.Problem(**{k: torch.as_tensor(v) for k, v in d.items()})


def count_steps(monkeypatch):
    """Count the batch sizes of ``core.step``'s calls, by hand."""
    sizes = collections.Counter()
    step = core.step

    def counted(op, settings, s, out=None):
        sizes[s.x.shape[0]] += 1
        return step(op, settings, s, out)

    monkeypatch.setattr(core, "step", counted)
    return sizes


@pytest.fixture(scope="module")
def profiled():
    """The compacted solve under a CPU profiler: (result, its record, the
    profiler's events, the steps counted by hand)."""
    mp = pytest.MonkeyPatch()
    try:
        sizes = count_steps(mp)
        profiling.clear_records()
        acts = [torch.profiler.ProfilerActivity.CPU]
        with torch.profiler.profile(activities=acts) as prof:
            assert profiling.recording()
            res = pt.solve_batch(stragglers(B, 6, 5, 0), compact=True)
        assert not profiling.recording()
        records = profiling.records()
        profiling.clear_records()
    finally:
        mp.undo()
    return res, records, prof.events(), sizes


def ancestors(event):
    out = []
    while event.cpu_parent is not None:
        event = event.cpu_parent
        out.append(event.name.split(" ")[0])
    return out


def test_profiled_solve_gives_the_span_tree(profiled):
    _, _, events, _ = profiled
    spans = [e for e in events if e.name.startswith("qpdo.")]
    names = collections.Counter(e.name for e in spans)
    assert names[f"qpdo.solve_batch {B}"] == 1
    assert names["qpdo.scale"] == 1 and names["qpdo.finalize"] == 1
    assert names[f"qpdo.step {B}"] > 0 and names[f"qpdo.step {K}"] > 0
    assert names[f"qpdo.compact {K}"] >= 1 and names["qpdo.check"] > 0
    steps = names[f"qpdo.step {B}"] + names[f"qpdo.step {K}"]
    for inner in ("qpdo.residuals", "qpdo.newton", "qpdo.linesearch"):
        assert names[inner] == steps
    for e in spans:
        up = ancestors(e)
        assert e.name.startswith("qpdo.solve_batch") or "qpdo.solve_batch" in up
        if e.name.split(" ")[0] in ("qpdo.residuals", "qpdo.newton",
                                    "qpdo.linesearch"):
            assert up[0] == "qpdo.step"
        if e.name.startswith("qpdo.step"):
            assert up[0] == "qpdo.chunk"
            assert ("qpdo.compact" in up) == (e.name == f"qpdo.step {K}")


def test_profiled_solve_leaves_one_record_of_the_hand_count(profiled):
    res, records, _, sizes = profiled
    assert set(sizes) == {B, K}
    (rec,) = records
    assert (rec.batch, rec.thread) == (B, threading.get_ident())
    assert (rec.steps, rec.compact_steps) == (sizes[B], sizes[K])
    assert (rec.rows, rec.compact_rows) == (sizes[B] * B, sizes[K] * K)
    assert rec.rounds == 1 and rec.checks > 0
    # the CPU has no device seconds
    assert (rec.solve_s, rec.compact_s, rec.newton_s) == (None, None, None)
    assert int(res.info.iterations.sum()) <= rec.rows + rec.compact_rows


def test_unprofiled_solve_enters_no_span_and_gives_the_same_bits(
        profiled, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span or an event with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    profiling.clear_records()
    res = pt.solve_batch(stragglers(B, 6, 5, 0), compact=True)
    assert profiling.records() == []
    want = profiled[0]
    for got, ref in ((res.x, want.x), (res.y, want.y),
                     (res.info.status_val, want.info.status_val),
                     (res.info.iterations, want.info.iterations)):
        assert torch.equal(got, ref)


def test_plain_solve_records_the_full_batch_alone(monkeypatch):
    """Without compaction every step runs the whole batch, and a nested
    ``solve_batch`` (here inside a span of an outer call) counts once."""
    sizes = count_steps(monkeypatch)
    profiling.clear_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("qpdo.solve_batch", B):
            pt.solve_batch(stragglers(B, 6, 5, 1))
    (rec,) = profiling.records()
    profiling.clear_records()
    assert rec.rows == sizes[B] * B and rec.compact_rows == rec.rounds == 0


def test_launch_label_is_the_benchmark_label():
    """``kernels.launch``'s span names its entry, dtype and sizes as the
    benchmark labels a launch: entry, the dtype's short name, ints joined
    by commas."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("qpdo.launch", "kkt_solve_global", torch.float32,
                            (1024, 506, 505)):
            pass
    assert [e.name for e in prof.events()] == [
        "qpdo.launch kkt_solve_global float32 1024,506,505"]


def test_records_are_bounded():
    profiling.clear_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(profiling.MAX_RECORDS + 3):
            with profiling.span("qpdo.solve_batch", i):
                pass
    got = profiling.records()
    profiling.clear_records()
    assert [r.batch for r in got] == list(range(3, profiling.MAX_RECORDS + 3))
    assert profiling.records() == []


def test_trace_context_records_the_solve(tmp_path):
    """``with profiling.trace(dir): solve_batch(...)``, the operator's use,
    records the solve and writes its trace file under ``dir``."""
    profiling.clear_records()
    with profiling.trace(str(tmp_path)):
        assert profiling.recording()
        pt.solve_batch(stragglers(B, 6, 5, 2), compact=True)
    (rec,) = profiling.records()
    profiling.clear_records()
    assert rec.batch == B and rec.rows > 0 and rec.checks > 0
    assert list(tmp_path.glob("*.pt.trace.json"))
