"""One run of one cell: set-up, the measured window, the optional trace,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* the cell's ``config`` is ``configs/<config>.json``, whose ``class``
  names the problem class ``classes/<class>.py`` (its data, its formulation
  for the port and its reference);
* the cell's ``traffic`` is ``traffic/<traffic>.json``, whose ``driver``
  names the loop ``drivers/<driver>.py`` that turns the class's data into
  units of work (such as a fleet solve);
* a per-layer metric ``<name>`` is read by ``metrics/<name>.py``, or, for a
  name split by the end-to-end metric it moves (``<base>.<suffix>``), by
  ``metrics/<base>.py``; a reader returns None where it finds nothing.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import guard, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_module(path: Path):
    """Import the file ``path`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f"h100_bench._found.{path.parent.name}.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """A cell of ``BENCHMARK.json`` with its files."""

    name: str
    entry: dict
    bench: dict
    cfg: dict
    traffic: dict
    here: Path

    @classmethod
    def find(cls, name: str, root: Path = ROOT) -> "Cell":
        bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                             f"there are {sorted(cells)}")
        entry = cells[name]
        here = root / "h100_bench"
        cfg = json.loads((here / "configs" / f"{entry['config']}.json").read_text())
        traffic = json.loads((here / "traffic" / f"{entry['traffic']}.json").read_text())
        return cls(name, entry, bench, cfg, traffic, here)

    def metrics(self, kind: str) -> list:
        """The cell's metrics of ``kind`` ("end_to_end" or "per_layer")."""
        return [m for m in self.bench[kind]
                if self.name in m.get("workloads", [self.name])]

    def module(self, folder: str, name: str):
        return load_module(self.here / folder / f"{name}.py")

    def reader(self, metric: str):
        whole = self.here / "metrics" / f"{metric}.py"
        if whole.exists():
            return load_module(whole)
        return load_module(self.here / "metrics" / f"{metric.split('.', 1)[0]}.py")


@dataclasses.dataclass
class Unit:
    """One unit of work in the window: the answers the check judges."""

    key: object
    x: torch.Tensor
    y: torch.Tensor
    status: torch.Tensor
    iterations: torch.Tensor


class Run:
    """The state of one run, handed to the driver, the class and the
    readers."""

    def __init__(self, cell: Cell, seed: int, device, dtype=torch.float64):
        import qpdo_tpu_torch as pt

        self.pt, self.cell, self.seed = pt, cell, seed
        self.cfg, self.traffic = cell.cfg, cell.traffic
        self.device = torch.device(device)
        self.dtype = dtype
        self.settings = pt.Settings(**cell.cfg["settings"])
        self.cls = cell.module("classes", cell.cfg["class"])
        self.driver = cell.module("drivers", cell.traffic["driver"])
        self.units: list[Unit] = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve(self, problems, x0=None, y0=None):
        """``solve_batch`` of the port (compacted), in the run's dtype,
        waited for."""
        cast = lambda t: None if t is None else t.to(self.dtype)
        with torch.profiler.record_function("h100_bench.solve_batch"):
            res = self.pt.solve_batch(
                self.pt.Problem(*(cast(t) for t in problems)), self.settings,
                cast(x0), cast(y0), compact=True)
        self.sync()
        return res


def check_guard(where: str):
    found = guard.forbidden_modules()
    if found:
        print(f"h100_bench: {where}, the process holds JAX or the JAX "
              f"package: {found}", file=sys.stderr)
        raise SystemExit(3)


def measure(run: Run, seconds: float, traced: bool):
    """Set-up is done; run whole units until ``seconds`` have passed and,
    when ``traced``, the tracer's phases are over (they trace the first
    units).  Returns (window seconds, tracer)."""
    tracer = trace.Tracer(run.device) if traced else None
    tracing = traced
    index = run.driver.FIRST_UNIT
    state = run.state
    start = time.perf_counter()
    ends = []
    if tracing:
        tracer.start()
    while True:
        res, key = run.driver.unit(run, state, index)
        run.units.append(Unit(key, res.x, res.y, res.info.status_val,
                              res.info.iterations))
        ends.append(time.perf_counter() - start)
        index += 1
        if tracing and tracer.done():
            tracing = False
        if not tracing and time.perf_counter() - start >= seconds:
            break
    print("h100_bench: units end at " + " ".join(f"{t:.4f}" for t in ends)
          + " s", file=sys.stderr)
    return ends[-1], tracer


def judge(run: Run):
    """The check: every answer of the window against the reference, after
    the window.  Returns (attempted, failed, checks) with checks
    {name: [number, limit]}."""
    status, rp, rd = run.cls.judge(run.cfg, run.traffic, run.seed, run.device,
                                   run.units, run.state)
    limits = run.cfg["limits"]
    solved = status == run.pt.SOLVED
    ok_p = rp <= limits["prim_res_max"]          # False on NaN
    ok_d = rd <= limits["dual_res_max"]
    failed = int((~(solved & ok_p & ok_d)).sum())
    worst = lambda r: float("nan") if torch.isnan(r).any() else float(r.max())
    checks = {"not_solved": [int((~solved).sum()), limits["not_solved"]],
              "prim_res_max": [worst(rp), limits["prim_res_max"]],
              "dual_res_max": [worst(rd), limits["dual_res_max"]]}
    return int(status.numel()), failed, checks


def passes(checks) -> bool:
    return all(v <= lim for v, lim in checks.values())       # False on NaN


def device_of(run: Run):
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(run.device))}


class ReadContext:
    """What a metric's reader reads: the run, its window's units, the
    window and set-up times, the check's counts and, in a traced run, the
    trace's summary (None without a device trace)."""

    def __init__(self, run: Run, window_s, setup_s, attempted, failed, summary):
        self.run, self.units = run, run.units
        self.window_s, self.setup_s = window_s, setup_s
        self.attempted, self.failed = attempted, failed
        self.trace = summary

    def iterations(self) -> torch.Tensor:
        return torch.cat([u.iterations for u in self.units]).double()


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device,
            t0: float, dtype=torch.float64):
    """One run of ``cell``; returns the result line (a dict), the checks
    and the trace's faults (``trace_faults``; a run with any prints no
    result).  ``t0``: the process's start on ``time.perf_counter``."""
    run = Run(cell, seed, device, dtype)
    if run.device.type == "cuda":
        run.pt.kernels.library()
    run.state = run.driver.setup(run)
    run.sync()
    check_guard("after set-up")
    setup_s = time.perf_counter() - t0
    window_s, tracer = measure(run, seconds, traced)
    check_guard("after the window")
    dev = device_of(run)
    attempted, failed, checks = judge(run)
    correct = failed == 0 and passes(checks)

    device_traced = traced and tracer.cuda
    summary = trace.summarize(tracer) if device_traced else None
    ctx = ReadContext(run, window_s, setup_s, attempted, failed, summary)
    wanted = cell.metrics("per_layer" if traced else "end_to_end")
    metrics = {}
    for m in wanted:
        value = cell.reader(m["name"]).read(ctx, m["name"])
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in summary.device_ops],
            "idle_gaps": [[n, s] for n, s in summary.idle_gaps]}
        print(f"h100_bench: trace: {summary.units} units in the device "
              f"phase, {summary.kernels} kernels, events {summary.event_kinds}, "
              f"launches {sorted(summary.launches.items())}", file=sys.stderr)
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    faults = trace_faults(cell, wanted, metrics, summary) if device_traced else []
    return line, checks, faults


def trace_faults(cell: Cell, wanted, metrics, summary) -> list:
    """What a traced run on the card failed to read: the trace itself, a
    per-layer metric of the cell that read nothing, or a kernel entry of
    the configuration's ``kernel_entries`` (matched by prefix) with no
    launch whose kernels ran on the device in the host phase."""
    if summary is None:
        return ["the trace holds no window"]
    faults = [f"per-layer metric {m['name']} read nothing" for m in wanted
              if m["name"] not in metrics]
    for prefix in cell.cfg.get("kernel_entries", []):
        if not any(entry.startswith(prefix) and seconds > 0
                   for (entry, _, _), (_, seconds) in summary.launches.items()):
            faults.append(f"no launch of kernel entry {prefix}* ran on the device")
    return faults
