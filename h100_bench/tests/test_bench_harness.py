"""CPU tests of the benchmark's harness at tiny sizes (the cells' classes,
drivers and checks on the port's plain CPU versions), and one card test.

    python -m pytest h100_bench/tests -q
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from h100_bench import guard, harness, trace, work
from h100_bench.classes import portfolio

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
# tiny stand-ins for the configurations' sizes and the traffic's batch
TINY = {"osqp_portfolio_k5": {"assets": 10, "factors": 2, "n": 12, "m": 13}}
BATCH = 4


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cell(name: str, root: Path = ROOT) -> harness.Cell:
    cell = harness.Cell.find(name, root)
    cell.cfg.update(TINY[cell.entry["config"]])
    cell.traffic["batch"] = BATCH
    return cell


def cfg_of(name):
    cfg = json.loads((ROOT / "h100_bench" / "configs" / f"{name}.json").read_text())
    cfg.update(TINY[name])
    return cfg


def traffic_of(name):
    traffic = json.loads((ROOT / "h100_bench" / "traffic" / f"{name}.json").read_text())
    traffic["batch"] = BATCH
    return traffic


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 11])
def test_traffic_is_seeded(seed):
    """The same seed and fleet give the same inputs; another seed or
    another fleet of the run gives other problems."""
    cfg, traffic = cfg_of("osqp_portfolio_k5"), traffic_of("cold_b1024")
    a = portfolio.make(cfg, traffic, seed, 3, "cpu")
    b = portfolio.make(cfg, traffic, seed, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (portfolio.make(cfg, traffic, seed + 1, 3, "cpu"),
                  portfolio.make(cfg, traffic, seed, 4, "cpu")):
        assert not torch.equal(a[1], other[1]) and not torch.equal(a[2], other[2])


def test_work_at_the_bench_shape():
    """PERF.md's bytes at the bench shape (256, 150, 100): kernel 1 in
    float32 35.99 MB, kernel 3 25.96 MB."""
    elems, _ = work.formation_work(256, 150, 100)
    assert round(elems * 4 / 1e6, 2) == 35.99
    elems, flops = work.kkt_work("kkt_solve", 256, 150, 100)
    assert round(elems * 4 / 1e6, 2) == 25.96
    assert flops == 256 * (150 * 100 * 101 + 100 ** 3 // 3 + 4 * 100 ** 2)
    bound = work.launch_bound_s("kkt_solve", "float32", (256, 150, 100))
    assert bound == max(elems * 4 / work.PEAK_BYTES, flops / work.PEAK_F32_ACCURATE)
    assert work.launch_bound_s("residuals", "float64", (1, 2, 3)) is None


def test_idle_share_union():
    intervals = [(10, 20), (15, 30), (40, 50), (45, 46), (90, 120), (0, 5), (6, 12)]
    merged, busy = trace.busy_union(intervals, 8, 100)
    assert merged == [[8, 30], [40, 50], [90, 100]]
    assert busy == 22 + 10 + 10
    names = trace._innermost([(0, 100, "outer"), (10, 20, "inner"), (30, 40, "b")],
                             [5, 15, 25, 35, 150])
    assert names == ["outer", "inner", "outer", "b", None]


def test_forbidden_modules_by_whole_name():
    assert guard.forbidden_modules(["qpdo_tpu_torch", "qpdo_tpu_torch.ops.linalg",
                                    "jaxtyping", "torch"]) == []
    assert guard.forbidden_modules(["qpdo_tpu", "qpdo_tpu.solver"]) == [
        "qpdo_tpu", "qpdo_tpu.solver"]
    assert guard.forbidden_modules(["jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib"]


def test_reference_matches_the_dense_qp():
    """The class's reference residuals (from the factors) equal the dense
    QP's, as the port is handed it."""
    def dense(Q, q, A, l, u, x, y):
        Ax = (A @ x[..., None])[..., 0]
        rp = (Ax - torch.clamp(Ax + y, l, u)).abs().amax(1)
        rd = ((Q @ x[..., None])[..., 0] + q + (A.mT @ y[..., None])[..., 0]).abs().amax(1)
        return rp, rd

    g = torch.Generator().manual_seed(3)
    cfg, traffic = cfg_of("osqp_portfolio_k5"), traffic_of("cold_b1024")
    Q, q, A, l, u, _ = portfolio.make(cfg, traffic, 5, 1, "cpu")
    x = torch.rand(BATCH, 12, generator=g, dtype=torch.float64)
    y = torch.randn(BATCH, 13, generator=g, dtype=torch.float64)
    F, D, mu = portfolio.factors(cfg, traffic, 5, 1, "cpu")
    for got, want in zip(portfolio.residuals(cfg, F, D, mu, x, y), dense(Q, q, A, l, u, x, y)):
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    """A traced and an untraced run on the CPU: the line's keys, the
    cell's metrics, and the checks last."""
    for traced in (False, True):
        line, checks, faults = harness.execute(tiny_cell(cell), 11, 0.3, traced,
                                               "cpu", time.perf_counter())
        assert faults == []
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0, checks
        assert line["attempted"] % BATCH == 0 and line["attempted"] > 0
        names = {m["name"] for m in tiny_cell(cell).metrics(
            "per_layer" if traced else "end_to_end")}
        if traced:       # no device trace on the CPU: the solver's count only
            assert set(line["metrics"]) == {n for n in names if n.startswith("iters_per_qp")}
        else:
            assert set(line["metrics"]) == names


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_fail_the_check(cell, fault, monkeypatch):
    """The timed path broken underneath: a step that returns its state
    unchanged (and claims it solved), and one answer altered where the
    solve produces it; the run's ``correct`` comes out false."""
    from qpdo_tpu_torch import SOLVED
    from qpdo_tpu_torch.parallel import batch
    from qpdo_tpu_torch.solver import core

    if fault == "state_unchanged":
        monkeypatch.setattr(core, "step", lambda op, stg, s, out=None: s._replace(
            status=torch.full_like(s.status, SOLVED)))
    else:
        solve = batch._solve_batch_compact

        def altered(*args, **kwargs):
            res = solve(*args, **kwargs)
            x = res.x.clone()
            x[-1, 0] += 1e-3
            return res._replace(x=x)

        monkeypatch.setattr(batch, "_solve_batch_compact", altered)
    line, checks, _ = harness.execute(tiny_cell(cell), 13, 0.2, False, "cpu",
                                      time.perf_counter())
    assert line["correct"] is False and line["failed"] > 0, checks


@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(cell):
    """The control: the program's float32 path on the same inputs fails
    the check that the configuration's float64 passes."""
    readings = {}
    for dtype in (torch.float64, torch.float32):
        run = harness.Run(tiny_cell(cell), 17, "cpu", dtype)
        run.settings = run.settings.replace(max_iter=300)
        run.state = run.driver.setup(run)
        res, key = run.driver.unit(run, run.state, run.driver.FIRST_UNIT)
        run.units.append(harness.Unit(key, res.x, res.y, res.info.status_val,
                                      res.info.iterations))
        readings[dtype] = harness.passes(harness.judge(run)[2])
    assert readings == {torch.float64: True, torch.float32: False}


def add_cell(root: Path, name: str, config: str, traffic: str, moves: dict):
    """Copy the benchmark to ``root`` and enter a cell in its
    BENCHMARK.json, with per-layer metrics named in ``moves`` (metric ->
    end-to-end metric); the cell's files must be under ``root``."""
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": name, "config": config, "traffic": traffic,
                               "chips": 1, "why": "x"})
    if config not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append({"name": config, "source": "x", "reduced": [], "why": "x",
                                 "file": f"h100_bench/configs/{config}.json"})
    names = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for metric, e2e in moves.items():
        for m in (metric, e2e):
            if m in names:
                names[m].setdefault("workloads", []).append(name)
            else:
                entry = {"name": m, "unit": "x", "better": "lower", "source": "host_clock",
                         "workloads": [name]}
                if m == metric:
                    entry.update(source="device_trace", layer="x", moves=e2e)
                    bench["per_layer"].append(entry)
                else:
                    entry["bound"] = 0.05
                    bench["end_to_end"].append(entry)
                names[m] = entry
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.Cell.find(name, root)


@pytest.fixture
def checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "h100_bench", root / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_added_cell_is_found(checkout):
    """A later cell needs only a configuration file, a traffic file and its
    entries in BENCHMARK.json."""
    cfg = json.loads((checkout / "h100_bench/configs/osqp_portfolio_k5.json").read_text())
    cfg.update(name="osqp_portfolio_k3", factors=3, assets=12, n=15, m=16)
    (checkout / "h100_bench/configs/osqp_portfolio_k3.json").write_text(json.dumps(cfg))
    (checkout / "h100_bench/traffic/cold_b3.json").write_text(json.dumps(
        {"driver": "fleet", "batch": 3, "loop": "x"}))
    cell = add_cell(checkout, "portfolio_k3.cold_b3", "osqp_portfolio_k3", "cold_b3",
                    {"iters_per_qp.qps": "qps_per_s"})
    assert cell.here == checkout / "h100_bench"
    line, _, _ = harness.execute(cell, 5, 0.2, False, "cpu", time.perf_counter())
    assert line["correct"] and line["attempted"] % 3 == 0
    assert set(line["metrics"]) == {"qps_per_s", "setup_s"}


def test_trace_faults():
    """A traced run on the card that reads nothing for one of the cell's
    per-layer metrics, or that saw no launch of a kernel entry the
    configuration names, is refused."""
    cell = tiny_cell(CELLS[0])
    wanted = cell.metrics("per_layer")
    full = {m["name"]: {"value": 1.0} for m in wanted}
    launches = {(entry, "float32", (4, 13, 12)): [3, 0.01]
                for entry in cell.cfg["kernel_entries"]}
    summary = trace.Summary(window_s=1.0, busy_s=0.9, units=1, kernels=9,
                            device_ops=[], idle_gaps=[], launches=launches,
                            event_kinds={})
    assert harness.trace_faults(cell, wanted, full, summary) == []
    dropped = dict(full)
    dropped.pop(wanted[0]["name"])
    assert harness.trace_faults(cell, wanted, dropped, summary) == [
        f"per-layer metric {wanted[0]['name']} read nothing"]
    entry = cell.cfg["kernel_entries"][0]
    summary.launches = {k: v for k, v in launches.items() if k[0] != entry}
    assert harness.trace_faults(cell, wanted, full, summary) == [
        f"no launch of kernel entry {entry}* ran on the device"]
    assert harness.trace_faults(cell, wanted, full, None) == ["the trace holds no window"]


def test_no_card_no_result():
    """Without a CUDA device a run fails and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    """Each cell runs on the card, short, and its answers pass the check."""
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell,
                          "--seed", "2147483901", "--seconds", "2", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
