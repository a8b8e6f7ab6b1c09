"""The port's spans and records of the batched solve on the card (marker
``cuda``): on under a profiler of CUDA activity alone, with device seconds
from CUDA events, and no extra launch.

These tests need an NVIDIA GPU and nvcc and skip elsewhere.  They import
no JAX, so they also run without the suite's conftest:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda_tracing.py
"""

import numpy as np
import pytest
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.ops import fused_kkt as fk
from qpdo_tpu_torch.ops import fused_residuals as fr
from qpdo_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda
B = 64


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def stragglers(B, n, m, seed, device):
    """Problems whose Hessians span four decades, so that a compacted
    solve of them runs a compaction round."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    scale = np.logspace(-3, 1, B)[:, None, None]
    d = dict(Q=np.einsum("bij,bkj->bik", M, M) / n * scale + 1e-4 * np.eye(n),
             q=rng.standard_normal((B, n)), A=rng.standard_normal((B, m, n)),
             l=-rng.random((B, m)), u=rng.random((B, m)), c=np.zeros(B))
    return pt.Problem(**{k: torch.as_tensor(v, device=device) for k, v in d.items()})


def launches():
    return (sum(fr.fused_residuals.launches.values()),
            sum(fk.fused_kkt_solve.launches.values()))


def test_cuda_only_profiler_fills_a_record(device):
    """Under ``activities=[CUDA]`` alone (the benchmark's device phase) a
    compacted solve leaves one record with positive device seconds, its
    compaction rounds and Newton solves inside the solve's, and makes the
    launches and iterations of the same solve untraced."""
    problems = stragglers(B, 40, 30, 0, device)
    settings = pt.Settings(kkt_dtype="float32", pallas_kkt=True)
    pt.solve_batch(problems, settings, compact=True)          # warm-up
    torch.cuda.synchronize()
    before = launches()
    plain = pt.solve_batch(problems, settings, compact=True)
    torch.cuda.synchronize()
    untraced = [a - b for a, b in zip(launches(), before)]

    profiling.clear_records()
    before = launches()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert profiling.recording()
        res = pt.solve_batch(problems, settings, compact=True)
    traced = [a - b for a, b in zip(launches(), before)]
    (rec,) = profiling.records()
    profiling.clear_records()
    assert traced == untraced and untraced[1] > 0
    assert torch.equal(res.info.iterations, plain.info.iterations)
    assert torch.equal(res.info.status_val, plain.info.status_val)
    assert rec.batch == B and rec.rows > 0 and rec.compact_rows > 0
    assert rec.rounds >= 1
    assert rec.solve_s > 0 and rec.compact_s > 0 and rec.newton_s > 0
    assert rec.compact_s <= rec.solve_s and rec.newton_s <= rec.solve_s
