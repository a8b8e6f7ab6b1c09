"""The PyTorch port's top-level names against the JAX package's, and the
two rules that decide where ``Settings.pallas_kkt`` sends a Newton solve:
the reference's routing (the fused kernel on the CPU, or on a device in
float32) and the route the fused kernel takes on a CUDA device for n
(registers, shared memory or global memory; any n is solved).  Both rules
are pure functions of settings, sizes, device types and dtypes, so they
run here without a card or a build; tests/test_torch_cuda_layer.py holds
them on the card.
"""

import pytest
import torch

import qpdo_tpu as qt

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops.linalg import fused_kkt_kernel_route, fused_kkt_route
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# The names of ``qpdo_tpu.__all__`` still to be ported: none, since the
# sparse layer and the continuation solver (ROADMAP.md Queue 1 item 4b).
WAITING = set()


def test_every_name_of_the_jax_package_is_exported():
    """Every name of ``qpdo_tpu.__all__`` exists in ``qpdo_tpu_torch`` and
    in its ``__all__``, except the names listed in WAITING; a constant
    has the JAX package's value."""
    assert WAITING <= set(qt.__all__)
    missing = [n for n in qt.__all__
               if n not in WAITING and not hasattr(pt, n)]
    assert missing == []
    assert set(qt.__all__) - WAITING <= set(pt.__all__)
    assert not WAITING & set(pt.__all__)
    for name in qt.__all__:
        if isinstance(getattr(qt, name), (int, float)):
            assert getattr(pt, name) == getattr(qt, name), name


def test_every_name_of_the_jax_parallel_package_is_exported():
    """Every public name of ``qpdo_tpu.parallel`` exists in
    ``qpdo_tpu_torch.parallel`` (the distributed paths, ROADMAP.md Queue 1
    item 6)."""
    import qpdo_tpu.parallel as jp

    import qpdo_tpu_torch.parallel as tp

    names = ["solve_batch", "solve_batch_sharded", "shard_problems",
             "solve_row_sharded", "multihost"]
    assert all(hasattr(jp, n) for n in names)
    assert [n for n in names if not hasattr(tp, n)] == []
    for n in ("initialize", "global_mesh", "distribute_batch"):
        assert hasattr(jp.multihost, n) and hasattr(tp.multihost, n)


@pytest.mark.parametrize("device_type,kkt_dtype,fused", [
    ("cpu", torch.float64, True), ("cuda", torch.float32, True),
    ("cuda", torch.float64, False),
])
def test_fused_kkt_route(device_type, kkt_dtype, fused):
    """The reference's condition (qpdo_tpu/ops/linalg.py:269):
    on_cpu or kdt == float32."""
    assert fused_kkt_route(device_type, kkt_dtype) is fused


LIMIT = kernels.SHARED_MAX_N["kkt_solve"]
F32, F64 = torch.float32, torch.float64
PKKT = pt.Settings(pallas_kkt=True)


@pytest.mark.parametrize("settings,n,device,dtype,route", [
    # the fused kernel on the card in float32: global memory above the
    # shared-memory route's limit (220) for a batch of 64 (above the
    # cluster route's batches), shared memory at it
    (PKKT.replace(kkt_dtype="float32"), LIMIT + 1, "cuda", F64, "global"),
    (PKKT.replace(kkt_dtype="float32"), LIMIT, "cuda:0", F64, "shared"),
    (PKKT, LIMIT + 1, "cuda", F32, "global"),
    # the float32 phase of the hybrid warmup runs the fused kernel too
    (PKKT.replace(hybrid_warmup=True), LIMIT + 1, "cuda", F64, "global"),
    # a float64 KKT dtype on the card takes the chol route: no kernel 3
    (PKKT, LIMIT + 1, "cuda", F64, None),
    # the CPU runs any n through the plain version; no flag, no kernel
    (PKKT.replace(kkt_dtype="float32"), 500, "cpu", F64, None),
    (pt.Settings(kkt_dtype="float32"), 500, "cuda", F64, None),
], ids=["f32", "at_limit", "f32_state", "warmup", "f64", "cpu", "off"])
def test_setup_refuses_a_problem_too_large_for_the_fused_kernel(
        settings, n, device, dtype, route, monkeypatch):
    """No problem is refused any more (the name is kept from when n > 220
    was): each case takes the route of kernel 3 that B = 64 problems of n
    give it (none, register, shared or global) on a card that holds 15
    clusters at once (a stand-in: the CPU has no card to ask)."""
    monkeypatch.setattr(kernels, "max_active_clusters",
                        lambda n, device=None: 15)
    assert fused_kkt_kernel_route(settings, 64, n, torch.device(device),
                                  dtype) == route
