"""The cluster route of kernels 3 and 4 (``csrc/kkt_solve_cluster.cu``: one
thread-block cluster a problem, K's panels in the blocks' shared memory,
the factor and both substitutions in one launch), from its CUDA source
built with g++ and run on the CPU (the harness of
tests/test_torch_kernel_emulation.py; the stand-in runtime runs the blocks
of one cluster at once, with a cluster barrier and each block's view of
its peers' shared memory), through its two C entry points.

The cluster size is the entry points' argument: clusters of 2 and 4 blocks
reach every branch at small n (a short last panel padded with identity
rows, more panels than blocks so that a block holds two or four, a panel
whose owner is also the owner of the next one).  Each result is held to
the plain version within 2e-5 of max|dx| (phase 6's tolerance), a second
call to the same bits, the given K's lower triangle to go unread, a
failed problem to its own problem, the workspace
(``qpdo_cluster_work_floats``) to its size and to 16-byte alignment (the
panel buffer is read in pairs of floats: K's share of the fused solve's
workspace is rounded up, B n^2 odd included); the cluster sizes the source
gives n, and the route's limit in B.  Skipped where g++ is missing (but
the last).
"""

import ctypes

import pytest
import torch

from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_kkt as fk
from test_torch_kernel_emulation import (_kkt_args, _rel, _scaled, build,
                                         card_clusters)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("emulated_cluster"),
                ("formation.cu", "kkt_solve_cluster.cu"))
    lib.qpdo_kkt_cluster_size.argtypes = [ctypes.c_int]
    lib.qpdo_kkt_cluster_size.restype = ctypes.c_int
    lib.qpdo_cluster_work_floats.argtypes = [ctypes.c_int] * 3
    lib.qpdo_cluster_work_floats.restype = ctypes.c_longlong
    return lib


@pytest.fixture(autouse=True)
def emulated_library(request, monkeypatch):
    """``kernels.library()`` is the emulated build, so that
    ``fused_kkt.cluster_work_floats`` asks the source built here."""
    if "lib" in request.fixturenames:
        monkeypatch.setattr(kernels, "library",
                            lambda: request.getfixturevalue("lib"))


def _work(name, B, n, guard=0):
    """A workspace of NaN, with ``guard`` floats of a sentinel past it."""
    work = torch.full((fk.cluster_work_floats(name, B, n) + guard,),
                      float("nan"))
    if guard:
        work[-guard:] = 12345.0
    return work


def _kkt(lib, cluster, Q, A, w, sigma, rhs, work=None):
    B, m, n = A.shape
    dx = torch.full((B, n), float("nan"))
    work = _work("kkt_solve", B, n) if work is None else work
    args = [t.contiguous() for t in (Q, A, w, sigma, rhs)]
    assert work.data_ptr() % 16 == 0
    assert lib.qpdo_kkt_solve_cluster_f32(
        *[t.data_ptr() for t in args], dx.data_ptr(), work.data_ptr(), None,
        B, m, n, 1, cluster, None) == 0
    return dx


def _chol(lib, cluster, K, rhs, work=None):
    B, n, _ = K.shape
    dx = torch.full((B, n), float("nan"))
    work = _work("chol_solve", B, n) if work is None else work
    K, rhs = K.contiguous(), rhs.contiguous()
    assert lib.qpdo_chol_solve_cluster_f32(K.data_ptr(), rhs.data_ptr(),
                                           dx.data_ptr(), work.data_ptr(), B,
                                           n, cluster, None) == 0
    return dx


@pytest.mark.parametrize("cluster,B,m,n", [
    (2, 2, 105, 70), (4, 1, 225, 150), (4, 1, 60, 40), (2, 1, 30, 20),
    (2, 1, 107, 71)],
    ids=["c2_three_panels", "c4_five_panels", "c4_fewer_panels_than_blocks",
         "c2_one_panel", "c2_odd_share_of_k"])
def test_both_entry_points_match_plain(lib, cluster, B, m, n):
    """n = 70 on 2 blocks: panels 0, 1, 2 held by blocks 0, 1, 1 (the
    owner of panel 1 factors panel 2 next), the last panel 6 rows of 32;
    n = 150 on 4 blocks: five panels, block 3 holding panels 3 and 4 (back
    and forth), a short last one; n = 40 on 4 blocks: two panels, blocks 2
    and 3 hold none; n = 20: one panel; n = 71 for one problem: K's
    5,041 floats padded so that the panel buffer stays aligned (the entry
    point refuses it otherwise)."""
    Q, A, w, sigma, rhs = _kkt_args(B, m, n, seed=n)
    dx = _kkt(lib, cluster, Q, A, w, sigma, rhs)
    assert _rel(dx, fk.reference_kkt_solve(Q, A, w, sigma, rhs)) <= TOL
    Khat, bhat, dinv = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, cluster, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= TOL
    assert _rel(x * dinv, dx) <= TOL


def test_more_panels_than_twice_the_blocks(lib):
    """n = 161 on 2 blocks: six panels, each block holding three (0, 3, 4
    and 1, 2, 5), the last panel one row."""
    Q, A, w, sigma, rhs = _kkt_args(1, 40, 161, seed=5)
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, 2, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= TOL


def test_two_calls_give_the_same_bits(lib):
    Q, A, w, sigma, rhs = _kkt_args(1, 105, 70, seed=9)
    assert torch.equal(_kkt(lib, 4, Q, A, w, sigma, rhs),
                       _kkt(lib, 4, Q, A, w, sigma, rhs))
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    assert torch.equal(_chol(lib, 2, Khat, bhat), _chol(lib, 2, Khat, bhat))


def test_only_the_upper_triangle_of_the_given_k_is_read(lib):
    Q, A, w, sigma, rhs = _kkt_args(2, 150, 100, seed=4)
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    lower = torch.tril(torch.full_like(Khat, float("nan")), diagonal=-1)
    assert torch.equal(_chol(lib, 2, torch.triu(Khat) + lower, bhat),
                       _chol(lib, 2, Khat, bhat))


def test_failures_stay_in_their_problem(lib):
    """Problem 0 indefinite and a NaN in problem 1's rhs: the kernel and
    the plain version agree on which problems come back non-finite, and
    problem 2 keeps the bits of the clean run."""
    n = 40
    Q, A, w, sigma, rhs = _kkt_args(3, 60, n, seed=2)
    clean = _kkt(lib, 2, Q, A, w, sigma, rhs)
    Kg, bg, _ = _scaled(Q, A, w, sigma, rhs)
    clean4 = _chol(lib, 2, Kg, bg)
    Qb, rb = Q.clone(), rhs.clone()
    Qb[0] = -Qb[0] - 10.0 * torch.eye(n)
    rb[1, 3] = float("nan")
    Kb, bb = Kg.clone(), bg.clone()
    Kb[0] = -Kb[0]
    bb[1, 3] = float("nan")
    for got, want, good in (
            (_kkt(lib, 2, Qb, A, w, sigma, rb),
             fk.reference_kkt_solve(Qb, A, w, sigma, rb), clean),
            (_chol(lib, 2, Kb, bb), fk.reference_chol_solve(Kb, bb), clean4)):
        finite = torch.isfinite(got).all(dim=1)
        assert torch.equal(finite, torch.isfinite(want).all(dim=1))
        assert not finite[1] and finite[2]
        assert torch.equal(got[2], good[2])


def test_the_workspace_is_enough_and_nothing_past_it_is_written(lib):
    """The workspace's size and alignment, and the cluster sizes the source
    gives n: 8 blocks up to n = 832, 16 up to 1,184 (227 KB of shared
    memory a block, 4 panels a block at most), none above, as the route's
    stand-in card (``card_clusters``) assumes."""
    sizes = [lib.qpdo_kkt_cluster_size(n) for n in range(221, 1401)]
    assert sizes == [8] * (832 - 220) + [16] * (1184 - 832) + [0] * 216
    B, m, n = 2, 60, 40
    Q, A, w, sigma, rhs = _kkt_args(B, m, n, seed=6)
    work = _work("kkt_solve", B, n, guard=4096)
    dx = _kkt(lib, 2, Q, A, w, sigma, rhs, work)
    assert torch.isfinite(dx).all()
    assert (work[-4096:] == 12345.0).all()
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    work = _work("chol_solve", B, n, guard=4096)
    assert torch.isfinite(_chol(lib, 2, Khat, bhat, work)).all()
    assert (work[-4096:] == 12345.0).all()
    assert fk.cluster_work_floats("kkt_solve", B, n) \
        == B * n * n + fk.cluster_work_floats("chol_solve", B, n)
    # K's share rounded up to 4 floats: 1 * 71^2 = 5,041 -> 5,044
    assert fk.cluster_work_floats("kkt_solve", 1, 71) \
        == 5044 + fk.cluster_work_floats("chol_solve", 1, 71)
    # a workspace off 16 bytes is refused, and nothing is written
    Q, A, w, sigma, rhs = _kkt_args(1, 30, 20, seed=6)
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    for name in ("kkt_solve", "chol_solve"):
        buf = _work(name, 1, 20, guard=4)
        dx = torch.full((1, 20), float("nan"))
        off = buf[1:]
        assert off.data_ptr() % 16 == 4
        if name == "kkt_solve":
            args = [t.contiguous() for t in (Q, A, w, sigma, rhs)]
            err = lib.qpdo_kkt_solve_cluster_f32(
                *[t.data_ptr() for t in args], dx.data_ptr(), off.data_ptr(),
                None, 1, 30, 20, 1, 2, None)
        else:
            err = lib.qpdo_chol_solve_cluster_f32(
                Khat.data_ptr(), bhat.data_ptr(), dx.data_ptr(),
                off.data_ptr(), 1, 20, 2, None)
        assert err != 0 and torch.isnan(dx).all()
        assert torch.isnan(buf[:-4]).all()


def test_the_cluster_route_stops_at_its_batch_limit(monkeypatch):
    """As many problems as the card holds clusters at once take the
    cluster route (a stand-in card: 15 clusters of 8 blocks, 7 of 16), one
    more the global route; the same through ``fused_kkt_kernel_route``."""
    import qpdo_tpu_torch as pt
    from qpdo_tpu_torch.ops.linalg import fused_kkt_kernel_route

    asked = card_clusters(monkeypatch)
    assert fk.kernel_route("kkt_solve", 15, 512) == "cluster"
    assert fk.kernel_route("kkt_solve", 16, 512) == "global"
    assert asked == [512, 512]
    settings = pt.Settings(pallas_kkt=True, kkt_dtype="float32")
    cuda, f64 = torch.device("cuda"), torch.float64
    assert [fused_kkt_kernel_route(settings, b, 1024, cuda, f64)
            for b in (1, 7, 8, 64)] == ["cluster", "cluster", "global",
                                          "global"]
    assert fused_kkt_kernel_route(settings, 1, 1024, torch.device("cpu"),
                                  f64) is None
