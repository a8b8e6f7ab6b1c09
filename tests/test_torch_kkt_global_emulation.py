"""The global-memory route of kernels 3 and 4 (``csrc/kkt_solve_large.cu``:
per panel of 32 rows a panel launch over column ranges and a
trailing-update launch over tile pairs, then the back substitution), from
its CUDA source built with g++ and run on the CPU (the harness of
tests/test_torch_kernel_emulation.py), through its two C entry points.

The shapes are small and ragged but reach every branch: several panels
with a short last one, several column ranges of a panel (56 columns a
block), several trailing tiles (64 x 64) and a ragged edge, one panel
alone.  Each result is held to the plain version within 2e-5 of max|dx|
(phase 6's tolerance), a second call to the same bits, the given K's
lower triangle to go unread, a failed problem to its own problem, and the
workspace (``fused_kkt.global_work_floats``) to its size.  The third entry
point, ``kkt_resolve_global``, substitutes for a new right-hand side on
the factor that ``kkt_solve_global`` left in its workspace: it is held to
the bits of a fresh ``kkt_solve_global`` call with that right-hand side,
to leave the factor's part of the workspace as it found it, and to the
same faults and the same workspace.  Skipped where g++ is missing.
"""

import numpy as np
import pytest
import torch

from qpdo_tpu_torch.ops import fused_kkt as fk
from test_torch_kernel_emulation import _kkt_args, _rel, _scaled, build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-5


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated_global"),
                 ("formation.cu", "kkt_solve_large.cu"))


def _work(B, n, guard=0):
    """A workspace of NaN, with ``guard`` floats of a sentinel past it."""
    work = torch.full((fk.global_work_floats(B, n) + guard,), float("nan"))
    if guard:
        work[-guard:] = 12345.0
    return work


def _kkt(lib, Q, A, w, sigma, rhs, work=None):
    B, m, n = A.shape
    dx = torch.full((B, n), float("nan"))
    work = _work(B, n) if work is None else work
    args = [t.contiguous() for t in (Q, A, w, sigma, rhs)]
    assert lib.qpdo_kkt_solve_global_f32(
        *[t.data_ptr() for t in args], dx.data_ptr(), work.data_ptr(), None,
        B, m, n, 1, None) == 0
    return dx


def _resolve(lib, rhs, work):
    """kkt_resolve_global on the factor in ``work``."""
    B, n = rhs.shape
    dx = torch.full((B, n), float("nan"))
    rhs = rhs.contiguous()
    assert lib.qpdo_kkt_resolve_global_f32(rhs.data_ptr(), dx.data_ptr(),
                                           work.data_ptr(), B, n, None) == 0
    return dx


def _factor_bits(work, B, n):
    """The factor's part of a workspace as bits: K's block (R), and dinv
    and the diagonal of R of every problem."""
    vec = work[B * n * n:fk.global_work_floats(B, n)].view(B, 4, n)
    return [t.clone().view(torch.int32)
            for t in (work[:B * n * n], vec[:, 0], vec[:, 2])]


def _bits_equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _chol(lib, K, rhs, work=None):
    B, n, _ = K.shape
    dx = torch.full((B, n), float("nan"))
    work = _work(B, n) if work is None else work
    K, rhs = K.contiguous(), rhs.contiguous()
    assert lib.qpdo_chol_solve_global_f32(K.data_ptr(), rhs.data_ptr(),
                                          dx.data_ptr(), work.data_ptr(), B,
                                          n, None) == 0
    return dx


@pytest.mark.parametrize("B,m,n", [(1, 105, 70), (3, 150, 100), (2, 30, 20)],
                         ids=["three_panels", "two_column_ranges",
                              "one_panel"])
def test_both_entry_points_match_plain(lib, B, m, n):
    """n = 70: panels of 32, 32 and 6; n = 100: panel 0 has 68 columns
    right of its block (two column ranges) and a trailing matrix of two
    tiles a side; n = 20: one panel, no trailing update."""
    Q, A, w, sigma, rhs = _kkt_args(B, m, n, seed=n)
    dx = _kkt(lib, Q, A, w, sigma, rhs)
    assert _rel(dx, fk.reference_kkt_solve(Q, A, w, sigma, rhs)) <= TOL
    Khat, bhat, dinv = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= TOL
    assert _rel(x * dinv, dx) <= TOL


@pytest.mark.parametrize("B,m,n", [(1, 105, 70), (1, 150, 100), (2, 30, 20),
                                   (1, 40, 161)],
                         ids=["three_panels", "two_column_ranges",
                              "one_panel", "ragged_tiles"])
def test_resolve_gives_the_bits_of_a_fresh_solve(lib, B, m, n):
    """A factor made with one right-hand side, substituted on with
    another: dx, and the whole workspace after it, have the bits of a
    fresh kkt_solve_global call with the second; the factor's part is
    left as it was, bit for bit."""
    Q, A, w, sigma, rhs = _kkt_args(B, m, n, seed=n + 1)
    rhs2 = torch.as_tensor(
        np.random.default_rng(n).standard_normal((B, n)), dtype=torch.float32)
    work = _work(B, n)
    _kkt(lib, Q, A, w, sigma, rhs, work)
    factor = _factor_bits(work, B, n)
    got = _resolve(lib, rhs2, work)
    fresh_work = _work(B, n)
    want = _kkt(lib, Q, A, w, sigma, rhs2, fresh_work)
    assert torch.isfinite(want).all() and _bits_equal(got, want)
    assert all(torch.equal(a, b)
               for a, b in zip(factor, _factor_bits(work, B, n)))
    assert _bits_equal(work, fresh_work)


def test_resolve_keeps_failures_in_their_problem(lib):
    """Problem 0's factor failed (indefinite) and a NaN in problem 1's new
    right-hand side: those two come back non-finite, as a fresh call
    gives them, and problem 2 has the bits of the fresh call."""
    n = 70
    Q, A, w, sigma, rhs = _kkt_args(3, 105, n, seed=2)
    Q = Q.clone()
    Q[0] = -Q[0] - 10.0 * torch.eye(n)
    rhs2 = rhs.flip(1).clone()
    rhs2[1, 3] = float("nan")
    work = _work(3, n)
    _kkt(lib, Q, A, w, sigma, rhs, work)
    got = _resolve(lib, rhs2, work)
    want = _kkt(lib, Q, A, w, sigma, rhs2)
    assert torch.isfinite(got).all(dim=1).tolist() == [False, False, True]
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert _bits_equal(got[2], want[2])


def test_many_column_ranges_and_ragged_tiles(lib):
    """n = 161: panel 0 spreads 129 columns over three column ranges, the
    trailing matrix over three tiles a side with a ragged edge, and the
    last panel holds one row."""
    Q, A, w, sigma, rhs = _kkt_args(1, 40, 161, seed=5)
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= TOL


def test_two_calls_give_the_same_bits(lib):
    Q, A, w, sigma, rhs = _kkt_args(3, 105, 70, seed=9)
    assert torch.equal(_kkt(lib, Q, A, w, sigma, rhs),
                       _kkt(lib, Q, A, w, sigma, rhs))
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    assert torch.equal(_chol(lib, Khat, bhat), _chol(lib, Khat, bhat))


def test_only_the_upper_triangle_of_the_given_k_is_read(lib):
    Q, A, w, sigma, rhs = _kkt_args(2, 150, 100, seed=4)
    Khat, bhat, _ = _scaled(Q, A, w, sigma, rhs)
    lower = torch.tril(torch.full_like(Khat, float("nan")), diagonal=-1)
    assert torch.equal(_chol(lib, torch.triu(Khat) + lower, bhat),
                       _chol(lib, Khat, bhat))


def test_failures_stay_in_their_problem(lib):
    """Problem 0 indefinite and a NaN in problem 1's rhs: the kernel and
    the plain version agree on which problems come back non-finite, and
    problem 2 keeps the bits of the clean run."""
    n = 70
    Q, A, w, sigma, rhs = _kkt_args(3, 105, n, seed=2)
    clean = _kkt(lib, Q, A, w, sigma, rhs)
    Kg, bg, _ = _scaled(Q, A, w, sigma, rhs)
    clean4 = _chol(lib, Kg, bg)
    Qb, rb = Q.clone(), rhs.clone()
    Qb[0] = -Qb[0] - 10.0 * torch.eye(n)
    rb[1, 3] = float("nan")
    Kb, bb = Kg.clone(), bg.clone()
    Kb[0] = -Kb[0]
    bb[1, 3] = float("nan")
    for got, want, good in (
            (_kkt(lib, Qb, A, w, sigma, rb),
             fk.reference_kkt_solve(Qb, A, w, sigma, rb), clean),
            (_chol(lib, Kb, bb), fk.reference_chol_solve(Kb, bb), clean4)):
        finite = torch.isfinite(got).all(dim=1)
        assert torch.equal(finite, torch.isfinite(want).all(dim=1))
        assert not finite[1] and finite[2]
        assert torch.equal(got[2], good[2])


def test_the_workspace_is_enough_and_nothing_past_it_is_written(lib):
    B, m, n = 2, 60, 40
    Q, A, w, sigma, rhs = _kkt_args(B, m, n, seed=6)
    work = _work(B, n, guard=4096)
    dx = _kkt(lib, Q, A, w, sigma, rhs, work)
    assert torch.isfinite(dx).all()
    assert (work[-4096:] == 12345.0).all()
    dx = _resolve(lib, 2.0 * rhs, work)       # on the factor left there
    assert torch.isfinite(dx).all()
    assert (work[-4096:] == 12345.0).all()
    assert fk.global_work_floats(B, n) == B * n * (n + 4)
