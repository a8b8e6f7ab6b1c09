"""The split-row route of kernel 1 and the global-memory route of kernels 3
and 4, from their CUDA sources built with g++ and run on the CPU (the
harness of tests/test_torch_kernel_emulation.py), and the port's fused KKT
solve at an n above the shared-memory route against the JAX package.

``csrc/formation.cu`` takes the number of row chunks S as an argument, so
these tests force S = 1, 3 and 7 on ragged shapes (the stub runs one
``std::thread`` per CUDA thread: the shapes stay small) and hold K to
``reference_formation`` within 1e-5 (float32) and 1e-12 (float64) of
max|K|, the tolerances of chip_smoke.py's phase 2; the chunks' partial
sums are added in a fixed order, so two calls give the same bits.
``csrc/kkt_solve_large.cu`` is called through its own entry points at
small n, where the wrappers would take the register route, and held to
the plain versions within 2e-5 of max|dx| (phase 6's tolerance).  Skipped
where g++ is missing.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qpdo_tpu.ops import pallas_kkt as jkkt

from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_formation as ff
from qpdo_tpu_torch.ops import fused_kkt as fk
from test_torch_kernel_emulation import (_formation, _formation_args,
                                         _kkt_args, _rel, _scaled, build)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64
FORMATION_TOL = {F32: 1e-5, F64: 1e-12}


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated_routes"),
                 ("formation.cu", "kkt_solve_large.cu"))


def _kkt_global(lib, Q, A, w, sigma, rhs, splits=1):
    """kkt_solve_global on workspaces that start as NaN."""
    B, m, n = A.shape
    dx = torch.full((B, n), float("nan"))
    work = torch.full((B * n * (n + 2),), float("nan"))
    partial = (torch.full((B, splits, n, n), float("nan"))
               if splits > 1 else None)
    args = [t.contiguous() for t in (Q, A, w, sigma, rhs)]
    err = lib.qpdo_kkt_solve_global_f32(
        *[t.data_ptr() for t in args], dx.data_ptr(), work.data_ptr(),
        None if partial is None else partial.data_ptr(), B, m, n, splits,
        None)
    assert err == 0
    return dx


def _chol_global(lib, K, rhs):
    B, n, _ = K.shape
    dx = torch.full((B, n), float("nan"))
    work = torch.full((B * n * (n + 2),), float("nan"))
    K, rhs = K.contiguous(), rhs.contiguous()
    err = lib.qpdo_chol_solve_global_f32(K.data_ptr(), rhs.data_ptr(),
                                         dx.data_ptr(), work.data_ptr(), B, n,
                                         None)
    assert err == 0
    return dx


@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("B,m,n", [(2, 300, 40), (1, 97, 131)])
def test_split_formation_matches_plain(lib, dtype, B, m, n):
    """Every forced S: every entry written (the output and the partial
    sums start as NaN), within the tolerance of max|K|, and the product
    part symmetric (mirrored, not recomputed)."""
    args = _formation_args(B, m, n, dtype, seed=m)
    ref = ff.reference_formation(*args)
    for splits in (1, 3, 7):
        K = _formation(lib, *args, splits=splits)
        assert torch.isfinite(K).all()
        assert _rel(K, ref) <= FORMATION_TOL[dtype]
        P = K - args[2]
        assert _rel(P, P.mT) <= (1e-6 if dtype == F32 else 1e-14)


def test_split_formation_is_deterministic_and_one_chunk_is_unsplit(lib):
    """Two calls give the same bits; a split whose rows fit one chunk is
    the unsplit kernel bit for bit (float64 n > 64 splits on the FP64
    tensor cores, n <= 64 on the SIMT route)."""
    for shape in ((2, 300, 40), (1, 97, 131)):     # SIMT and tensor cores
        args = _formation_args(*shape, F64, seed=7)
        first = _formation(lib, *args, splits=3)
        assert torch.equal(first, _formation(lib, *args, splits=3))
    short = _formation_args(2, 30, 40, F64, seed=8)      # one chunk of rows
    assert torch.equal(_formation(lib, *short, splits=5),
                       _formation(lib, *short, splits=1))


def test_formation_splits_follow_the_shape_and_the_sm_count():
    """S = 1 at the bench shape and wherever the unsplit grid fills the
    SMs or m is short; at the row-sharded shapes one wave of blocks (3
    tile pairs x 44 chunks on 132 SMs), each chunk holding rows."""
    sms = 132
    assert ff.formation_splits(256, 150, 100, sms) == 1
    assert ff.formation_splits(1, 150, 100, sms) == 1          # m too short
    assert ff.formation_splits(64, 450, 300, sms) == 1          # 384 blocks
    assert ff.formation_splits(8, 768, 512, sms) == 1           # 80 blocks
    assert ff.formation_splits(1, 768, 512, sms) == 3           # m // 256
    assert ff.tile_pairs(200) == 3
    for m in (50_000, 100_000, 100_001):
        assert ff.formation_splits(1, m, 200, sms) == 44
    assert ff.formation_splits(1, 50_000, 200, 2) == 1          # 3 blocks >= 2


def test_kernel_route_follows_n():
    assert [fk.kernel_route("kkt_solve", n) for n in (1, 128, 129, 220, 221)] \
        == ["register", "register", "shared", "shared", "global"]
    assert [fk.kernel_route("chol_solve", n) for n in (239, 240, 512)] \
        == ["shared", "global", "global"]
    assert kernels.SHARED_MAX_N == {"kkt_solve": 220, "chol_solve": 239}


@pytest.mark.parametrize("B,m,n,splits", [(2, 30, 40, 1), (1, 100, 100, 3)])
def test_global_route_matches_plain(lib, B, m, n, splits):
    """Both entry points of the global route against the plain versions
    (n = 100: panels of 32 with a ragged last one, trailing updates over
    several tiles; the fused solve's K from kernel 1 with its rows split),
    the composition against the fused solve, and the same bits twice."""
    Q, A, w, sigma, rhs = _kkt_args(B, m, n)
    dx = _kkt_global(lib, Q, A, w, sigma, rhs, splits)
    assert _rel(dx, fk.reference_kkt_solve(Q, A, w, sigma, rhs)) <= 2e-5
    Khat, bhat, dinv = _scaled(Q, A, w, sigma, rhs)
    x = _chol_global(lib, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= 2e-5
    assert _rel(x * dinv, dx) <= 2e-5
    assert torch.equal(dx, _kkt_global(lib, Q, A, w, sigma, rhs, splits))
    # only the upper triangle of the given K is read
    lower = torch.tril(torch.full_like(Khat, float("nan")), diagonal=-1)
    assert torch.equal(x, _chol_global(lib, torch.triu(Khat) + lower, bhat))


def test_global_route_keeps_failures_in_their_problem(lib):
    """An indefinite problem and a NaN in rhs: the global route and the
    plain version agree on which problems come back non-finite; the rest
    is untouched."""
    n = 40
    Q, A, w, sigma, rhs = _kkt_args(4, 45, n)
    good = _kkt_global(lib, Q, A, w, sigma, rhs)
    Kg, bg, _ = _scaled(Q, A, w, sigma, rhs)
    good4 = _chol_global(lib, Kg, bg)
    Qb, rb = Q.clone(), rhs.clone()
    Qb[1] = -Qb[1] - 10.0 * torch.eye(n)                 # indefinite
    rb[2, 3] = float("nan")
    bad = _kkt_global(lib, Qb, A, w, sigma, rb)
    bad_ref = fk.reference_kkt_solve(Qb, A, w, sigma, rb)
    Kb, bb = Kg.clone(), bg.clone()
    Kb[1] = -Kb[1]
    bb[2, 3] = float("nan")
    bad4 = _chol_global(lib, Kb, bb)
    bad4_ref = fk.reference_chol_solve(Kb, bb)
    for got, want, clean in ((bad, bad_ref, good), (bad4, bad4_ref, good4)):
        finite = torch.isfinite(got).all(dim=1)
        assert torch.equal(finite, torch.isfinite(want).all(dim=1))
        assert not finite[2] and finite[0] and finite[3]
        assert torch.equal(got[[0, 3]], clean[[0, 3]])
        ok = finite.nonzero().flatten()
        assert _rel(got[ok], want[ok]) <= 2e-5


def test_fused_kkt_solve_above_the_shared_route_matches_jax():
    """n = 230 (the card's global route; the JAX package pads it to 256):
    one Newton system through the port's fused_kkt_solve on the CPU and
    through the JAX package's Pallas kernel in interpret mode, within 5e-6
    relative to max(1, max|dx|), as tests/test_torch_kkt.py holds the
    kernel's own shape; both within 5e-5 of a float64 dense solve, its
    bound for the padded shapes (float32 at cond(K) ~ 1e3)."""
    B, n, m = 2, 230, 345
    rng = np.random.default_rng(n)
    M = rng.standard_normal((B, n, n)).astype(np.float32)
    args = ((np.einsum("bij,bkj->bik", M, M) / n
             + 0.1 * np.eye(n)).astype(np.float32),
            rng.standard_normal((B, m, n)).astype(np.float32),
            (rng.random((B, m)) * 10.0).astype(np.float32),
            np.full(B, 1e-3, np.float32),
            rng.standard_normal((B, n)).astype(np.float32))
    assert fk.kernel_route("kkt_solve", n) == "global"
    dx = fk.fused_kkt_solve(*[torch.from_numpy(a) for a in args]).numpy()
    jdx = np.asarray(jkkt.fused_kkt_solve(*[jnp.asarray(a) for a in args],
                                          interpret=True))
    Q, A, w, sigma, rhs = (a.astype(np.float64) for a in args)
    K = Q + sigma[:, None, None] * np.eye(n) + np.einsum(
        "bki,bk,bkj->bij", A, w, A)
    exact = np.linalg.solve(K, rhs[..., None])[..., 0]

    def err(a, b):
        return np.abs(a - b).max() / max(1.0, np.abs(b).max())

    assert dx.shape == (B, n) and jdx.shape == (B, n)
    assert err(dx, jdx) <= 5e-6
    assert err(dx, exact) <= 5e-5 and err(jdx, exact) <= 5e-5
