"""The CUDA sources of the PyTorch port, built with g++ and run on the CPU.

``tests/torch_cuda_stub/cuda_runtime.h`` stands in for the CUDA runtime: one
``std::thread`` per CUDA thread, ``__syncthreads`` and the warp shuffles on
``std::barrier``.  ``build`` rewrites the ``<<<...>>>`` launches and the
``extern __shared__`` arrays of the sources it is given, builds them with
``g++ -std=c++20`` into one shared library and binds their C entry points.
This file builds ``formation.cu`` and ``kkt_solve.cu``, calls them on CPU
tensors and holds the results against the plain PyTorch versions: formation
to 1e-5 (float32) and 1e-12 (float64) of max|K|, the two KKT kernels to 2e-5
of max|dx| (the tolerances of chip_smoke.py's phases 2 and 6);
tests/test_torch_residuals_emulation.py builds ``residuals.cu``.  They check
indexing, barriers and arithmetic, not speed; on the card the same sources
are held by tests/test_torch_cuda*.py.  Skipped where g++ is missing.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_formation as ff
from qpdo_tpu_torch.ops import fused_kkt as fk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STUB = Path(__file__).resolve().parent / "torch_cuda_stub"
# the source that holds each kernel's entry points
SOURCE_OF = {"formation": "formation.cu", "residuals": "residuals.cu",
             "kkt_solve": "kkt_solve.cu", "chol_solve": "kkt_solve.cu",
             "kkt_solve_global": "kkt_solve_large.cu",
             "chol_solve_global": "kkt_solve_large.cu"}

_LAUNCH = re.compile(r"(\b[\w:]+(?:<[^<>;]*>)?)<<<([^;]*?)>>>\(([^;]*?)\);", re.S)
_SHARED = re.compile(
    r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];")


def rewrite(text: str) -> str:
    """CUDA launch syntax and dynamic shared arrays as plain C++
    (``cudaLaunchKernelEx`` is the stub's own)."""
    def launch(m):
        grid, block, nbytes, _stream = [p.strip() for p in m.group(2).split(",")]
        return (f"cuda_stub::launch({grid}, {block}, {nbytes}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    text, n = _LAUNCH.subn(launch, text)
    assert n > 0 or "cudaLaunchKernelEx(" in text, "no kernel launch found"
    return _SHARED.sub(r"\1* \2 = reinterpret_cast<\1*>("
                       r"cuda_stub::shared_memory());", text)


def build(tmp: Path, sources) -> ctypes.CDLL:
    """The CUDA ``sources`` built for the CPU into one library in ``tmp``,
    the entry points of their kernels bound as in ``qpdo_tpu_torch.kernels``
    (no contraction into FMAs: the sources round every operation as
    written where they ask for it)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA sources for the CPU")
    files = [str(STUB / "stub_runtime.cpp")]
    for name in sources:
        out = tmp / (Path(name).stem + ".cpp")
        out.write_text(rewrite((kernels.CSRC / name).read_text()))
        files.append(str(out))
    so = tmp / "libqpdo_emulated.so"
    cmd = [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
           "-pthread", f"-I{STUB}", f"-I{kernels.CSRC}", "-o", str(so), *files]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    for name, (pointers, ints, dtypes) in kernels._KERNELS.items():
        if SOURCE_OF[name] in sources:
            for dt in dtypes:
                fn = getattr(lib, f"qpdo_{name}_{kernels._SUFFIX[dt]}")
                fn.argtypes = [ptr] * pointers + [i] * ints + [ptr]
                fn.restype = i
    return lib


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated_kernels"),
                 ("formation.cu", "kkt_solve.cu"))


def _call(lib, name, tensors, out, sizes):
    fn = getattr(lib, f"qpdo_{name}_{kernels._SUFFIX[out.dtype]}")
    args = [None if t is None else t.contiguous() for t in tensors]
    err = fn(*[None if t is None else t.data_ptr() for t in args],
             out.data_ptr(), *sizes, None)
    assert err == 0
    return out


def _formation(lib, A, w, Q, sigma, splits=1):
    """Kernel 1 with its rows split into ``splits`` chunks (1: unsplit);
    the partial sums' workspace starts as NaN, as the output does."""
    B, m, n = A.shape
    K = torch.full((B, n, n), float("nan"), dtype=A.dtype)
    partial = (torch.full((B, splits, n, n), float("nan"), dtype=A.dtype)
               if splits > 1 else None)
    fn = getattr(lib, f"qpdo_formation_{kernels._SUFFIX[A.dtype]}")
    args = [t.contiguous() for t in (A, w, Q, sigma)]
    err = fn(*[t.data_ptr() for t in args], K.data_ptr(),
             None if partial is None else partial.data_ptr(), B, m, n, splits,
             None)
    assert err == 0
    return K


def _kkt(lib, Q, A, w, sigma, rhs):
    B, m, n = A.shape
    return _call(lib, "kkt_solve", (Q, A, w, sigma, rhs),
                 torch.full((B, n), float("nan")), (B, m, n))


def _chol(lib, K, rhs):
    B, n, _ = K.shape
    return _call(lib, "chol_solve", (K, rhs),
                 torch.full((B, n), float("nan")), (B, n))


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _formation_args(B, m, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((B, m, n)), rng.random((B, m)),
              rng.standard_normal((B, n, n)),          # not symmetric
              rng.random(B) * 0.1)
    return [torch.as_tensor(a, dtype=dtype) for a in arrays]


def _kkt_args(B, m, n, seed=3):
    rng = np.random.default_rng(seed)
    Mx = rng.standard_normal((B, n, n))
    arrays = (np.einsum("bij,bkj->bik", Mx, Mx) / n + 0.1 * np.eye(n),
              rng.standard_normal((B, m, n)), rng.random((B, m)),
              np.full(B, 1e-3), rng.standard_normal((B, n)))
    return [torch.as_tensor(a, dtype=torch.float32) for a in arrays]


def _scaled(Q, A, w, sigma, rhs):
    """Jacobi-scaled, shifted matrix and right-hand side: kernel 4's input."""
    K = ff.reference_formation(A, w, Q, sigma)
    dinv = torch.rsqrt(torch.diagonal(K, dim1=-2, dim2=-1))
    Khat = (K * dinv[:, :, None] * dinv[:, None, :]
            + fk._static_reg32() * torch.eye(K.shape[-1]))
    return Khat.contiguous(), rhs * dinv, dinv


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("m,n", [(37, 19), (70, 100)])
def test_formation_source_matches_plain(lib, dtype, tol, m, n):
    """Ragged shapes, a Q that is not symmetric: every entry of K written
    once (the output starts as NaN), each with Q at its own position."""
    args = _formation_args(2, m, n, dtype)
    K = _formation(lib, *args)
    ref = ff.reference_formation(*args)
    assert torch.isfinite(K).all()
    assert ((K - ref).abs().max() / ref.abs().max()).item() <= tol
    # the product part is symmetric exactly: mirrored, not recomputed
    P = K - args[2]
    assert _rel(P, P.mT) <= (1e-6 if dtype == torch.float32 else 1e-14)


def test_formation_source_over_several_tiles_and_without_rows(lib):
    """n above one 128-wide tile (tile pairs, two strips of A), an n that
    is no multiple of the 16-byte copies, and m = 0."""
    for m, n in ((9, 140), (12, 131), (0, 20)):
        args = _formation_args(1, m, n, torch.float32, seed=n)
        K = _formation(lib, *args)
        ref = ff.reference_formation(*args)
        assert torch.isfinite(K).all()
        assert ((K - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("m,n", [(7, 5), (45, 37), (150, 100)])
def test_kkt_sources_match_plain_on_the_register_route(lib, m, n):
    Q, A, w, sigma, rhs = _kkt_args(2, m, n)
    dx = _kkt(lib, Q, A, w, sigma, rhs)
    assert _rel(dx, fk.reference_kkt_solve(Q, A, w, sigma, rhs)) <= 2e-5
    Khat, bhat, dinv = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= 2e-5
    assert _rel(x * dinv, dx) <= 2e-5
    # two calls give the same bits
    assert torch.equal(dx, _kkt(lib, Q, A, w, sigma, rhs))
    assert torch.equal(x, _chol(lib, Khat, bhat))


def test_kkt_sources_match_plain_on_the_shared_memory_route(lib):
    Q, A, w, sigma, rhs = _kkt_args(1, 40, 130)
    dx = _kkt(lib, Q, A, w, sigma, rhs)
    assert _rel(dx, fk.reference_kkt_solve(Q, A, w, sigma, rhs)) <= 2e-5
    Khat, bhat, dinv = _scaled(Q, A, w, sigma, rhs)
    x = _chol(lib, Khat, bhat)
    assert _rel(x, fk.reference_chol_solve(Khat, bhat)) <= 2e-5


def test_kkt_sources_keep_failures_in_their_problem(lib):
    """An indefinite problem and a NaN in rhs: kernel and plain version
    agree on which problems come back non-finite; the rest is untouched."""
    n = 37
    Q, A, w, sigma, rhs = _kkt_args(4, 45, n)
    good = _kkt(lib, Q, A, w, sigma, rhs)
    Kg, bg, _ = _scaled(Q, A, w, sigma, rhs)
    good4 = _chol(lib, Kg, bg)
    Qb, rb = Q.clone(), rhs.clone()
    Qb[1] = -Qb[1] - 10.0 * torch.eye(n)                 # indefinite
    rb[2, 3] = float("nan")
    bad = _kkt(lib, Qb, A, w, sigma, rb)
    bad_ref = fk.reference_kkt_solve(Qb, A, w, sigma, rb)
    Kb, bb = Kg.clone(), bg.clone()
    Kb[1] = -Kb[1]
    bb[2, 3] = float("nan")
    bad4 = _chol(lib, Kb, bb)
    bad4_ref = fk.reference_chol_solve(Kb, bb)
    for got, want, clean in ((bad, bad_ref, good), (bad4, bad4_ref, good4)):
        finite = torch.isfinite(got).all(dim=1)
        assert torch.equal(finite, torch.isfinite(want).all(dim=1))
        assert not finite[2] and finite[0] and finite[3]
        assert torch.equal(got[[0, 3]], clean[[0, 3]])
        ok = finite.nonzero().flatten()
        assert _rel(got[ok], want[ok]) <= 2e-5
