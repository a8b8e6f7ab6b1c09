"""The PyTorch port's QPS files (``qpdo_tpu_torch.io``) and native parser
(``qpdo_tpu_torch.native``) against the JAX package's, on the CPU.

* ``read_qps`` gives arrays bit for bit equal to the JAX package's reader
  on every fixture text of tests/test_qps.py, tests/test_maros_fixtures.py
  and tests/test_native_qps.py, and on a generated file; with
  ``dense=False`` the same matrices as scipy CSR (the port's reader honours
  ``dense``, the JAX package's Python reader ignores it).
* ``write_qps`` writes the JAX package's text, character for character,
  from QPS data, from a sparse problem and from a port ``Problem``.
* The port's copy of the native parser builds into the build directory
  (never the source tree), raises when the compiler fails, and equals the
  Python reader as tests/test_native_qps.py:_parity holds it.
* ``solve_qps_data`` on its dense and sparse branches: the JAX package's
  status and iterations, x within 1e-8.
"""

import io
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import qpdo_tpu as qt
from qpdo_tpu.io import qps as jqps

import qpdo_tpu_torch as pt
from qpdo_tpu_torch import convert
from qpdo_tpu_torch.io import qps as tqps
from qpdo_tpu_torch.native import loader

from test_maros_fixtures import HS35, HS51
from test_qps import HS21, HS21_WITH_CONST, TAME
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _generated(seed=0, n=40, m=25):
    """A random QPS text with every row sense, ranges, bound types and
    QUADOBJ couplings, in the style of tests/test_native_qps.py."""
    rng = np.random.default_rng(seed)
    lines = ["NAME GEN", "ROWS", " N obj"]
    for i in range(m):
        lines.append(f" {'LGE'[rng.integers(3)]} r{i}")
    lines.append("COLUMNS")
    for j in range(n):
        for i in range(m):
            if rng.random() < 0.2:
                lines.append(f" x{j} r{i} {rng.standard_normal():.6f}")
        if rng.random() < 0.7:
            lines.append(f" x{j} obj {rng.standard_normal():.6f}")
    lines.append("RHS")
    for i in range(m):
        if rng.random() < 0.8:
            lines.append(f" rhs r{i} {rng.standard_normal():.6f}")
    lines.append("RANGES")
    for i in range(m):
        if rng.random() < 0.3:
            lines.append(f" rng r{i} {rng.standard_normal():.6f}")
    lines.append("BOUNDS")
    for j in range(0, n, 3):
        kind = ["UP", "LO", "FX", "FR", "MI"][rng.integers(5)]
        value = "" if kind in ("FR", "MI") else f" {rng.standard_normal():.6f}"
        lines.append(f" {kind} bnd x{j}{value}")
    lines.append("QUADOBJ")
    for j in range(n):
        lines.append(f" x{j} x{j} {abs(rng.standard_normal()) + 0.1:.6f}")
        if j + 1 < n and rng.random() < 0.3:
            lines.append(f" x{j} x{j+1} {0.01 * rng.standard_normal():.6f}")
    lines.append("ENDATA")
    return "\n".join(lines) + "\n"


TEXTS = {"HS21": HS21, "HS21_WITH_CONST": HS21_WITH_CONST, "TAME": TAME,
         "HS35": HS35, "HS51": HS51, "GENERATED": _generated()}
FIELDS = ("Q", "q", "A", "l", "u")


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and \
        np.array_equal(a.view(np.int64), b.view(np.int64))


def test_read_qps_is_bit_equal_to_the_jax_reader():
    for name, text in TEXTS.items():
        ref = jqps.read_qps(io.StringIO(text))
        got = tqps.read_qps(io.StringIO(text))
        assert (got.name, got.n_structural, got.c) == \
            (ref.name, ref.n_structural, ref.c), name
        for f in FIELDS:
            assert _bits_equal(getattr(got, f), getattr(ref, f)), (name, f)
        sparse = tqps.read_qps(io.StringIO(text), dense=False)
        assert sps.issparse(sparse.Q) and sps.issparse(sparse.A)
        assert _bits_equal(sparse.Q.toarray(), ref.Q), name
        assert _bits_equal(sparse.A.toarray(), ref.A), name
        for f in ("q", "l", "u"):
            assert _bits_equal(getattr(sparse, f), getattr(ref, f)), (name, f)


def test_write_qps_writes_the_jax_text():
    for name, text in TEXTS.items():
        data = jqps.read_qps(io.StringIO(text))
        assert tqps.write_qps(data) == jqps.write_qps(data), name
    rng = np.random.default_rng(2)
    n, m = 30, 20
    Q = sps.random(n, n, density=0.1, random_state=3)
    Q = (Q + Q.T + sps.eye(n)).tocsr()
    A = sps.random(m, n, density=0.2, random_state=4, format="csr")
    data = jqps.QPSData("SP", Q, rng.standard_normal(n), 1.5, A,
                        -rng.random(m), np.where(rng.random(m) < 0.5,
                                                 np.inf, rng.random(m)), m)
    assert tqps.write_qps(data) == jqps.write_qps(data)
    M = rng.standard_normal((n, n))
    args = (M @ M.T / n + 0.3 * np.eye(n), rng.standard_normal(n),
            rng.standard_normal((m, n)), -np.ones(m), np.ones(m), 0.25)
    assert tqps.write_qps(pt.make_problem(*args, device="cpu"), name="P") \
        == jqps.write_qps(qt.make_problem(*args), name="P")


def test_the_native_parser_builds_beside_the_kernels_and_equals_python():
    path = Path(loader.build_native())
    assert path.parent == loader.build_dir()
    assert "build" in path.parts and not path.is_relative_to(
        Path(loader.__file__).parent)
    assert loader.native_available()
    for name, text in TEXTS.items():
        ref = tqps.read_qps(io.StringIO(text))
        nat = loader.read_qps_native(text)
        sp = loader.read_qps_native(text, dense=False)
        assert (nat.name, nat.n_structural, nat.c) == \
            (ref.name, ref.n_structural, ref.c), name
        for f in FIELDS:
            np.testing.assert_allclose(getattr(nat, f), getattr(ref, f))
        np.testing.assert_allclose(sp.Q.toarray(), ref.Q)
        np.testing.assert_allclose(sp.A.toarray(), ref.A)


def test_a_failed_native_build_raises(monkeypatch, tmp_path):
    """No fallback to the Python reader: a compiler that fails raises."""
    monkeypatch.setattr(loader, "build_dir", lambda: tmp_path / "native")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(loader.NativeBuildError, match="exit code"):
        loader.build_native(force=True)
    monkeypatch.setattr(loader, "_lib", None)
    assert not loader.native_available()
    assert not list((tmp_path / "native").glob("*.so"))


def test_solve_qps_data_dense_and_sparse_branches():
    settings = qt.Settings()
    for text in (HS35, HS51, HS21_WITH_CONST):
        jd = jqps.read_qps(io.StringIO(text))
        jr = jqps.solve_qps_data(jd, settings)
        for dense in (True, False):
            td = tqps.read_qps(io.StringIO(text), dense=dense)
            if not dense:
                # the JAX package's sparse branch, from the same CSR data
                jr = jqps.solve_qps_data(td, settings)
            tr = tqps.solve_qps_data(td, convert.settings(settings),
                                     device="cpu")
            assert tr.x.shape == (1, jd.q.shape[0])
            assert int(tr.info.status_val[0]) == int(jr.info.status_val)
            assert int(tr.info.iterations[0]) == int(jr.info.iterations)
            np.testing.assert_allclose(tr.x[0].numpy(), np.asarray(jr.x),
                                       rtol=0, atol=1e-8)


def test_to_problem_runs_on_the_card_unless_told_otherwise():
    d = tqps.read_qps(io.StringIO(HS35), dense=False)
    p = tqps.to_problem(d, device="cpu")
    assert p.Q.shape == (1, 3, 3) and p.Q.device.type == "cpu"
    assert torch.equal(p.Q[0], torch.from_numpy(d.Q.toarray()))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tqps.to_problem(d)
