"""``python -m qpdo_tpu_torch`` against ``python -m qpdo_tpu``, both with
``--cpu``, on the same QPS files.

The JSON lines carry the same keys; names, sizes, path, status and
iteration counts are equal, the objective within 1e-9 relative, and the
exit codes equal.  The two residual norms are rounding-level numbers (a
converged solve's rp, rd sit near 1e-7 to 1e-12, where two
implementations' sums differ in the last bits), so they are held within
1e-12 absolute; ``parse_s``/``solve_s`` are timings.

``--sparse``: the JAX command line parses with its Python reader, which
ignores ``dense=False``, so its ``--sparse`` still runs the dense solver
while printing "sparse".  The port's runs ``solve_sparse``.  The JAX side
of that test is given the reader it asks for (CSR Q and A) so that it
takes its own sparse branch, and the two are held as above.
"""

import json

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import qpdo_tpu as qt
import qpdo_tpu.__main__ as jcli
from qpdo_tpu.io import qps as jqps

import qpdo_tpu_torch.__main__ as tcli

from test_maros_fixtures import HS35, HS51
from test_qps import HS21_WITH_CONST
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXACT = ("name", "n", "m", "path", "status", "status_val", "iterations")


def _files(tmp_path):
    paths = []
    for name, text in (("hs21", HS21_WITH_CONST), ("hs35", HS35),
                       ("hs51", HS51)):
        paths.append(str(tmp_path / f"{name}.qps"))
        with open(paths[-1], "w") as f:
            f.write(text)
    rng = np.random.default_rng(0)
    n, m = 20, 14
    M = rng.standard_normal((n, n))
    prob = qt.make_problem(M @ M.T / n + 0.3 * np.eye(n),
                           rng.standard_normal(n),
                           rng.standard_normal((m, n)), -np.ones(m),
                           np.ones(m))
    paths.append(str(tmp_path / "cli.qps"))
    jqps.write_qps(prob, paths[-1], name="CLI")
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, [json.loads(line) for line in out]


def _same_lines(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        if "files" in r:                     # the summary line
            assert g == r
            continue
        if "x" in r and "status" not in r:   # --print-solution
            np.testing.assert_allclose(np.array(g["x"], float),
                                       np.array(r["x"], float), atol=1e-8)
            continue
        assert {k: g[k] for k in EXACT} == {k: r[k] for k in EXACT}
        np.testing.assert_allclose(g["objective"], r["objective"],
                                   rtol=1e-9, atol=1e-12)
        for k in ("res_prim", "res_dual"):
            assert abs(g[k] - r[k]) <= 1e-12, k


def test_one_file(tmp_path, capsys):
    path = _files(tmp_path)[0]
    ref = _run(jcli.main, ["--cpu", path], capsys)
    got = _run(tcli.main, ["--cpu", path], capsys)
    assert got[0] == ref[0] == 0
    _same_lines(got[1], ref[1])
    assert got[1][0]["objective"] == pytest.approx(-99.96, abs=1e-6)


def test_several_files_with_the_summary_and_solutions(tmp_path, capsys):
    paths = _files(tmp_path)
    argv = ["--cpu", "--print-solution", *paths]
    ref = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv, capsys)
    assert got[0] == ref[0] == 0
    _same_lines(got[1], ref[1])
    assert got[1][-1] == {"files": 4, "solved": 4, "solve_rate": 1.0}


def test_the_exit_code_when_a_file_is_not_solved(tmp_path, capsys):
    path = _files(tmp_path)[1]
    argv = ["--cpu", "--max-iter", "3", path]
    ref = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv, capsys)
    assert got[0] == ref[0] == 2
    _same_lines(got[1], ref[1])
    assert got[1][0]["status"] == "maximum iterations reached"


def test_sparse(tmp_path, capsys, monkeypatch):
    paths = _files(tmp_path)[1:]
    read = jqps.read_qps

    def csr_reader(path, dense=True):
        d = read(path)
        return d if dense else jqps.QPSData(
            d.name, sps.csr_matrix(d.Q), d.q, d.c, sps.csr_matrix(d.A), d.l,
            d.u, d.n_structural)

    monkeypatch.setattr(jqps, "read_qps", csr_reader)
    argv = ["--cpu", "--sparse", *paths]
    ref = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv, capsys)
    assert got[0] == ref[0] == 0
    _same_lines(got[1], ref[1])
    assert [ln["path"] for ln in got[1][:-1]] == ["sparse"] * 3


def test_the_card_is_the_default(tmp_path):
    """Without --cpu the command line runs on the CUDA device, and says so
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--cpu"):
        tcli.main([_files(tmp_path)[1]])
