"""The ordered segment sums of the sparse path (``ops/ordered_sum.py``,
``csrc/ordered_sum.cu``) on the CPU.

* ``ordered_sum.cu`` built with g++ against the CUDA stand-in (the harness
  of tests/test_torch_kernel_emulation.py) and run on a ragged map (empty
  targets, long ones, terms in no order): bit for bit what ``index_add_``
  gives on the CPU, in float32 and float64.
* The segment maps that setup builds: each target's terms in term order,
  A's pair terms before Q's terms where one sum takes both.
* Every sum of the operator that went through ``index_add_`` before (the
  block-Jacobi blocks, the coarse matrix and its restriction, the banded
  blocks, diag(K) without the ELL map, the scatter and paired matvecs,
  setup's diag(Q)) equal bit for bit to that ``index_add_`` code, written
  out here as it was.
* One CG-route solve (block-Jacobi with its coarse level) and one banded
  solve against the JAX package, with the tolerances of
  tests/test_torch_sparse_cg.py and tests/test_torch_sparse_banded.py
  (status, iterations, x and y within 1e-8).  The JAX package solves in a
  child process, as in tests/test_torch_diff.py: the XLA-CPU compiler can
  crash in a worker of the parallel suite that has compiled many programs
  before (ROADMAP.md, "Tier-1 verify"), and this file adds none there.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import qpdo_tpu_torch as pt
from qpdo_tpu_torch.ops import ordered_sum as osum
from qpdo_tpu_torch.solver import sparse as tsparse
from test_torch_kernel_emulation import build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32, F64 = torch.float32, torch.float64


def _ragged(n_terms=2000, targets=97, seed=0):
    """An index with empty targets (every fifth), one long target and the
    terms in no order; values over twelve decades, so that any other
    order of the adds shows in the bits."""
    rng = np.random.default_rng(seed)
    live = np.flatnonzero(np.arange(targets) % 5 != 0)
    index = rng.choice(live, n_terms)
    index[rng.random(n_terms) < 0.2] = live[3]
    values = rng.standard_normal((3, n_terms)) * 10.0 ** rng.uniform(
        -6, 6, (3, n_terms))
    return index, values


def _index_add(values, index, targets):
    out = torch.zeros((values.shape[0], targets), dtype=values.dtype)
    return out.index_add_(1, index, values)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    return build(tmp_path_factory.mktemp("emulated_ordered_sum"),
                 ("ordered_sum.cu",))


@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_is_index_add_bit_for_bit(lib, dtype):
    index, values = _ragged()
    targets = 97
    seg = [torch.as_tensor(a) for a in tsparse._segment_map(index, targets)]
    v = torch.as_tensor(values, dtype=dtype)
    out = torch.full((3, targets), float("nan"), dtype=dtype)
    fn = getattr(lib, "qpdo_ordered_sum_" + ("f32" if dtype == F32 else "f64"))
    assert fn(v.data_ptr(), seg[1].data_ptr(), seg[2].data_ptr(),
              out.data_ptr(), 3, index.shape[0], targets, None) == 0
    want = _index_add(v, seg[0], targets)
    assert torch.equal(out, want)
    assert torch.equal(osum.ordered_segment_sum(v, seg), want)
    assert (out[:, ::5] == 0).all()                    # the empty targets


def test_segment_map_keeps_each_targets_terms_in_order():
    """A ragged index, and the block-Jacobi map of a random pattern: each
    target's terms in term order, so A's pair terms (the first ones)
    before Q's."""
    index, _ = _ragged(500, 40, seed=2)
    idx, order, offsets = tsparse._segment_map(index, 40)
    assert np.array_equal(idx, index)
    assert offsets[0] == 0 and offsets[-1] == 500
    for t in range(40):
        terms = order[offsets[t]:offsets[t + 1]]
        assert np.array_equal(terms, np.flatnonzero(index == t))
    op = tsparse.setup_sparse(*_random_sparse(), precond_block=8,
                              device="cpu")
    idx, order, offsets = (a.numpy() for a in op.segPJ)
    n_a = op.pjA[0].shape[0]
    assert idx.shape[0] == n_a + op.pjQ[0].shape[0]
    assert np.array_equal(np.sort(idx, kind="stable"), idx[order])
    mixed = 0
    for t in np.flatnonzero(np.diff(offsets) > 1):
        terms = order[offsets[t]:offsets[t + 1]]
        assert np.all(np.diff(terms) > 0)
        mixed += terms[0] < n_a <= terms[-1]
    assert mixed > 0                      # targets that take A's and Q's


def _random_sparse(n=40, m=30, seed=21):
    rng = np.random.default_rng(seed)
    Bm = sps.random(n, n, density=0.1, random_state=seed, format="csr")
    Q = (Bm.T @ Bm + 0.3 * sps.eye(n)).tocsr()
    A = sps.random(m, n, density=0.12, random_state=seed + 1, format="csr")
    A = (A + sps.csr_matrix((rng.standard_normal(m),
                             (np.arange(m), rng.integers(0, n, m))),
                            shape=(m, n))).tocsr()
    return Q, rng.standard_normal(n), A, -rng.random(m), rng.random(m)


def _liswet(n, seed=0):
    """The banded LISWET-style problem of tests/test_sparse.py:268."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    q = -(np.sin(4 * np.pi * t) + 0.1 * rng.standard_normal(n))
    Q = sps.eye(n, format="csr") * (1.0 + 1e-3)
    m = n - 2
    rows = np.repeat(np.arange(m), 3)
    cols = (np.arange(m)[:, None] + np.array([0, 1, 2])[None, :]).ravel()
    A = sps.csr_matrix((np.tile([1.0, -2.0, 1.0], m), (rows, cols)),
                       shape=(m, n))
    return Q, q, A, np.zeros(m), np.full(m, np.inf)


def _weights(op, seed=3):
    rng = np.random.default_rng(seed)
    w = (rng.random(op.m) < 0.6) * 10.0 ** rng.uniform(-3, 3, op.m)
    return torch.as_tensor(w).reshape(1, -1)


def _blocks_by_index_add(op, pairs, qpart, w, nblocks, b):
    t1, t2, rows_p, blk, o1, o2 = pairs
    M = torch.zeros((1, nblocks * b * b), dtype=op.dtype)
    M.index_add_(1, tsparse._flat(blk, o1, o2, b),
                 op.a_data[:, t1] * op.a_data[:, t2] * w[:, rows_p])
    tq, qblk, qo1, qo2 = qpart
    M.index_add_(1, tsparse._flat(qblk, qo1, qo2, b), op.q_data[:, tq])
    return M.view(1, nblocks, b, b)


def test_preconditioner_assembly_is_index_add():
    """The block-Jacobi blocks, the coarse matrix and its restriction."""
    b = 8
    op = tsparse.setup_sparse(*_random_sparse(), precond_block=b,
                              device="cpu")
    assert op.pjA is not None and op.pcA is not None
    w = _weights(op)
    nb = -(-op.n // b)
    assert torch.equal(op._block_diagonal(op.pjA, op.pjQ, op.segPJ, w, nb, b),
                       _blocks_by_index_add(op, op.pjA, op.pjQ, w, nb, b))
    nc = op.pc_counts.shape[0]
    t1, t2, rows_p, J1, J2 = op.pcA
    qJ1, qJ2 = op.pcQ
    Kc = torch.zeros((1, nc * nc), dtype=op.dtype)
    Kc.index_add_(1, J1 * nc + J2,
                  op.a_data[:, t1] * op.a_data[:, t2] * w[:, rows_p])
    Kc.index_add_(1, qJ1 * nc + qJ2, op.q_data)
    assert torch.equal(op._coarse_matrix(w), Kc.view(1, nc, nc))
    r = torch.randn((1, op.n), dtype=op.dtype)
    cgrid = torch.arange(op.n) // b
    assert torch.equal(osum.ordered_segment_sum(r, op.segRC),
                       _index_add(r, cgrid, nc))
    assert torch.equal(op.segRC[0], cgrid)


def test_banded_assembly_is_index_add():
    op = tsparse.setup_sparse(*_liswet(60, seed=5), device="cpu")
    nb, b = op.bd_shape
    w = _weights(op, seed=4)
    assert torch.equal(op._block_diagonal(op.bdA, op.bdQ, op.segBD, w, nb, b),
                       _blocks_by_index_add(op, op.bdA, op.bdQ, w, nb, b))
    ns = max(nb - 1, 1)
    assert torch.equal(
        op._block_diagonal(op.bdAsub, op.bdQsub, op.segBDsub, w, ns, b),
        _blocks_by_index_add(op, op.bdAsub, op.bdQsub, w, ns, b))


def test_diagonals_and_scatter_matvecs_are_index_add():
    """diag(Q) of setup, diag(K) without the ELL map, the three scatter
    matvecs in float64 and float32 and the three paired ones."""
    op = tsparse.setup_sparse(*_random_sparse(seed=5), device="cpu")
    assert op.ellA is None and op.ellAt is None and op.ellQ is None
    rows, cols = op.a_idx[:, 0], op.a_idx[:, 1]
    qi, qj = op.q_idx[:, 0], op.q_idx[:, 1]
    diagQ = _index_add(torch.where(qi == qj, op.q_data,
                                   torch.zeros_like(op.q_data)), qi, op.n)
    assert torch.equal(op.diagQ, diagQ)
    active = torch.as_tensor((np.arange(op.m) % 3 != 0) * 1.0).reshape(1, -1)
    mu = torch.full((1, op.m), 0.3, dtype=F64)
    sigma = torch.full((1,), 1e-4, dtype=F64)
    dK = _index_add((active / mu).index_select(1, rows)
                    * torch.square(op.a_data), cols, op.n) + diagQ
    assert torch.equal(op.diag_K(active, mu, sigma, False), dK)
    x, x2 = torch.randn((2, 1, op.n), dtype=F64)
    y, y2 = torch.randn((2, 1, op.m), dtype=F64)
    for dtype in (None, "float32"):
        cd = F64 if dtype is None else F32
        for got, data, tgt, src, v, size in (
                (op.Qmv(x, dtype), op.q_data, qi, qj, x, op.n),
                (op.Amv(x, dtype), op.a_data, rows, cols, x, op.m),
                (op.Atmv(y, dtype), op.a_data, cols, rows, y, op.n)):
            want = _index_add(data.to(cd) * v.index_select(1, src).to(cd),
                              tgt, size).to(F64)
            assert torch.equal(got, want)
    for got, data, tgt, src, (a, b), size in (
            (op.Qmv2(x, x2), op.q_data, qi, qj, (x, x2), op.n),
            (op.Amv2(x, x2), op.a_data, rows, cols, (x, x2), op.m),
            (op.Atmv2(y, y2), op.a_data, cols, rows, (y, y2), op.n)):
        V = torch.zeros((1, size, 2), dtype=F64)
        V.index_add_(1, tgt, data[:, :, None]
                     * torch.stack([a, b], dim=-1).index_select(1, src))
        assert torch.equal(got[0], V[..., 0]) and torch.equal(got[1],
                                                              V[..., 1])


# the two problems of the solve tests, at the packages' default settings
PROBLEMS = {"cg": lambda: _random_sparse(), "banded": lambda: _liswet(40, 7)}

_JAX_SIDE = """
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import qpdo_tpu as qt
sys.path.insert(0, sys.argv[2])
from test_torch_ordered_sum import PROBLEMS
out = {}
for name, make in PROBLEMS.items():
    r = qt.solve_sparse(*make(), settings=qt.Settings())
    out.update({name + "_x": r.x, name + "_y": r.y,
                name + "_status": int(r.info.status_val),
                name + "_iterations": int(r.info.iterations)})
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_solves(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_sparse") / "out.npz"
    tests = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(tests.parent), os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _JAX_SIDE, str(out), str(tests)],
                   env=env, check=True, timeout=600)
    return np.load(out)


def _solves(name, jax_side):
    tr = pt.solve_sparse(*PROBLEMS[name](), settings=pt.Settings(),
                         device="cpu")
    assert int(tr.info.status_val[0]) == int(jax_side[name + "_status"]) \
        == pt.SOLVED
    assert int(tr.info.iterations[0]) == int(jax_side[name + "_iterations"])
    for a, key in ((tr.x, "_x"), (tr.y, "_y")):
        np.testing.assert_allclose(a[0].numpy(), jax_side[name + key],
                                   rtol=0, atol=1e-8)


def test_cg_route_solve_matches_jax(jax_solves):
    """At the default block of 64 (one block-Jacobi block here, as in
    tests/test_torch_sparse_cg.py: with several blocks CG stops early and
    its iterate moves with rounding, so the two packages' x differ by
    ~1e-8-1e-7; the sums of several blocks are held bit for bit above)."""
    op = tsparse.setup_sparse(*PROBLEMS["cg"](), device="cpu")
    assert op.pjA is not None and op.pcA is not None and op.bd_shape is None
    _solves("cg", jax_solves)


def test_banded_solve_matches_jax(jax_solves):
    assert tsparse.setup_sparse(*PROBLEMS["banded"](), device="cpu") \
        .newton_exact(pt.Settings())
    _solves("banded", jax_solves)


def test_wrapper_checks_its_arguments():
    seg = [torch.as_tensor(a) for a in tsparse._segment_map([0, 2, 2], 4)]
    with pytest.raises(ValueError, match="values must be"):
        osum.ordered_segment_sum(torch.zeros((1, 2)), seg)
    out = osum.ordered_segment_sum(torch.tensor([[1.0, 2.0, 3.0]]), seg)
    assert torch.equal(out, torch.tensor([[1.0, 0.0, 5.0, 0.0]]))
    assert not osum.ordered_segment_sum.launches      # no kernel on the CPU
