"""Sparse problem setup: Ruiz scaling and SparseOperator construction.

Port of ``qpdo_tpu/solver/sparse.py``, the large-n ingestion path
(reference: qpdo_setup's CHOLMOD deep copy and scale_data,
src/qpdo.c:49-212 and src/scaling.c:24-91).  Every scaling pass runs on
the COO triplets directly, O(nnz) segment reductions instead of dense row
and column sweeps, with the semantics of the dense path
(``solver/scaling.py``): Ruiz on A only (or on the whole KKT structure
with ``ruiz_kkt``), the limit_scaling floor, the cost scalar
c = 1/max(1, ||D q||_inf), bounds scaled by E.

The operator is batch-first: ``setup_sparse`` builds a batch of one, and
``setup_sparse_batch`` a batch of problems that share one sparsity
pattern (float leaves (B, nnz), one shared copy of every index map).  The
index maps (block-Jacobi, coarse-grid, banded, ELL) are built on the host
with numpy from the pattern, as the JAX package builds them, and moved to
the operator's device once; so are the segment maps of every sum into a
shared target (``_segment_map``), which fix the order of those sums on
every device (``ops/ordered_sum.py``).  The ELL matvec maps are built where the
operator's device is not the CPU, the JAX package's ``backend != "cpu"``
rule; its ``QPDO_ELL`` override is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as _c
from ..operators import SparseOperator
from ..ops.ordered_sum import ordered_segment_sum
from .scaling import limit_scaling

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch or numpy dtype or a name; None is
    float64, the precision of the JAX package's tests and of the
    reference."""
    if dtype is None:
        return torch.float64
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise NotImplementedError(f"sparse dtype {name}: float32 or float64")
    return getattr(torch, name)


def _as_triplets(M, dtype):
    """Accept a scipy.sparse matrix, a dense array-like (numpy or a
    tensor), or a prebuilt ``(data, indices, shape)`` triple; return
    (data, indices (nse, 2) int64, shape) in row-sorted COO order, on the
    host.  ``data`` is a numpy array of ``dtype``, except that the triple
    form passes a tensor ``data`` through untouched (its indices must be
    row-sorted)."""
    dtype = _torch_dtype(dtype)
    if isinstance(M, tuple) and len(M) == 3:
        data, idx, shape = M
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data, _NP[dtype])
        return data, np.asarray(idx, np.int64).reshape(-1, 2), tuple(shape)
    import scipy.sparse as sps
    if sps.issparse(M):
        coo = M.tocsr().tocoo()   # csr -> coo gives row-sorted triplets
        return (np.asarray(coo.data, _NP[dtype]),
                np.stack([coo.row, coo.col], axis=1).astype(np.int64),
                tuple(coo.shape))
    if isinstance(M, torch.Tensor):
        M = M.detach().cpu().numpy()
    Md = np.asarray(M, _NP[dtype])
    r, c = np.nonzero(Md)
    return Md[r, c], np.stack([r, c], axis=1).astype(np.int64), Md.shape


def pad_sparse_problem(p, n_pad: int, m_pad: int, dtype):
    """Pad a sparse ``(Q, q, A, l, u[, c])`` tuple to (n_pad, m_pad)
    inertly, in triplet form: padded variables get a unit Q diagonal and
    zero q (they solve to exactly 0 and stay 0, as in
    ``utils.padding.pad_problem``), padded constraint rows are all-zero
    with free bounds.  Returns a tuple ready for ``solve_sparse_batch``."""
    Q, q, A, l, u = p[:5]
    c = p[5] if len(p) > 5 else 0.0
    qd, qi, _ = _as_triplets(Q, dtype)
    ad, ai, (m, _) = _as_triplets(A, dtype)
    q = np.asarray(q, float).reshape(-1)
    n = q.shape[0]
    if n_pad < n or m_pad < m:
        raise ValueError(f"pad target ({n_pad},{m_pad}) smaller than "
                         f"({n},{m})")
    dn = n_pad - n
    if dn:
        diag = np.arange(n, n_pad, dtype=np.int64)
        qd = np.concatenate([np.asarray(qd), np.ones(dn)])
        qi = np.concatenate([qi, np.stack([diag, diag], axis=1)])
    inf = float(_c.QPDO_INFTY)
    q_pad = np.concatenate([q, np.zeros(dn)])
    l_pad = np.concatenate([np.asarray(l, float).reshape(-1),
                            np.full(m_pad - m, -inf)])
    u_pad = np.concatenate([np.asarray(u, float).reshape(-1),
                            np.full(m_pad - m, inf)])
    return ((qd, qi, (n_pad, n_pad)), q_pad, (np.asarray(ad), ai,
                                               (m_pad, n_pad)),
            l_pad, u_pad, c)


def union_triplets(mats, dtype):
    """Re-express same-shape sparse matrices on the UNION of their
    sparsity patterns: returns ``(datas, indices, shape)`` with
    ``indices`` (nnz_union, 2) shared and row-sorted, and each instance's
    ``datas[b]`` carrying explicit zeros on the entries it lacks.  Every
    sparse kernel here treats an explicit zero as an absent entry, so
    per-instance results are unchanged; the cost scales with
    nnz(union).  Duplicate (i, j) entries of one instance add up (COO
    semantics)."""
    trips = [_as_triplets(M, dtype) for M in mats]
    shape = trips[0][2]
    for _, _, s in trips[1:]:
        if tuple(s) != tuple(shape):
            raise ValueError(f"shape mismatch across instances: {s} vs "
                             f"{shape}")
    ncol = shape[1]
    keys = [idx[:, 0] * ncol + idx[:, 1] for _, idx, _ in trips]
    union = np.unique(np.concatenate(keys))  # sorted = row-major order
    indices = np.stack([union // ncol, union % ncol], axis=1)
    datas = []
    for (data, _, _), k in zip(trips, keys):
        data = np.asarray(data)
        full = np.zeros((union.shape[0],), data.dtype)
        np.add.at(full, np.searchsorted(union, k), data)
        datas.append(full)
    return datas, indices, shape


def _block_jacobi_indices(a_indices, q_indices, n, block: int,
                          pair_cap_factor: float = 40.0):
    """The scatter maps of the block-Jacobi preconditioner, from the
    pattern (solver/sparse.py:131-173 of the JAX package).

    For A: every ordered pair of nonzeros sharing (row, column block),
    each contributing w_r a1 a2 to block[blk][o1, o2] of A'WA.  For Q: the
    entries whose (i, j) fall in one diagonal block.  Returns (pjA, pjQ)
    as tuples of int64 arrays, or (None, None) when the pairs would
    number more than ``pair_cap_factor * nnz`` (dense rows: plain
    Jacobi then)."""
    rows = np.asarray(a_indices[:, 0], np.int64)
    cols = np.asarray(a_indices[:, 1], np.int64)
    # grouped by (row, column block): the order of lexsort((blk, rows))
    pairs = _same_key_pairs(rows * -(-n // block) + cols // block,
                            pair_cap_factor)
    if pairs is None:
        return None, None
    t1, t2 = pairs
    pjA = (t1, t2, rows[t1], cols[t1] // block, cols[t1] % block,
           cols[t2] % block)

    qi = np.asarray(q_indices[:, 0], np.int64)
    qj = np.asarray(q_indices[:, 1], np.int64)
    tq = np.flatnonzero(qi // block == qj // block)
    pjQ = (tq, qi[tq] // block, qi[tq] % block, qj[tq] % block)
    return pjA, pjQ


def _same_key_pairs(keys, pair_cap_factor):
    """Every ordered pair (t1, t2) of nonzeros of A with one key (a row,
    or a row and a column block), keys in order, ties in the order of the
    nonzeros; None when there are more than ``pair_cap_factor * nnz``."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    grp_start = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    sizes = np.diff(np.r_[grp_start, len(ks)])
    n_pairs = int(np.sum(sizes.astype(np.int64) ** 2))
    if n_pairs > pair_cap_factor * max(len(keys), 1):
        return None
    sq = sizes ** 2
    starts_rep = np.repeat(grp_start, sq)
    pid = np.arange(n_pairs) - np.repeat(np.cumsum(sq) - sq, sq)
    s_rep = np.repeat(sizes, sq)
    return order[starts_rep + pid // s_rep], order[starts_rep + pid % s_rep]


def _coarse_indices(a_indices, q_indices, n, block: int,
                    pair_cap_factor: float = 40.0):
    """The scatter maps of the coarse-grid correction
    (solver/sparse.py:176-210 of the JAX package): P aggregates ``block``
    columns, Kc = P'KP.  The A'WA part is every same-row pair of nonzeros
    scattered to its coarse columns (J = col // block); the Q part
    scatters every entry to its coarse cell.  Returns (pcA, pcQ, counts),
    counts the aggregate sizes as float64, or three Nones when the pairs
    exceed the cap (no coarse level then)."""
    rows = np.asarray(a_indices[:, 0], np.int64)
    cols = np.asarray(a_indices[:, 1], np.int64)
    nc = -(-n // block)
    pairs = _same_key_pairs(rows, pair_cap_factor)
    if pairs is None:
        return None, None, None
    t1, t2 = pairs
    pcA = (t1, t2, rows[t1], cols[t1] // block, cols[t2] // block)
    qi = np.asarray(q_indices[:, 0], np.int64)
    qj = np.asarray(q_indices[:, 1], np.int64)
    pcQ = (qi // block, qj // block)
    counts = np.bincount(np.arange(n) // block, minlength=nc).astype(float)
    return pcA, pcQ, counts


def _ell_maps(keys_group, keys_other, out_dim: int,
              cap_width: int = 128, pad_factor: float = 8.0):
    """Padded-row (ELL) gather maps for one matvec direction
    (solver/sparse.py:228-280 of the JAX package): the product becomes

        out[i] = sum_k data[gather[i, k]] * x[idx[i, k]] * mask[i, k]

    with every row padded to the largest row degree K, a gather and a
    dense row sum in place of a scatter.  Returns (gather (out, K) int64,
    idx (out, K) int64, mask (out, K) int8), or None when the pattern is
    too irregular (K > ``cap_width``, or the padding exceeds
    ``pad_factor`` x nnz): the scatter takes that direction then."""
    g = np.asarray(keys_group, np.int64)
    nse = len(g)
    if nse == 0:
        return None
    counts = np.bincount(g, minlength=out_dim)
    K = max(int(counts.max()), 1)
    if K > cap_width or out_dim * K > pad_factor * nse + out_dim:
        return None
    order = np.argsort(g, kind="stable")
    gs = g[order]
    starts = np.zeros(out_dim + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(nse) - starts[gs]
    gather = np.zeros((out_dim, K), np.int64)
    idx = np.zeros((out_dim, K), np.int64)
    mask = np.zeros((out_dim, K), np.int8)
    gather[gs, pos] = order
    idx[gs, pos] = np.asarray(keys_other, np.int64)[order]
    mask[gs, pos] = 1
    return gather, idx, mask


def _banded_indices(a_indices, q_indices, n, max_bw: int = 128,
                    min_block: int = 8, pair_cap_factor: float = 40.0):
    """Block-tridiagonal scatter maps for the banded direct Newton solve
    (solver/sparse.py:271-342 of the JAX package).

    K = Q + sigma*I + A'WA has bandwidth bw = max(bw(Q), the widest row
    span of A); when bw <= ``max_bw`` it is exactly block-tridiagonal in
    blocks of b >= bw, and a block-tridiagonal Cholesky replaces CG.
    Returns (bdA, bdAsub, bdQ, bdQsub, (nb, b)), or five Nones when the
    pattern does not qualify (too wide, one block covering all of n, or
    too many same-row pairs).  The JAX package carries (nb, b) as the
    shape of an int32 zeros array."""
    none = (None,) * 5
    rows = np.asarray(a_indices[:, 0], np.int64)
    cols = np.asarray(a_indices[:, 1], np.int64)
    qi = np.asarray(q_indices[:, 0], np.int64)
    qj = np.asarray(q_indices[:, 1], np.int64)

    bw_q = int(np.max(np.abs(qi - qj))) if len(qi) else 0
    if len(rows):
        cmax = np.full(int(rows.max()) + 1, -1, np.int64)
        cmin = np.full(int(rows.max()) + 1, np.iinfo(np.int64).max, np.int64)
        np.maximum.at(cmax, rows, cols)
        np.minimum.at(cmin, rows, cols)
        nonempty = cmax >= 0
        bw_a = int(np.max((cmax - cmin)[nonempty])) if nonempty.any() else 0
    else:
        bw_a = 0
    bw = max(bw_q, bw_a)
    if bw > max_bw:
        return none
    b = max(min_block, -(-max(bw, 1) // min_block) * min_block)
    if b >= n:  # one dense block: the dense path's job
        return none
    nb = -(-n // b)

    pairs = _same_key_pairs(rows, pair_cap_factor)
    if pairs is None:
        return none
    t1, t2 = pairs
    blk1, blk2 = cols[t1] // b, cols[t2] // b
    diff = blk1 - blk2                       # in {-1, 0, 1} since b >= bw
    dsel = diff == 0
    ssel = diff == 1                         # sub-diagonal E_k = K[k+1, k]
    bdA = tuple(a[dsel] for a in (t1, t2, rows[t1], blk1, cols[t1] % b,
                                  cols[t2] % b))
    bdAsub = tuple(a[ssel] for a in (t1, t2, rows[t1], blk2, cols[t1] % b,
                                     cols[t2] % b))
    qb1, qb2 = qi // b, qj // b
    qd = qb1 - qb2 == 0
    qs = qb1 - qb2 == 1
    tq = np.arange(len(qi))
    bdQ = tuple(a[qd] for a in (tq, qb1, qi % b, qj % b))
    bdQsub = tuple(a[qs] for a in (tq, qb2, qi % b, qj % b))
    return bdA, bdAsub, bdQ, bdQsub, (nb, b)


def _flat(block, o1, o2, b: int):
    """Index of entry (o1, o2) of block ``block`` in a flattened stack of
    b x b blocks."""
    return (block * b + o1) * b + o2


def _segment_map(index, out_dim: int):
    """The ordered segment map of a sum of terms into ``out_dim`` targets,
    term k into target ``index[k]``: (index, order, offsets), the term
    indices sorted by target with a stable sort (each target keeps its
    terms in term order) and the first term of each target in that order,
    (out_dim + 1,).  ``ops.ordered_sum.ordered_segment_sum`` adds each
    target's terms in that order on every device."""
    index = np.asarray(index, np.int64).reshape(-1)
    order = np.argsort(index, kind="stable")
    offsets = np.zeros(out_dim + 1, np.int64)
    np.cumsum(np.bincount(index, minlength=out_dim), out=offsets[1:])
    return index, order, offsets


def _segment_maps(a_idx, q_idx, n, m, block, pj, pc, bd):
    """The segment maps of every sum of the operator into a shared target,
    by field name (None where the maps they sum over are None): the
    scatter matvecs and diag(Q) and diag(K) (segQ by Q's rows, segA by A's
    rows, segAt by A's columns); the block-Jacobi blocks (segPJ) and the
    banded blocks (segBD, segBDsub), A's pair terms first, then Q's; the
    coarse matrix (segPC, the same) and its restriction (segRC, the
    columns into their aggregates of ``block``)."""
    a_idx, q_idx = np.asarray(a_idx), np.asarray(q_idx)
    maps = dict(segQ=_segment_map(q_idx[:, 0], n),
                segA=_segment_map(a_idx[:, 0], m),
                segAt=_segment_map(a_idx[:, 1], n),
                segPJ=None, segPC=None, segRC=None, segBD=None,
                segBDsub=None)

    def blocks(pairs, qpart, nblocks, b):
        return _segment_map(np.concatenate([_flat(*pairs[3:], b),
                                            _flat(*qpart[1:], b)]),
                            nblocks * b * b)

    pjA, pjQ = pj
    if pjA is not None:
        maps["segPJ"] = blocks(pjA, pjQ, -(-n // block), block)
    pcA, pcQ, counts = pc
    if pcA is not None:
        nc = len(counts)
        maps["segPC"] = _segment_map(
            np.concatenate([pcA[3] * nc + pcA[4], pcQ[0] * nc + pcQ[1]]),
            nc * nc)
        maps["segRC"] = _segment_map(np.arange(n) // block, nc)
    bdA, bdAsub, bdQ, bdQsub, shape = bd
    if shape is not None:
        nb, b = shape
        maps["segBD"] = blocks(bdA, bdQ, nb, b)
        maps["segBDsub"] = blocks(bdAsub, bdQsub, max(nb - 1, 1), b)
    return maps


def _on(maps, device):
    """A tuple of int arrays as tensors on ``device``, int64 except the
    int8 masks of the ELL maps (None stays)."""
    if maps is None:
        return None
    return tuple(torch.as_tensor(a, device=device,
                                 dtype=torch.int8 if a.dtype == np.int8
                                 else torch.int64)
                 for a in maps)


def _device(device) -> torch.device:
    return torch.device("cuda" if device is None else device)


def setup_sparse(Q, q, A, l, u, c=0.0, scaling_iters: int = _c.SCALING,
                 dtype=None, precond: str = "block_jacobi",
                 precond_block: int = 64, banded_max_bw: int = 128,
                 ruiz_kkt: bool = False, device=None) -> SparseOperator:
    """A scaled SparseOperator (a batch of one) from sparse or dense Q/A.

    ``Q`` must be the full symmetric matrix (both triangles), as in
    ``make_problem``.  Accepts scipy.sparse matrices, dense array-likes
    and ``(data, indices, shape)`` triples.  ``dtype`` defaults to
    float64; ``device=None`` is "cuda" (pass "cpu" to run there).

    When the KKT pattern's bandwidth is at most ``banded_max_bw`` the
    operator carries block-tridiagonal maps and its Newton systems are
    solved by the exact banded factorization instead of CG (0 disables
    the detection).  ``ruiz_kkt`` equilibrates Q jointly with A; the
    default is the reference's A-only Ruiz (scaling.c:36-63)."""
    dt = _torch_dtype(dtype)
    q_data, q_idx, _ = _as_triplets(Q, dt)
    a_data, a_idx, (m, _) = _as_triplets(A, dt)
    stack = lambda v: _tensor(v, dt, device).reshape(1, -1)
    return setup_sparse_batch(stack(q_data), q_idx, stack(a_data), a_idx,
                              stack(q), stack(l), stack(u), stack(c), m,
                              scaling_iters, precond, precond_block,
                              banded_max_bw, ruiz_kkt)


def _tensor(v, dtype, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=_device(device), dtype=dtype)
    return torch.as_tensor(np.asarray(v, _NP[dtype]), device=_device(device))


def setup_sparse_batch(q_data, q_idx, a_data, a_idx, q, l, u, c, m: int,
                       scaling_iters: int = _c.SCALING,
                       precond: str = "block_jacobi", precond_block: int = 64,
                       banded_max_bw: int = 128,
                       ruiz_kkt: bool = False) -> SparseOperator:
    """A scaled SparseOperator for a batch of problems of one pattern:
    ``q_data`` (B, nnzQ) and ``a_data`` (B, nnzA) tensors on the shared
    row-sorted ``q_idx`` (nnzQ, 2) and ``a_idx`` (nnzA, 2), ``q`` (B, n),
    ``l``/``u`` (B, m), ``c`` (B,), all of one dtype on one device.  Each
    problem is scaled on its own, as the JAX package's per-problem
    ``setup_sparse``."""
    dt = q.dtype
    device = q.device
    Bn, n = q.shape
    inf = _c.QPDO_INFTY
    l = torch.clamp(l, -inf, inf)
    u = torch.clamp(u, -inf, inf)
    l_finite = (l > -inf).to(dt)
    u_finite = (u < inf).to(dt)

    qi_t = torch.as_tensor(q_idx, dtype=torch.int64, device=device)
    ai_t = torch.as_tensor(a_idx, dtype=torch.int64, device=device)
    rows, cols = ai_t[:, 0], ai_t[:, 1]
    qi, qj = qi_t[:, 0], qi_t[:, 1]

    def seg_max(index, values, size):
        out = torch.zeros((Bn, size), dtype=dt, device=device)
        return out.scatter_reduce_(1, index.expand(Bn, -1), values, "amax",
                                   include_self=True)

    D = torch.ones((Bn, n), dtype=dt, device=device)
    E = torch.ones((Bn, m), dtype=dt, device=device)
    if scaling_iters == 0:
        cost = torch.ones((Bn,), dtype=dt, device=device)
        q_s, q_data_s, a_data_s, l_s, u_s = q, q_data, a_data, l, u
    else:
        # Ruiz on A's triplets (scaling.c:36-63, O(nnz) a pass), or on the
        # full KKT structure's (ruiz_kkt: the column norms take the larger
        # of Q's and A's entries per primal column)
        qdat, adat = q_data, a_data
        for _ in range(scaling_iters):
            absa = torch.abs(adat)
            coln = seg_max(cols, absa, n)
            if ruiz_kkt:
                coln = torch.maximum(coln, seg_max(qj, torch.abs(qdat), n))
            d = torch.rsqrt(limit_scaling(coln))
            e = torch.rsqrt(limit_scaling(seg_max(rows, absa, m)))
            adat = adat * e[:, rows] * d[:, cols]
            if ruiz_kkt:
                qdat = qdat * d[:, qi] * d[:, qj]
            D, E = D * d, E * e
        a_data_s = adat
        # Q <- D Q D (scaling.c:65-79), unless equilibrated with A
        q_data_s = qdat if ruiz_kkt else q_data * D[:, qi] * D[:, qj]
        q_s = q * D
        cost = 1.0 / torch.clamp(torch.amax(torch.abs(q_s), dim=-1), min=1.0)
        q_s = q_s * cost[:, None]
        q_data_s = q_data_s * cost[:, None]
        l_s, u_s = E * l, E * u

    pjA = pjQ = pcA = pcQ = pc_counts = None
    bd = (None,) * 5
    if banded_max_bw > 0:
        bd = _banded_indices(a_idx, q_idx, n, banded_max_bw)
    # the preconditioner maps are built even beside the banded maps:
    # Settings.newton_direct=False takes the CG route
    if precond == "block_jacobi":
        pjA, pjQ = _block_jacobi_indices(a_idx, q_idx, n, precond_block)
        if pjA is not None:
            pcA, pcQ, pc_counts = _coarse_indices(a_idx, q_idx, n,
                                                  precond_block)
    # the ELL gather maps replace the scatters off the CPU
    ellQ = ellA = ellAt = None
    if device.type != "cpu":
        rows_np, cols_np = np.asarray(a_idx).T
        qi_np, qj_np = np.asarray(q_idx).T
        ellQ = _ell_maps(qi_np, qj_np, n)
        ellA = _ell_maps(rows_np, cols_np, m)
        ellAt = _ell_maps(cols_np, rows_np, n)
    seg = {name: _on(v, device) for name, v in _segment_maps(
        a_idx, q_idx, n, m, precond_block, (pjA, pjQ), (pcA, pcQ, pc_counts),
        bd).items()}
    diagQ = ordered_segment_sum(
        torch.where(qi == qj, q_data_s, torch.zeros_like(q_data_s)),
        seg["segQ"])
    one = torch.ones((), dtype=dt, device=device)
    return SparseOperator(
        q_data=q_data_s, q_idx=qi_t, a_data=a_data_s, a_idx=ai_t,
        diagQ=diagQ, q=q_s, l=l_s, u=u_s, c=c.reshape(Bn), D=D,
        Dinv=one / D, E=E, Einv=one / E, cost=cost, cinv=one / cost,
        l_finite=l_finite, u_finite=u_finite,
        pjA=_on(pjA, device), pjQ=_on(pjQ, device), pcA=_on(pcA, device),
        pcQ=_on(pcQ, device),
        pc_counts=(None if pc_counts is None else
                   torch.as_tensor(pc_counts, dtype=torch.float64,
                                   device=device)),
        bdA=_on(bd[0], device), bdAsub=_on(bd[1], device),
        bdQ=_on(bd[2], device), bdQsub=_on(bd[3], device), bd_shape=bd[4],
        ellQ=_on(ellQ, device), ellA=_on(ellA, device),
        ellAt=_on(ellAt, device), **seg)
