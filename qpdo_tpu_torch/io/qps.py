"""QPS (MPS + QUADOBJ) reader and writer for Maros-Mészáros-style QP files.

The port's own copy of ``qpdo_tpu/io/qps.py`` (numpy and scipy; the port
imports nothing of the JAX package).  The reference has no loader (its
paper benchmarks Maros-Mészáros via MATLAB, README.md:11-24).  Produces
the solver's canonical form

    minimize 0.5 x'Qx + q'x + c   s.t.   l <= Ax <= u

with variable bounds appended as identity rows of A (the same convention the
OSQP/QPALM Maros-Mészáros harnesses use).

Supported sections: NAME, ROWS (N/L/G/E), COLUMNS, RHS, RANGES, BOUNDS
(UP/LO/FX/FR/MI/PL/BV), QUADOBJ/QMATRIX, OBJSENSE, ENDATA.  Free-format
(whitespace-separated) files are accepted.

One departure from the JAX package's reader: ``read_qps(..., dense=False)``
returns scipy.sparse CSR Q and A built from the parsed triplets (the
native parser's ``dense=False`` contract), where the JAX package's Python
reader ignores ``dense``.  Its command line asks for ``dense=False`` and so
sends ``--sparse`` and large files to the dense solver; the port's sends
them to ``solve_sparse``.  ``to_problem`` and ``solve_qps_data`` take
``device=`` (None is "cuda", as in ``make_problem``).
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Dict, List, Optional, TextIO, Tuple

import numpy as np


@dataclass
class QPSData:
    name: str
    Q: np.ndarray          # (n, n) symmetric, dense or scipy.sparse
    q: np.ndarray          # (n,)
    c: float               # constant term
    A: np.ndarray          # (m, n) constraint rows incl. variable bounds
    l: np.ndarray          # (m,)
    u: np.ndarray          # (m,)
    n_structural: int      # constraint rows before appended bound rows


def _is_number(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def _open(path_or_file) -> TextIO:
    if hasattr(path_or_file, "read"):
        return path_or_file
    p = str(path_or_file)
    if p.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(p, "rb"))
    return open(p)


def read_qps(path_or_file, dense: bool = True) -> QPSData:
    """Parse a QPS file into canonical QP form: dense numpy Q and A, or
    with ``dense=False`` scipy.sparse CSR matrices (duplicate entries add
    up, as in the dense arrays)."""
    fh = _open(path_or_file)

    name = ""
    section = None
    obj_row: Optional[str] = None
    row_sense: Dict[str, str] = {}
    row_order: List[str] = []
    col_order: List[str] = []
    col_index: Dict[str, int] = {}
    a_entries: List[Tuple[int, int, float]] = []   # (row, col, val)
    q_lin: Dict[int, float] = {}
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    q_entries: List[Tuple[int, int, float]] = []
    lb: Dict[int, float] = {}
    ub: Dict[int, float] = {}
    obj_const = 0.0
    maximize = False

    def col_id(name_: str) -> int:
        if name_ not in col_index:
            col_index[name_] = len(col_order)
            col_order.append(name_)
        return col_index[name_]

    row_index: Dict[str, int] = {}

    for raw in fh:
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        if not line[0].isspace():
            parts = line.split()
            section = parts[0].upper()
            if section == "NAME":
                name = parts[1] if len(parts) > 1 else ""
            elif section == "OBJSENSE" and len(parts) > 1:
                maximize = parts[1].upper() in ("MAX", "MAXIMIZE")
            elif section == "ENDATA":
                break
            continue

        parts = line.split()
        if section == "OBJSENSE":
            maximize = parts[0].upper() in ("MAX", "MAXIMIZE")
        elif section == "ROWS":
            sense, rname = parts[0].upper(), parts[1]
            if sense == "N":
                if obj_row is None:
                    obj_row = rname
            else:
                row_sense[rname] = sense
                row_index[rname] = len(row_order)
                row_order.append(rname)
        elif section == "COLUMNS":
            if "'MARKER'" in parts:
                continue  # integer-section markers (INTORG/INTEND) ignored
            cname = parts[0]
            j = col_id(cname)
            for rname, val in zip(parts[1::2], parts[2::2]):
                v = float(val)
                if rname == obj_row:
                    q_lin[j] = q_lin.get(j, 0.0) + v
                elif rname in row_index:
                    a_entries.append((row_index[rname], j, v))
        elif section == "RHS":
            # first token is the RHS set name; may be omitted in free format
            items = parts[1:] if len(parts) % 2 == 1 else parts
            for rname, val in zip(items[0::2], items[1::2]):
                if rname == obj_row:
                    obj_const = -float(val)
                elif rname in row_index:
                    rhs[rname] = float(val)
        elif section == "RANGES":
            items = parts[1:] if len(parts) % 2 == 1 else parts
            for rname, val in zip(items[0::2], items[1::2]):
                if rname in row_index:
                    ranges[rname] = float(val)
        elif section == "BOUNDS":
            btype = parts[0].upper()
            if btype in ("FR", "MI", "PL", "BV"):
                # the variable is the last NON-numeric token: these bound
                # types may carry an ignored trailing value (" MI BND X1 0.0")
                var = next((t for t in reversed(parts[1:])
                            if not _is_number(t)), parts[-1])
                j = col_id(var)
                if btype == "FR":
                    lb[j] = -np.inf
                    ub[j] = np.inf
                elif btype == "MI":
                    lb[j] = -np.inf
                elif btype == "PL":
                    ub[j] = np.inf
                elif btype == "BV":
                    lb[j], ub[j] = 0.0, 1.0
            else:
                j = col_id(parts[-2])
                v = float(parts[-1])
                if btype == "UP":
                    ub[j] = v
                    # MPS quirk: UP with negative value and no LO set implies
                    # lower bound -inf
                    if v < 0 and j not in lb:
                        lb[j] = -np.inf
                elif btype == "LO":
                    lb[j] = v
                elif btype == "FX":
                    lb[j] = ub[j] = v
        elif section in ("QUADOBJ", "QMATRIX"):
            i = col_id(parts[0])
            j = col_id(parts[1])
            q_entries.append((i, j, float(parts[2]), section == "QMATRIX"))
        # other sections ignored

    n = len(col_order)
    m_struct = len(row_order)
    if not dense:
        return _sparse_data(name, n, m_struct, q_entries, q_lin, a_entries,
                            rhs, ranges, row_order, row_index, row_sense,
                            lb, ub, obj_const, maximize)

    Q = np.zeros((n, n))
    for entry in q_entries:
        i, j, v, is_qmatrix = entry
        if is_qmatrix:
            # QMATRIX lists all entries of Q explicitly; duplicates
            # accumulate (same semantics as the native parser and as
            # COLUMNS entries)
            Q[i, j] += v
        else:
            # QUADOBJ lists the lower (or upper) triangle of Q
            Q[i, j] += v
            if i != j:
                Q[j, i] += v

    qvec = np.zeros(n)
    for j, v in q_lin.items():
        qvec[j] = v

    A = np.zeros((m_struct, n))
    for i, j, v in a_entries:
        A[i, j] += v

    l, u = _row_bounds(row_order, row_index, row_sense, rhs, ranges)
    xl, xu, bound_rows = _variable_bounds(n, lb, ub)
    Ab = np.zeros((len(bound_rows), n))
    for k, j in enumerate(bound_rows):
        Ab[k, j] = 1.0
    A_full = np.vstack([A, Ab]) if bound_rows else A
    l_full = np.concatenate([l, xl[bound_rows]])
    u_full = np.concatenate([u, xu[bound_rows]])

    if maximize:
        Q = -Q
        qvec = -qvec
        obj_const = -obj_const

    return QPSData(name=name, Q=Q, q=qvec, c=obj_const, A=A_full,
                   l=l_full, u=u_full, n_structural=m_struct)


def _row_bounds(row_order, row_index, row_sense, rhs, ranges):
    """(l, u) of the structural rows from their senses, RHS and RANGES."""
    m_struct = len(row_order)
    l = np.empty(m_struct)
    u = np.empty(m_struct)
    for rname in row_order:
        i = row_index[rname]
        b = rhs.get(rname, 0.0)
        sense = row_sense[rname]
        if sense == "E":
            lo = hi = b
        elif sense == "L":
            lo, hi = -np.inf, b
        else:  # G
            lo, hi = b, np.inf
        if rname in ranges:
            r = ranges[rname]
            if sense == "L":
                lo = b - abs(r)
            elif sense == "G":
                hi = b + abs(r)
            else:  # E
                lo, hi = (b, b + r) if r >= 0 else (b + r, b)
        l[i], u[i] = lo, hi
    return l, u


def _variable_bounds(n, lb, ub):
    """(xl, xu, bound_rows): the variable bounds (default 0 <= x < inf)
    and the variables whose bounds constrain, each an identity row."""
    xl = np.zeros(n)
    xu = np.full(n, np.inf)
    for j, v in lb.items():
        xl[j] = v
    for j, v in ub.items():
        xu[j] = v

    # only append bound rows that actually constrain
    bound_rows = [j for j in range(n)
                  if xl[j] > -np.inf or xu[j] < np.inf]
    return xl, xu, bound_rows


def _sparse_data(name, n, m_struct, q_entries, q_lin, a_entries, rhs,
                 ranges, row_order, row_index, row_sense, lb, ub, obj_const,
                 maximize) -> QPSData:
    """``read_qps(..., dense=False)``: the parsed entries as CSR matrices,
    never an (n, n) or (m, n) array."""
    import scipy.sparse as sps

    qi, qj, qv = [], [], []
    for i, j, v, is_qmatrix in q_entries:
        qi.append(i)
        qj.append(j)
        qv.append(v)
        if not is_qmatrix and i != j:   # QUADOBJ: one triangle listed
            qi.append(j)
            qj.append(i)
            qv.append(v)
    Q = sps.coo_matrix((qv, (qi, qj)), shape=(n, n)).tocsr()
    qvec = np.zeros(n)
    for j, v in q_lin.items():
        qvec[j] = v
    l, u = _row_bounds(row_order, row_index, row_sense, rhs, ranges)
    xl, xu, bound_rows = _variable_bounds(n, lb, ub)
    ai = [i for i, _, _ in a_entries] + [m_struct + k
                                         for k in range(len(bound_rows))]
    aj = [j for _, j, _ in a_entries] + list(bound_rows)
    av = [v for _, _, v in a_entries] + [1.0] * len(bound_rows)
    A = sps.coo_matrix((av, (ai, aj)),
                       shape=(m_struct + len(bound_rows), n)).tocsr()
    l_full = np.concatenate([l, xl[bound_rows]])
    u_full = np.concatenate([u, xu[bound_rows]])
    if maximize:
        Q = -Q
        qvec = -qvec
        obj_const = -obj_const
    return QPSData(name=name, Q=Q, q=qvec, c=obj_const, A=A, l=l_full,
                   u=u_full, n_structural=m_struct)


def to_problem(data: QPSData, dtype=None, device=None):
    """Parsed QPS data as a solver Problem (a batch of one) on ``device``
    (None is "cuda", as in ``make_problem``); sparse Q/A are densified."""
    import scipy.sparse as sps

    from ..api import make_problem
    dense = lambda M: M.toarray() if sps.issparse(M) else M
    return make_problem(dense(data.Q), data.q, dense(data.A), data.l,
                        data.u, data.c, dtype=dtype, device=device)


def solve_qps_data(data: QPSData, settings=None, dtype=None, device=None):
    """Solve parsed QPS data on the matching path: sparse Q/A (from
    ``read_qps(..., dense=False)`` or ``read_qps_native(..., dense=False)``)
    go through ``solve_sparse`` (matrix-free Newton steps), dense arrays
    through the dense solver; on ``device`` (None is "cuda")."""
    import scipy.sparse as sps

    if sps.issparse(data.Q) or sps.issparse(data.A):
        from ..api import solve_sparse
        return solve_sparse(data.Q, data.q, data.A, data.l, data.u, data.c,
                            settings=settings, dtype=dtype, device=device)
    from ..api import solve
    return solve(to_problem(data, dtype, device), settings)


def write_qps(data_or_problem, path_or_file=None, name: str = "QP") -> str:
    """Write a QP in QPS format (inverse of ``read_qps``).

    Accepts a ``QPSData`` or a solver ``Problem`` of one problem (its
    tensors are read on the host); ``Q``/``A`` may be dense arrays or
    scipy.sparse matrices (sparse inputs are written by nonzero iteration,
    so n >= 5k instances emit in O(nnz)).  Two-sided rows emit an
    L row plus a RANGES entry; one-sided rows emit L/G; equalities emit E.
    Variables are written as free (the solver's canonical form keeps all
    variable bounds as rows of A).  Returns the text; writes to
    ``path_or_file`` when given."""
    import numpy as _np
    import scipy.sparse as _sps

    def _mat(M):
        return M.tocsc() if _sps.issparse(M) else _sps.csc_matrix(
            _np.asarray(M))

    if hasattr(data_or_problem, "n_structural"):
        src = data_or_problem
        c = float(src.c)
        name = src.name or name
    else:
        src = _host_problem(data_or_problem)
        c = float(_np.asarray(src.c))
    Q = _mat(src.Q)
    qv = _np.asarray(src.q)
    A = _mat(src.A)
    A.sort_indices()
    l = _np.asarray(src.l)
    u = _np.asarray(src.u)

    big = 1e19  # treat anything beyond as infinite
    n = Q.shape[0]
    m = A.shape[0]
    lines = [f"NAME          {name}", "ROWS", " N  obj"]
    senses = []
    for i in range(m):
        lo, hi = l[i], u[i]
        if lo == hi:
            s = "E"
        elif hi < big:
            s = "L"
        elif lo > -big:
            s = "G"
        else:
            s = None  # unconstrained row: skip
        senses.append(s)
        if s:
            lines.append(f" {s}  r{i}")
    lines.append("COLUMNS")
    for j in range(n):
        if qv[j] != 0.0:
            lines.append(f"    x{j}  obj  {float(qv[j])!r}")
        for k in range(A.indptr[j], A.indptr[j + 1]):
            i, v = int(A.indices[k]), float(A.data[k])
            if senses[i] and v != 0.0:
                lines.append(f"    x{j}  r{i}  {v!r}")
    lines.append("RHS")
    if c != 0.0:
        lines.append(f"    rhs  obj  {float(-c)!r}")
    for i in range(m):
        s = senses[i]
        if s == "E" or s == "G":
            lines.append(f"    rhs  r{i}  {float(l[i])!r}")
        elif s == "L":
            lines.append(f"    rhs  r{i}  {float(u[i])!r}")
    lines.append("RANGES")
    for i in range(m):
        if senses[i] == "L" and l[i] > -big:
            lines.append(f"    rng  r{i}  {float(u[i] - l[i])!r}")
    lines.append("BOUNDS")
    for j in range(n):
        lines.append(f" FR bnd  x{j}")
    lines.append("QUADOBJ")
    # upper triangle, row-major (i ascending, then j >= i ascending)
    Qu = _sps.triu(Q, k=0, format="csr")
    Qu.sort_indices()
    for i in range(n):
        for k in range(Qu.indptr[i], Qu.indptr[i + 1]):
            j, v = int(Qu.indices[k]), float(Qu.data[k])
            if v != 0.0:
                lines.append(f"    x{i}  x{j}  {v!r}")
    lines.append("ENDATA")
    text = "\n".join(lines) + "\n"
    if path_or_file is not None:
        if hasattr(path_or_file, "write"):
            path_or_file.write(text)
        else:
            with open(path_or_file, "w") as fh:
                fh.write(text)
    return text


def _host_problem(problem):
    """A port ``Problem`` (a batch of one, possibly on a device) as numpy
    arrays of one problem; anything else passes through."""
    import torch

    if not isinstance(problem.Q, torch.Tensor):
        return problem
    if problem.Q.dim() == 3:
        if problem.Q.shape[0] != 1:
            raise ValueError("write_qps takes one problem, got a batch of "
                             f"{problem.Q.shape[0]}")
        problem = type(problem)(*[t[0] for t in problem])
    return type(problem)(*[t.detach().cpu().numpy() for t in problem])
