"""Build and load the native QPS parser (``qps_parser.cpp``) with ctypes.

The port's own copy of ``qpdo_tpu/native/loader.py``.  The shared library
is compiled with ``g++`` (``$CXX`` when set) at first use, never at
import, into ``build/qpdo_tpu_torch_native/`` at the repository root
(beside the CUDA kernels' ``build/qpdo_tpu_torch_kernels/``), under a name
that hashes the source and the flags, so that an edited source is rebuilt;
nothing is written into the source tree.  A failed build raises
``NativeBuildError``: nothing falls back to the Python reader unasked.
"""

from __future__ import annotations

import ctypes
import gzip
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "qps_parser.cpp"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native parser could not be built or loaded."""


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "qpdo_tpu_torch_native"


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return build_dir() / f"libqpdo_native_{digest.hexdigest()[:16]}.so"


def build_native(force: bool = False) -> str:
    """Compile the shared library (once per source version; ``force``
    rebuilds) and return its path.  The library is written to a temporary
    name and renamed, so processes that build at once never load half a
    file."""
    out = _library_path()
    with _lock:
        if out.exists() and not force:
            return str(out)
        out.parent.mkdir(parents=True, exist_ok=True)
        cxx = os.environ.get("CXX", "g++")
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            tmp_lib = Path(tmp) / out.name
            cmd = [cxx, *_FLAGS, str(_SRC), "-o", str(tmp_lib)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except OSError as e:
                raise NativeBuildError(f"cannot run {cxx}: {e}") from e
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"{' '.join(cmd)} failed with exit code "
                    f"{proc.returncode}:\n{(proc.stdout + proc.stderr)[-4000:]}")
            os.replace(tmp_lib, out)
        return str(out)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e}") from e
    H = ctypes.c_void_p
    lib.qps_parse.restype = H
    lib.qps_parse.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.qps_error.restype = ctypes.c_char_p
    lib.qps_error.argtypes = [H]
    lib.qps_name.restype = ctypes.c_char_p
    lib.qps_name.argtypes = [H]
    for fn in ("qps_n", "qps_m_struct", "qps_m_total", "qps_q_nnz",
               "qps_a_nnz"):
        getattr(lib, fn).restype = ctypes.c_long
        getattr(lib, fn).argtypes = [H]
    lib.qps_obj_const.restype = ctypes.c_double
    lib.qps_obj_const.argtypes = [H]
    lp = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
    dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.qps_copy_q.restype = None
    lib.qps_copy_q.argtypes = [H, lp, lp, dp]
    lib.qps_copy_a.restype = None
    lib.qps_copy_a.argtypes = [H, lp, lp, dp]
    lib.qps_copy_qlin.restype = None
    lib.qps_copy_qlin.argtypes = [H, dp]
    lib.qps_copy_bounds.restype = None
    lib.qps_copy_bounds.argtypes = [H, dp, dp]
    lib.qps_destroy.restype = None
    lib.qps_destroy.argtypes = [H]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native parser builds and loads here."""
    try:
        _load()
        return True
    except Exception:
        return False


def read_qps_native(path_or_text, dense: bool = True):
    """Parse a QPS file with the native parser.  Accepts a path
    (optionally .gz) or raw text.  Returns a
    ``qpdo_tpu_torch.io.qps.QPSData``; with ``dense=False`` the Q/A
    members are scipy.sparse CSR matrices, the form large Maros-Mészáros
    instances need, ready for ``solve_sparse``."""
    from ..io.qps import QPSData

    if os.path.exists(str(path_or_text)):
        p = str(path_or_text)
        with (gzip.open(p, "rb") if p.endswith(".gz") else open(p, "rb")) as f:
            raw = f.read()
    else:
        raw = (path_or_text.encode() if isinstance(path_or_text, str)
               else path_or_text)

    lib = _load()
    h = lib.qps_parse(raw, len(raw))
    if not h:
        raise MemoryError("qps_parse allocation failed")
    try:
        err = lib.qps_error(h)
        if err:
            raise ValueError(f"QPS parse error: {err.decode()}")
        n = lib.qps_n(h)
        m_struct = lib.qps_m_struct(h)
        m_total = lib.qps_m_total(h)
        name = lib.qps_name(h).decode()
        c = lib.qps_obj_const(h)

        q_nnz = lib.qps_q_nnz(h)
        qi = np.empty(q_nnz, np.int64)
        qj = np.empty(q_nnz, np.int64)
        qv = np.empty(q_nnz, np.float64)
        lib.qps_copy_q(h, qi, qj, qv)

        a_nnz = lib.qps_a_nnz(h)
        ai = np.empty(a_nnz, np.int64)
        aj = np.empty(a_nnz, np.int64)
        av = np.empty(a_nnz, np.float64)
        lib.qps_copy_a(h, ai, aj, av)

        qlin = np.empty(n, np.float64)
        lib.qps_copy_qlin(h, qlin)
        l = np.empty(m_total, np.float64)
        u = np.empty(m_total, np.float64)
        lib.qps_copy_bounds(h, l, u)
    finally:
        lib.qps_destroy(h)

    if dense:
        Q = np.zeros((n, n))
        np.add.at(Q, (qi, qj), qv)
        A = np.zeros((m_total, n))
        np.add.at(A, (ai, aj), av)
    else:
        import scipy.sparse as sps
        # duplicate triplets accumulate, same semantics as np.add.at
        Q = sps.coo_matrix((qv, (qi, qj)), shape=(n, n)).tocsr()
        A = sps.coo_matrix((av, (ai, aj)), shape=(m_total, n)).tocsr()
    return QPSData(name=name, Q=Q, q=qlin, c=c, A=A, l=l, u=u,
                   n_structural=int(m_struct))
