"""Build and load the port's CUDA kernels (``qpdo_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` (one compiler process per source,
all started together, then one link) into one shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The build runs at the first launch, never at
import: it needs ``nvcc`` and an sm_90a device (NVIDIA Hopper).  The
library lands in ``build/qpdo_tpu_torch_kernels/`` at the repository root
under a name that hashes the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.  The compiler's output
(``-Xptxas -v``: registers, shared memory and spills of every kernel) is
kept beside it as ``<library>.log``.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``launch`` raises
``KernelError`` when that is not 0.  Nothing here falls back to another
implementation.  The first call builds and loads under a lock, so that
two threads that launch at once (a serving worker and its caller) build
the library once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from ..utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("formation.cu", "residuals.cu", "kkt_solve.cu", "kkt_solve_large.cu",
           "kkt_solve_cluster.cu", "ordered_sum.cu")
# included by the sources
HEADERS = ("async_copy.cuh", "cluster.cuh", "phase_clocks.cuh",
           "shared_grant.cuh", "tf32x3.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# entry point qpdo_<name>_<suffix>: (pointer arguments, int arguments,
# dtypes it exists for); the stream comes last
_KERNELS = {
    "formation": (6, 4, (torch.float32, torch.float64)),    # B, m, n, splits
    "residuals": (17, 3, (torch.float32, torch.float64)),   # B, m, n
    "kkt_solve": (6, 3, (torch.float32,)),                  # B, m, n
    "chol_solve": (3, 2, (torch.float32,)),                 # B, n
    "kkt_solve_global": (8, 4, (torch.float32,)),           # B, m, n, splits
    "chol_solve_global": (4, 2, (torch.float32,)),          # B, n
    # kkt_solve_global's factor, kept in its workspace, for another
    # right-hand side: B, n
    "kkt_resolve_global": (3, 2, (torch.float32,)),
    # B, m, n, splits, blocks of a cluster (0: the size for n)
    "kkt_solve_cluster": (8, 5, (torch.float32,)),
    "chol_solve_cluster": (4, 3, (torch.float32,)),         # B, n, cluster
    "ordered_sum": (4, 3, (torch.float32, torch.float64)),  # B, terms, targets
}
# The routes of the KKT kernels by n: K in the registers of one block up
# to REGISTER_MAX_N, in its shared memory up to the shared-memory route's
# limit (one problem's K must fit the 227 KB a block can use:
# ``qpdo_<name>_shared_max_n`` in csrc/kkt_solve.cu), in global memory
# above (csrc/kkt_solve_large.cu).  Kept here so that a wrapper picks the
# route without a query; a card test holds them to ``shared_max_n``.
REGISTER_MAX_N = 128
SHARED_MAX_N = {"kkt_solve": 220, "chol_solve": 239}
# the CUDA toolkit's default install prefix
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched."""


def build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "qpdo_tpu_torch_kernels"


def find_nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, nvcc on PATH, or
    ``DEFAULT_NVCC``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(DEFAULT_NVCC)
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelError(
        f"nvcc not found (looked in $CUDA_HOME/bin, PATH and {DEFAULT_NVCC}):"
        " the CUDA kernels of qpdo_tpu_torch are built "
        f"from {CSRC} at first use and need the CUDA toolkit")


def _build(nvcc: str, sources, out: Path) -> None:
    """Compile every source to an object, all compilers started together,
    then link the objects into ``out``; the log goes beside it."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objects = [str(Path(tmp) / (p.stem + ".o")) for p in sources]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(sources, objects)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        runs = []                      # (command, exit code, output)
        for cmd, proc in zip(cmds, procs):
            stdout, stderr = proc.communicate()
            runs.append((cmd, proc.returncode, stdout + stderr))
        lib_tmp = str(Path(tmp) / out.name)
        if all(rc == 0 for _, rc, _ in runs):
            link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib_tmp, *objects]
            proc = subprocess.run(link, capture_output=True, text=True)
            runs.append((link, proc.returncode, proc.stdout + proc.stderr))
        Path(str(out) + ".log").write_text(
            "".join(" ".join(cmd) + "\n" + text for cmd, _, text in runs))
        failed = [(cmd, rc, text) for cmd, rc, text in runs if rc != 0]
        if failed:
            raise KernelError("\n".join(
                f"nvcc failed with exit code {rc}: {' '.join(cmd)}\n"
                + text[-4000:] for cmd, rc, text in failed))
        os.replace(lib_tmp, out)


_load_lock = threading.Lock()


def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library; the
    threads that call it while the first build runs wait for that build."""
    with _load_lock:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
    nvcc = find_nvcc()
    sources = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256()
    for p in (*sources, *(CSRC / h for h in HEADERS)):
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"libqpdo_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        _build(nvcc, sources, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelError(f"cannot load {out}: {e}") from e
    # (name, dtype) -> (entry point, pointer arguments, int arguments)
    lib.entries = {}
    for name, (pointers, ints, dtypes) in _KERNELS.items():
        for dtype in dtypes:
            fn = getattr(lib, f"qpdo_{name}_{_SUFFIX[dtype]}")
            fn.argtypes = ([ctypes.c_void_p] * pointers
                           + [ctypes.c_int] * ints + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            lib.entries[(name, dtype)] = (fn, pointers, ints)
    for name in SHARED_MAX_N:
        fn = getattr(lib, f"qpdo_{name}_shared_max_n")
        fn.argtypes = []
        fn.restype = ctypes.c_int
    for name in ("qpdo_kkt_cluster_size", "qpdo_kkt_cluster_max_active"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_int
    lib.qpdo_cluster_work_floats.argtypes = [ctypes.c_int] * 3
    lib.qpdo_cluster_work_floats.restype = ctypes.c_longlong
    lib.qpdo_error_string.argtypes = [ctypes.c_int]
    lib.qpdo_error_string.restype = ctypes.c_char_p
    return lib


library.cache_clear = _load.cache_clear


def launch(name: str, dtype: torch.dtype, tensors, sizes) -> None:
    """Launch kernel ``name`` for ``dtype`` on the current stream of the
    CUDA device that holds ``tensors``: they become pointers (None a null
    pointer: a workspace the launch does not use), ``sizes`` (the ints of
    ``_KERNELS``) C ints.  The device is made current only for the
    launch, and only where it is not already."""
    lib = library()
    try:
        fn, pointers, ints = lib.entries[(name, dtype)]
    except KeyError:
        raise KernelError(f"{name}: no kernel for dtype {dtype}") from None
    if len(tensors) != pointers or len(sizes) != ints:
        raise KernelError(f"{name}: takes {pointers} tensors and {ints} sizes,"
                          f" got {len(tensors)} and {len(sizes)}")
    index = tensors[0].get_device()
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with profiling.span("qpdo.launch", name, dtype, sizes):
        if index == torch.cuda.current_device():
            err = fn(*ptrs, *sizes, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*ptrs, *sizes,
                         torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {err} "
                          f"({lib.qpdo_error_string(err).decode()})")


def shared_max_n(name: str) -> int:
    """The largest n of the shared-memory route of kernel ``name``
    ("kkt_solve" or "chol_solve"): one problem's matrix must fit one
    block's shared memory."""
    return int(getattr(library(), f"qpdo_{name}_shared_max_n")())


# The cluster route (csrc/kkt_solve_cluster.cu) keeps its layout in the
# source: the sizes below are the library's answers.
@functools.cache
def cluster_size(n: int) -> int:
    """The blocks of a cluster of the cluster route for n (8 or 16: the
    smaller whose shared memory holds the problem's panels), 0 where
    none does."""
    return int(library().qpdo_kkt_cluster_size(n))


def max_active_clusters(n: int, device: int | None = None) -> int:
    """How many clusters of the cluster route for n the card holds at once
    (``cudaOccupancyMaxActiveClusters``), asked once per device and n; 0
    where n has no cluster."""
    return _max_active(torch.cuda.current_device() if device is None
                       else device, n)


@functools.cache
def _max_active(device: int, n: int) -> int:
    with torch.cuda.device(device):
        count = library().qpdo_kkt_cluster_max_active(n)
    if count < 0:
        raise KernelError(
            f"cudaOccupancyMaxActiveClusters failed for n={n}: CUDA error "
            f"{-count} ({library().qpdo_error_string(-count).decode()})")
    return count
