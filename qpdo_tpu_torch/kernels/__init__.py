"""Build and load the port's CUDA kernels (``qpdo_tpu_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` into one shared library with a
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
implementation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("formation.cu", "residuals.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# pointer arguments of each entry point; then come B, m, n and the stream
_POINTERS = {"formation": 5, "residuals": 22}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
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


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source version) and load the kernel library."""
    nvcc = find_nvcc()
    sources = [CSRC / s for s in SOURCES]
    digest = hashlib.sha256()
    for p in sources:
        digest.update(p.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"libqpdo_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        Path(str(out) + ".log").write_text(
            " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise KernelError(f"nvcc failed with exit code {proc.returncode}:\n"
                              + proc.stderr[-4000:])
        os.replace(tmp, out)
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        raise KernelError(f"cannot load {out}: {e}") from e
    for name in _POINTERS:
        for suffix in _SUFFIX.values():
            fn = getattr(lib, f"qpdo_{name}_{suffix}")
            fn.argtypes = ([ctypes.c_void_p] * _POINTERS[name]
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
    lib.qpdo_error_string.argtypes = [ctypes.c_int]
    lib.qpdo_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, dtype: torch.dtype, device: torch.device,
           tensors, sizes) -> None:
    """Launch kernel ``name`` for ``dtype`` on the current stream of
    ``device``: ``tensors`` become pointers, ``sizes`` (B, m, n) C ints."""
    suffix = _SUFFIX.get(dtype)
    if suffix is None:
        raise KernelError(f"{name}: no kernel for dtype {dtype}")
    lib = library()
    fn = getattr(lib, f"qpdo_{name}_{suffix}")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*[t.data_ptr() for t in tensors], *sizes, stream)
    if err != 0:
        raise KernelError(f"{name} kernel launch failed: CUDA error {err} "
                          f"({lib.qpdo_error_string(err).decode()})")
