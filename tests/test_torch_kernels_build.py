"""The PyTorch port's kernel table and build, and its KKT wrappers'
argument checks, on the CPU (no nvcc needed: the compiler is a stand-in).
"""

import re
import stat

import pytest
import torch

from qpdo_tpu_torch import kernels
from qpdo_tpu_torch.ops import fused_kkt as tkkt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_wrappers_check_their_arguments():
    Q = torch.zeros((2, 3, 3))
    A = torch.zeros((2, 5, 3))
    w = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="sigma"):
        tkkt.fused_kkt_solve(Q, A, w, torch.zeros(3), torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="rhs"):
        tkkt.fused_kkt_solve(Q, A, w, torch.zeros(2), torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="K must be"):
        tkkt.chol_solve_stacked(torch.zeros((2, 3, 4)), torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="rhs"):
        tkkt.chol_solve_stacked(Q, torch.zeros((3, 3)))


# ---------------------------------------------------------------------------
# the C interface and the build
# ---------------------------------------------------------------------------

def test_kernel_table_matches_the_c_entry_points():
    """Every entry of the ctypes table has a C function of that many
    pointers and ints, then the stream."""
    text = "".join((kernels.CSRC / s).read_text() for s in kernels.SOURCES)
    for header in kernels.HEADERS:           # hashed with the sources
        assert f'#include "{header}"' in text
        assert (kernels.CSRC / header).is_file()
    text = re.sub(r"\\\n", "\n", text)                 # macro continuations
    found = {}
    for m in re.finditer(r'extern "C" int (\w+)\((.*?)\)\s*{', text, re.S):
        params = [p.strip() for p in m.group(2).split(",")]
        if params == [""]:
            continue                                   # the max_n queries
        if m.group(1) in ("qpdo_kkt_cluster_size",
                          "qpdo_kkt_cluster_max_active"):
            assert params == ["int n"]                 # queries of n, no stream
            continue
        if m.group(1).endswith("_phase_clocks"):
            continue                   # only with -DQPDO_PHASE_CLOCKS
        assert params[-1] == "void* stream", m.group(0)
        pointers = sum("void*" in p for p in params[:-1])
        ints = sum(p.startswith("int ") for p in params[:-1])
        assert pointers + ints == len(params) - 1
        names = [m.group(1)]
        if names == ["NAME"]:                          # residuals.cu's macro
            names = re.findall(r"^QPDO_RESIDUALS_ENTRY\((\w+),", text, re.M)
        for name in names:
            kernel, suffix = re.fullmatch(r"qpdo_(\w+)_(f32|f64)",
                                          name).groups()
            found[(kernel, suffix)] = (pointers, ints)
    want = {(name, kernels._SUFFIX[dt]): (p, i)
            for name, (p, i, dts) in kernels._KERNELS.items() for dt in dts}
    assert found == want
    assert "kkt_solve.cu" in kernels.SOURCES
    for name in kernels.SHARED_MAX_N:
        assert f'extern "C" int qpdo_{name}_shared_max_n()' in text


def _fake_nvcc(path, fail_on=None):
    """A stand-in compiler: writes its output file, logs its arguments,
    fails for a source whose name contains ``fail_on``."""
    path.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        'echo "ptxas info: $*"\n'
        + (f'case "$*" in *{fail_on}*) echo "boom" >&2; exit 3;; esac\n'
           if fail_on else "")
        + 'echo built > "$out"\n')
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_build_compiles_each_source_then_links(tmp_path):
    out = tmp_path / "build" / "libtest.so"
    sources = [kernels.CSRC / s for s in kernels.SOURCES]
    kernels._build(_fake_nvcc(tmp_path / "nvcc"), sources, out)
    assert out.read_text() == "built\n"
    log = (tmp_path / "build" / "libtest.so.log").read_text()
    for s in kernels.SOURCES:
        assert f"-c -o" in log and s in log
    assert "-shared" in log.splitlines()[-2]
    assert list(out.parent.iterdir()).__len__() == 2      # library and log


def test_build_failure_raises_and_leaves_no_library(tmp_path):
    out = tmp_path / "build" / "libtest.so"
    sources = [kernels.CSRC / s for s in kernels.SOURCES]
    nvcc = _fake_nvcc(tmp_path / "nvcc", fail_on="kkt_solve")
    with pytest.raises(kernels.KernelError, match="exit code 3"):
        kernels._build(nvcc, sources, out)
    assert not out.exists()
    assert "boom" in (tmp_path / "build" / "libtest.so.log").read_text()
