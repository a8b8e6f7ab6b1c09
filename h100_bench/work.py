"""The yardstick of the per-layer roofline metrics: one NVIDIA H100's
published peaks and the work of the port's kernels at their shapes.

Frozen copies, so that a change to the program cannot move the yardstick:
``formation_work`` and ``kkt_work`` are ``chip_smoke.py``'s functions of
the same names, ``bound_s`` its ``bound_ms`` in seconds.  The work is the
algorithm's at the call's shapes, whatever implements it: each input
element read once and each output element written once, in the dtype the
kernel is handed, and the operations (FLOPs) of the computation.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit: HBM3 bytes/s
PEAK_BYTES = 3.35e12
# float64: the FP64 tensor cores (the fastest float64 rate of the card)
PEAK_F64 = 67e12
# float32-accurate work: three TF32 passes on the tensor cores (hi*hi +
# hi*lo + lo*hi, the split that keeps float32's accuracy) at a third of the
# dense TF32 rate of 494.7 TFLOP/s.  SIMT float32 runs at 67 TFLOP/s, so a
# kernel on the CUDA cores reads at most ~40% here; the peak is the fastest
# float32-accurate route, so that no later route can read above 100%.
PEAK_F32_ACCURATE = 494.7e12 / 3
PEAKS = {"float64": PEAK_F64, "float32": PEAK_F32_ACCURATE}
ITEMSIZE = {"float64": 8, "float32": 4}


def formation_work(b, m, n):
    """Kernel 1's work at (b, m, n), K = Q + sigma I + A' diag(w) A: the
    elements it must move (A, w, Q and sigma read once, K written once)
    and its operations: K is symmetric, so its product is one multiply-add
    per row of A and entry on or above the diagonal, m * n * (n + 1)
    operations a problem."""
    return b * m * n + b * m + 2 * b * n * n + b, b * m * n * (n + 1)


def kkt_work(name, b, m, n):
    """Kernel 3's (``kkt_solve*``) or kernel 4's (``chol_solve*``) work at
    (b, m, n): the elements it must move (each input read once, dx written
    once) and its operations (the symmetric product, the Jacobi scale, the
    n^3/3 factor, two n^2 substitutions)."""
    if name.startswith("kkt_solve"):
        return (b * n * n + b * m * n + b * m + b + 2 * b * n,
                b * (m * n * (n + 1) + n ** 3 // 3 + 4 * n * n))
    return b * n * n + 2 * b * n, b * (n ** 3 // 3 + 2 * n * n)


def bound_s(nbytes, flops, peak_flops):
    """The least time for that many bytes and operations on the card, and
    which of the two sets it."""
    by_bytes, by_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def launch_bound_s(entry, dtype, sizes):
    """The least time of one launch of the port's kernel entry ``entry``
    (the name ``qpdo_tpu_torch.kernels.launch`` takes) for ``dtype`` at
    ``sizes`` (its int arguments: B, m, n first for formation and
    kkt_solve*, B, n for chol_solve*); None for an entry with no work
    function here."""
    if entry == "formation":
        elems, flops = formation_work(*sizes[:3])
    elif entry.startswith("kkt_solve"):
        elems, flops = kkt_work(entry, *sizes[:3])
    elif entry.startswith("chol_solve"):
        b, n = sizes[:2]
        elems, flops = kkt_work(entry, b, 0, n)
    else:
        return None
    return bound_s(elems * ITEMSIZE[dtype], flops, PEAKS[dtype])[0]


def launch_roofline(launches, accept):
    """100 times the summed least times of the launches whose (entry,
    dtype) ``accept`` takes over the device time their kernels took;
    ``launches`` maps (entry, dtype, sizes) to [count, device seconds].
    None where no such launch ran on the device."""
    least = spent = 0.0
    for (entry, dtype, sizes), (count, seconds) in launches.items():
        if accept(entry, dtype):
            least += count * launch_bound_s(entry, dtype, sizes)
            spent += seconds
    return 100.0 * least / spent if spent > 0 else None
