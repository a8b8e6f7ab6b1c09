"""Fused KKT formation K = A' diag(w) A + Q + sigma*I, batched.

Replaces the TPU kernel ``qpdo_tpu/ops/pallas_formation.py:_kernel``
(l.24, entry ``fused_formation`` l.101).  On a CUDA tensor the wrapper
launches the hand-written kernel ``qpdo_tpu_torch/csrc/formation.cu`` (its
header says what bounds it on the H100 and how the design answers); on a
CPU tensor it runs ``reference_formation``, the same function as plain
tensor code.  ``ops/linalg.form_kkt`` calls it, so every formation of the
dense path (the ns step, the explicit inverse and the chol Newton solve)
goes through this one kernel.

Where a few problems have many rows (B times the tile pairs of K well
below the card's SM count), the kernel splits the rows of A into
``formation_splits`` chunks, one block each, and a second pass adds the
chunks' partial sums in a fixed order: two calls give the same bits.
"""

from __future__ import annotations

import collections
import functools

import torch

from .. import kernels

# rows of A a chunk of the split route walks at least: 8 stages of the
# kernel's 32 rows, so that a block's set-up and its write of a partial
# tile stay small beside its multiply-adds
SPLIT_MIN_ROWS = 256


def tile_pairs(n: int) -> int:
    """Blocks of the unsplit kernel a problem takes: the tile pairs
    (row tile <= column tile) of K, with the kernel's tile edge (32, 64 or
    128: the smallest that covers n)."""
    tile = 32 if n <= 32 else 64 if n <= 64 else 128
    t = -(-n // tile)
    return t * (t + 1) // 2


def formation_splits(B: int, m: int, n: int, sms: int) -> int:
    """The number of chunks S the kernel splits the m rows into, from the
    shape and the card's SM count ``sms`` alone (in either dtype).
    1 (the unsplit kernel) where the unsplit grid of B x tile pairs
    blocks already fills the SMs once or m is too short to split; else as
    many chunks as fill the SMs once (one wave: at B=1, n=200 on an H100
    it beat 1.5 to 6 waves, scripts/sweep_formation_splits.py), each of at
    least ``SPLIT_MIN_ROWS`` rows.  The kernel rounds each chunk up to
    whole stages and may use fewer chunks (``chunk_rows`` in
    csrc/formation.cu)."""
    return max(1, min(sms // (B * tile_pairs(n)), m // SPLIT_MIN_ROWS))


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def reference_formation(A, w, Q, sigma):
    """Plain version: explicit row scale + batched GEMM (the JAX
    package's ``reference_formation``, product order A' (w ∘ A))."""
    Aw = A * w[..., None]
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return torch.matmul(A.mT, Aw) + Q + sigma[:, None, None] * eye


def _check(A, w, Q, sigma):
    if A.dim() != 3:
        raise ValueError(f"A must be (B, m, n), got {tuple(A.shape)}")
    B, m, n = A.shape
    shapes = {"w": (w, (B, m)), "Q": (Q, (B, n, n)), "sigma": (sigma, (B,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != A.dtype or t.device != A.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; A is "
                             f"{A.dtype} on {A.device}")
    return B, m, n


def fused_formation(A, w, Q, sigma):
    """K = A' diag(w) A + Q + sigma*I for A (B, m, n), w (B, m),
    Q (B, n, n), sigma (B,), all of one dtype (float32 or float64) on one
    device.  CUDA tensors launch the kernel (and count the launch, by
    dtype, in the Counter ``fused_formation.launches``, and those that
    split the rows also in ``fused_formation.split_launches``); CPU
    tensors take the plain version."""
    B, m, n = _check(A, w, Q, sigma)
    if A.device.type == "cpu":
        return reference_formation(A, w, Q, sigma)
    if A.device.type != "cuda":
        raise ValueError(f"fused_formation: unsupported device {A.device}")
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_formation: unsupported dtype {A.dtype}")
    for name, t in (("A", A), ("w", w), ("Q", Q), ("sigma", sigma)):
        if not t.is_contiguous():
            raise ValueError(f"fused_formation: {name} must be contiguous")
    K = torch.empty((B, n, n), dtype=A.dtype, device=A.device)
    splits = formation_splits(B, m, n, sm_count(A.get_device()))
    partial = (torch.empty((B, splits, n, n), dtype=A.dtype, device=A.device)
               if splits > 1 else None)
    kernels.launch("formation", A.dtype, (A, w, Q, sigma, K, partial),
                   (B, m, n, splits))
    fused_formation.launches[A.dtype] += 1
    if splits > 1:
        fused_formation.split_launches[A.dtype] += 1
    return K


fused_formation.launches = collections.Counter()
fused_formation.split_launches = collections.Counter()
