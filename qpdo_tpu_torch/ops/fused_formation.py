"""Fused KKT formation K = A' diag(w) A + Q + sigma*I, batched.

Replaces the TPU kernel ``qpdo_tpu/ops/pallas_formation.py:_kernel``
(l.24, entry ``fused_formation`` l.101).  On a CUDA tensor the wrapper
launches the hand-written kernel ``qpdo_tpu_torch/csrc/formation.cu`` (its
header says what bounds it on the H100 and how the design answers); on a
CPU tensor it runs ``reference_formation``, the same function as plain
tensor code.  ``ops/linalg.form_kkt`` calls it, so every formation of the
dense path (the ns step, the explicit inverse and the chol Newton solve)
goes through this one kernel.
"""

from __future__ import annotations

import collections

import torch

from .. import kernels


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
    dtype, in the Counter ``fused_formation.launches``); CPU tensors take
    the plain version."""
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
    kernels.launch("formation", A.dtype, (A, w, Q, sigma, K), (B, m, n))
    fused_formation.launches[A.dtype] += 1
    return K


fused_formation.launches = collections.Counter()
