"""Ordered segment sums: every sum of the sparse path into a shared target,
added in map order on every device.

The sparse operator adds terms into shared targets (the block-Jacobi
blocks, the coarse matrix and its restriction, the banded blocks,
diag(K), the scatter matvecs, setup's diag(Q)).  The JAX package does it
with ``.at[].add``, which the TPU runs in a fixed order.  The port's
plain version is ``index_add_``: on the CPU it adds term by term in index
order, but on a CUDA tensor it adds with atomics, whose order changes
from run to run.  So a *segment map* is built once per pattern at setup
(``solver/sparse.py:_segment_map``): ``(index, order, offsets)``, the
target of each term in term order, the term indices sorted by target with
a stable sort, and the CSR offsets (targets + 1,) of that order.

On a CUDA tensor ``ordered_segment_sum`` launches the hand-written kernel
``qpdo_tpu_torch/csrc/ordered_sum.cu`` (one thread per problem and
target, its terms added in map order, no atomics), which gives the bits
of the CPU's ``index_add_`` over the same terms; on a CPU tensor it runs
the plain version, ``index_add_`` itself.  The kernel replaces no TPU
kernel: it gives the card the fixed order that XLA's scatter has on the
TPU.
"""

from __future__ import annotations

import collections

import torch

from .. import kernels

_INT32_MAX = 2 ** 31 - 1


def reference_segment_sum(values, seg):
    """Plain version: ``index_add_`` of ``values`` (B, terms) into zeros
    (B, targets) along the map's ``index``."""
    index, _, offsets = seg
    out = torch.zeros((values.shape[0], offsets.shape[0] - 1),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(1, index, values)


def ordered_segment_sum(values, seg):
    """out[b, t] = the terms values[b, k] with index[k] = t, added in term
    order from 0, for ``values`` (B, terms) float32 or float64 and a
    segment map ``seg`` = (index, order, offsets) on the same device.
    Returns (B, targets).  CUDA tensors launch the kernel (and count the
    launch, by dtype, in the Counter ``ordered_segment_sum.launches``);
    CPU tensors take the plain version."""
    index, order, offsets = seg
    if values.dim() != 2 or values.shape[1] != index.shape[0]:
        raise ValueError(f"ordered_segment_sum: values must be (B, "
                         f"{index.shape[0]}), got {tuple(values.shape)}")
    if not (index.device == order.device == offsets.device == values.device):
        raise ValueError(f"ordered_segment_sum: the map is on "
                         f"{index.device}, the values on {values.device}")
    if values.device.type == "cpu":
        return reference_segment_sum(values, seg)
    if values.device.type != "cuda":
        raise ValueError(f"ordered_segment_sum: unsupported device "
                         f"{values.device}")
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ordered_segment_sum: unsupported dtype "
                        f"{values.dtype}")
    if order.dtype != torch.int64 or offsets.dtype != torch.int64:
        raise TypeError("ordered_segment_sum: order and offsets must be int64")
    B, terms = values.shape
    targets = offsets.shape[0] - 1
    if max(B, terms, targets) > _INT32_MAX:
        raise ValueError(f"ordered_segment_sum: sizes {(B, terms, targets)}"
                         f" exceed the kernel's int range")
    out = torch.empty((B, targets), dtype=values.dtype, device=values.device)
    kernels.launch("ordered_sum", values.dtype,
                   (values.contiguous(), order, offsets, out),
                   (B, terms, targets))
    ordered_segment_sum.launches[values.dtype] += 1
    return out


ordered_segment_sum.launches = collections.Counter()
