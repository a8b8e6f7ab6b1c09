"""Checkpoint / resume.

Port of ``qpdo_tpu/utils/checkpoint.py``.  The reference's resume
mechanism is warm starting plus a long-lived workspace (SURVEY.md §5);
here the solver's containers are NamedTuples of tensors, so a checkpoint
is a direct save and load:

- ``save_result``/``load_result``: persist a Result; feeding its x/y into
  ``warm_start`` is the algorithmic resume.
- ``save_pytree``/``load_pytree``: persist any of the port's containers
  (SolverState, ScaledProblem, Result, batched or not) as an ``.npz``.

The tensors go through the CPU into the archive, beside a description of
the container's structure (its types, field names and None fields), which
``load_pytree`` checks against ``like`` before it assigns a single leaf,
as the JAX package checks its treedef: a structure with the same leaf
count but another field order would otherwise take leaves by index.  The
leaves come back onto the device of ``like``'s leaves.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, leaves):
    """The structure string of ``tree``; its tensors are appended to
    ``leaves`` in order."""
    if tree is None:
        return "None"
    if isinstance(tree, tuple):
        parts = [_flatten(v, leaves) for v in tree]
        if hasattr(tree, "_fields"):
            return (type(tree).__name__ + "("
                    + ", ".join(f"{k}={p}" for k, p in
                                zip(tree._fields, parts)) + ")")
        return "(" + ", ".join(parts) + ",)"
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint: unsupported leaf {type(tree).__name__}")
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    if like is None:
        return None
    if isinstance(like, tuple):
        out = [_unflatten(v, leaves) for v in like]
        return type(like)(*out) if hasattr(like, "_fields") else tuple(out)
    return leaves.pop(0)


def save_pytree(path: str, tree) -> None:
    leaves = []
    structure = _flatten(tree, leaves)
    arrays = {f"leaf_{i}": v.detach().cpu().numpy()
              for i, v in enumerate(leaves)}
    np.savez(path, __treedef__=np.frombuffer(structure.encode(),
                                             dtype=np.uint8), **arrays)


def load_pytree(path: str, like):
    """Load the leaves saved by ``save_pytree`` into the structure of
    ``like``, each onto the device of ``like``'s leaf.  Raises
    ``ValueError`` when the stored structure is not ``like``'s."""
    data = np.load(path, allow_pickle=False)
    like_leaves = []
    expected = _flatten(like, like_leaves)
    stored = bytes(data["__treedef__"]).decode()
    if stored != expected:
        raise ValueError("checkpoint treedef mismatch:\n"
                         f"  stored: {stored}\n  expected: {expected}")
    leaves = [torch.from_numpy(data[f"leaf_{i}"]).to(t.device)
              for i, t in enumerate(like_leaves)]
    return _unflatten(like, leaves)


def save_result(path: str, result) -> None:
    save_pytree(path, result)


def load_result(path: str, like):
    return load_pytree(path, like)
