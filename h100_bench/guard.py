"""The check that a run loads neither JAX nor the JAX package.

The port (``qpdo_tpu_torch``) must run without JAX, and its name begins
with the JAX package's (``qpdo_tpu``), so modules are compared by their
whole top-level name, the part before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "qpdo_tpu"})


def forbidden_modules(names=None) -> list:
    """The loaded modules (``sys.modules`` unless ``names`` is given)
    whose whole top-level name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
