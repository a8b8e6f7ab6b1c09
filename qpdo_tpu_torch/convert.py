"""Turn the JAX package's data into the port's.

The tests run both packages on the same inputs and from the same states.
These functions read the JAX package's containers field by field through
``numpy.asarray`` (which every JAX array supports), so the port still
imports no JAX: ``problem``, ``scaled_problem`` and ``state`` take batched
containers (a leading batch axis on every leaf, as ``jax.vmap`` produces
them) and ``settings`` takes a ``qpdo_tpu.types.Settings``.  Every function
that makes tensors takes the device to put them on; none has a default.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import Problem, Scaling, ScaledProblem, Settings, SolverState


def tensor(a, device) -> torch.Tensor:
    """One array-like as a tensor (a copy, so it owns its memory)."""
    return torch.from_numpy(np.array(a)).to(device)


def _fields(cls, src, device):
    return cls(*[None if getattr(src, f) is None
                 else tensor(getattr(src, f), device) for f in cls._fields])


def problem(p, device) -> Problem:
    """A batched ``qpdo_tpu.types.Problem`` as a port ``Problem``."""
    return _fields(Problem, p, device)


def scaled_problem(sp, device) -> ScaledProblem:
    """A batched ``qpdo_tpu.types.ScaledProblem``."""
    return ScaledProblem(
        data=problem(sp.data, device),
        scaling=_fields(Scaling, sp.scaling, device),
        l_finite=tensor(sp.l_finite, device),
        u_finite=tensor(sp.u_finite, device),
        norm_q=tensor(sp.norm_q, device))


def state(s, device) -> SolverState:
    """A batched ``qpdo_tpu.types.SolverState``; its ``kkt_cache`` is None,
    one array (the inv/ns inverse) or the incremental pair
    (K_tilde, w_applied), which stays a pair."""
    out = _fields(SolverState, s._replace(kkt_cache=None), device)
    cache = s.kkt_cache
    if isinstance(cache, tuple):
        cache = tuple(tensor(a, device) for a in cache)
    elif cache is not None:
        cache = tensor(cache, device)
    return out._replace(kkt_cache=cache)


def settings(s) -> Settings:
    """A ``qpdo_tpu.types.Settings`` (or any object with the same fields)."""
    return Settings(**{f.name: getattr(s, f.name)
                       for f in dataclasses.fields(Settings)})
