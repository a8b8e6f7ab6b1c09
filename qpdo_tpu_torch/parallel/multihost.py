"""Multi-process runtime helpers on ``torch.distributed``.

Port of ``qpdo_tpu/parallel/multihost.py``.  Scale-out is data-parallel
batch sharding over the ranks of a process group, one process per device
(``torch.distributed`` is multi-controller: every rank runs the same
program, where JAX runs one program over global arrays):

    initialize()                         # per process, before any solve
    mesh = global_mesh("batch")          # every rank, 1-D DeviceMesh
    problems = distribute_batch(local_problems, mesh)
    res = solve_batch(problems)          # or solve_batch_sharded
    res.info.status_val.to_local()       # this rank's problems

A solve of independent problems needs no collective while it runs;
the straggler compaction reduces one count over the ranks per chunk
(``parallel/batch.py``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..types import Problem
from .dtensor import dtensor_from_local


def _default_backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[float] = None) -> None:
    """Join this process to the default process group.

    With ``coordinator_address`` ("host:port"), ``num_processes`` and
    ``process_id`` the group meets at ``tcp://coordinator_address``.
    Without them it reads the environment ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); with
    neither, or when a default group already exists, it does nothing (one
    process).  ``backend`` None is NCCL when a CUDA device is present, gloo
    otherwise; ``timeout`` (seconds) bounds every collective.

    Unlike the JAX package, whose call without arguments wraps
    ``jax.distributed.initialize`` in ``except Exception: pass``
    (multihost.py:36-39), a failed initialization raises here: a process
    that believes it is alone while its peers wait for it would solve the
    wrong problem or hang them."""
    backend = backend or _default_backend()
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator_address is None and num_processes is None:
        if dist.is_initialized():
            return
        env = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
        if not all(k in os.environ for k in env):
            return
        dist.init_process_group(backend, init_method="env://", **kw)
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id together")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kw)


def global_mesh(axis: str = "batch", device_type: Optional[str] = None):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the default
    group, on ``device_type`` (None: "cuda").  Without a default group
    this process forms a group of one (gloo on the CPU, NCCL on a card),
    as ``jax.devices()`` is the one process's devices."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or "cuda"
    if not dist.is_initialized():
        store = dist.HashStore()
        dist.init_process_group("gloo" if device_type == "cpu" else "nccl",
                                store=store, rank=0, world_size=1)
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def distribute_batch(local_problems: Problem, mesh,
                     axis: str = "batch") -> Problem:
    """A batch split over ``mesh`` from each rank's local batch (equal
    sizes on every rank): each leaf becomes a DTensor of the global shape
    (world * local_B, ...) with ``Shard(0)``, this rank's block being its
    own problems."""
    return Problem(*(dtensor_from_local(a, mesh, dim=0)
                     for a in local_problems))
