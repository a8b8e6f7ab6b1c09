"""Batched and distributed solving.

The JAX package's distributed paths on ``torch.distributed``; how its
model maps onto PyTorch's:

- Processes.  JAX is single-controller: one program sees global arrays.
  ``torch.distributed`` is multi-controller: one process per device, and
  every rank calls the same function with the same arguments
  (``multihost.initialize`` joins the ranks).
- The ``mesh`` argument is a 1-D ``torch.distributed.device_mesh.
  DeviceMesh``, named by its ``mesh_dim_names`` (``multihost.global_mesh``).
- A ``NamedSharding`` over the batch or scenario axis is a ``DTensor``
  with ``Shard(dim)`` (``dtensor.py``); a replicated leaf is a plain
  tensor, the same on every rank.  ``shard_problems`` splits a batch
  that every rank holds; ``multihost.distribute_batch`` assembles one
  from each rank's own problems (``DTensor.from_local``, equal sizes, as
  in JAX).  Result leaves are DTensors of the global shape: each rank
  reads its block with ``.to_local()`` (JAX's ``addressable_shards``)
  and the whole with ``full_tensor``.
- Inside a solve there are only local tensors and explicit collectives
  on the mesh's process group, ``all_reduce`` (SUM, MAX), ``all_gather``
  and ``broadcast``, which gloo takes on CUDA tensors too: the operators
  carry a comm (``comm.py``) through which the core reduces over a split
  axis.  ``solve_batch`` takes DTensor leaves.

Modules: ``batch.py`` (the lock-step batch, and split over ranks),
``row_sharded.py`` (one QP's rows split over ranks), ``multihost.py``,
``dtensor.py``, ``comm.py``.  The sharded Schur solve is
``ops/schur.arrow_solve_sharded``, the sharded sparse fleet
``api.solve_sparse_batch(mesh=)``, the service ``SolverService(mesh=)``
and the scenario-sharded structured solve ``solver/structured.py``.
"""

from . import multihost
from .batch import shard_problems, solve_batch, solve_batch_sharded
from .dtensor import full_tensor
from .row_sharded import solve_row_sharded

__all__ = ["solve_batch", "solve_batch_sharded", "shard_problems",
           "solve_row_sharded", "multihost", "full_tensor"]
