"""Sharded leaves as DTensors: the port's counterpart of the JAX package's
``NamedSharding`` over a 1-D mesh.

A leaf sharded over a mesh axis is a ``torch.distributed.tensor.DTensor``
with ``Shard(dim)`` on a 1-D ``DeviceMesh``; each rank holds the block
``torch.chunk`` gives it (DTensor's own rule) and reads it with
``.to_local()``.  A replicated leaf is a plain tensor, the same on every
rank.  ``full_tensor`` reads a whole DTensor with ``dist.all_gather``,
which the gloo backend takes on CUDA tensors too: DTensor's own
``full_tensor()`` goes through ``all_gather_into_tensor``, and over gloo
on CUDA tensors that ended the process with a segmentation fault (torch
2.11 on an H100, ``chip_smoke.py`` phase 16).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def group_of(mesh):
    """The process group of a 1-D ``DeviceMesh``."""
    if mesh.ndim != 1:
        raise ValueError(f"a 1-D DeviceMesh is needed, got {mesh.ndim}-D")
    return mesh.get_group()


def mesh_of(mesh, device, axis: str):
    """``mesh``, or a 1-D mesh named ``axis`` over every rank of the
    default group on ``device``'s type."""
    if mesh is not None:
        return mesh
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(torch.device(device).type,
                      torch.arange(dist.get_world_size()),
                      mesh_dim_names=(axis,))


def chunk_bounds(n: int, size: int, rank: int):
    """[lo, hi) of rank ``rank``'s block of n entries split over ``size``
    ranks as ``torch.chunk`` (and ``Shard``) splits them."""
    c = -(-n // size)
    lo = min(rank * c, n)
    return lo, min(lo + c, n)


def local_block(t, mesh, dim: int = 0):
    """This rank's block of a tensor that every rank holds whole: a
    DTensor's local shard, or the ``torch.chunk`` block of a plain
    tensor (or array)."""
    if is_dtensor(t):
        return t.to_local()
    t = torch.as_tensor(t)
    group = group_of(mesh)
    lo, hi = chunk_bounds(t.shape[dim], dist.get_world_size(group),
                          dist.get_rank(group))
    return t.narrow(dim, lo, hi - lo)


def dtensor_from_local(local, mesh, dim: int = 0, n_global=None):
    """A DTensor split over ``mesh`` along ``dim`` from this rank's block
    (blocks as ``torch.chunk`` makes them; ``n_global`` None: equal blocks
    on every rank)."""
    if n_global is None:
        n_global = local.shape[dim] * mesh.size()
    shape = list(local.shape)
    shape[dim] = n_global
    stride = [1] * len(shape)
    for k in range(len(shape) - 2, -1, -1):
        stride[k] = stride[k + 1] * shape[k + 1]
    return DTensor.from_local(local.contiguous(), mesh, [Shard(dim)],
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def to_local(t):
    """A DTensor's local block; anything else as given."""
    return t.to_local() if is_dtensor(t) else t


def full_tensor(t):
    """The whole of a DTensor on every rank (every rank must call it), by
    ``dist.all_gather``; a plain tensor as given."""
    if not is_dtensor(t):
        return t
    placement = t.placements[0]
    local = t.to_local()
    if not placement.is_shard():
        return local
    dim = placement.dim
    group = t.device_mesh.get_group()
    size = dist.get_world_size(group)
    n = t.shape[dim]
    c = -(-n // size)
    if local.shape[dim] < c:
        pad = list(local.shape)
        pad[dim] = c - local.shape[dim]
        local = torch.cat([local, local.new_zeros(pad)], dim=dim)
    parts = [torch.empty_like(local) for _ in range(size)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, n)
