"""Process meshes for batch-parallel sweeps and the row-sharded GP (port of
``parallel/sharding.py``).

The JAX package shards a batch axis over a ``jax.sharding.Mesh`` and lets
XLA insert the collectives. Here a mesh is the ``torch.distributed``
process group the caller started: one process per card, each holding a
contiguous block of the rows, and the collectives written out
(``gather_rows``, ``psum``, ``pmax``). Without an initialised process group
the mesh is a world of one on the resolved device, and every collective is
the identity, so the same code runs on one card with no group at all.

Every rank must call the same collectives in the same order, as with any
``torch.distributed`` program. ``all_gather`` into a list (then
``torch.cat``) and ``all_reduce`` are the only collectives used: gloo on the
CPU has no ``all_gather_into_tensor``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from .._device import resolve_device


class Mesh(NamedTuple):
    """A 1-D mesh of ``world_size`` processes along ``axis_name``; this
    process is ``rank`` and computes on ``device``. ``group`` is ``None``
    for a world of one without a process group."""

    world_size: int
    rank: int
    group: object
    device: torch.device
    axis_name: str = "batch"


class ShardSpec(NamedTuple):
    """Where an array lives on a mesh: rows split along ``axis_name``, or
    replicated on every rank (``axis_name`` ``None``)."""

    mesh: Mesh
    axis_name: str | None


def make_mesh(n_devices: int | None = None, axis_name: str = "batch", device=None) -> Mesh:
    """The mesh over the initialised process group (gloo on the CPU, NCCL
    on cards), or a world of one on the resolved device when there is none.
    ``n_devices`` larger than the world raises; ``n_devices=1`` under a
    group gives each rank a world of its own; any other count must be the
    world's size (a mesh spans the whole group)."""
    dev = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices, have {world}")
    if n_devices == world:
        return Mesh(world, rank, group, dev, axis_name)
    if n_devices == 1:
        return Mesh(1, 0, None, dev, axis_name)
    raise ValueError(f"a mesh spans the whole process group: requested {n_devices} of "
                     f"{world} processes")


def batch_sharding(mesh: Mesh, axis_name: str = "batch") -> ShardSpec:
    """Shard the leading axis across the mesh; everything else replicated."""
    return ShardSpec(mesh, axis_name)


def replicated_sharding(mesh: Mesh) -> ShardSpec:
    return ShardSpec(mesh, None)


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``n`` rows; ``n`` must divide by the
    world's size (``shard_map``'s rule)."""
    if n % mesh.world_size:
        raise ValueError(f"{n} rows do not divide over {mesh.world_size} ranks")
    block = n // mesh.world_size
    return slice(mesh.rank * block, (mesh.rank + 1) * block)


def shard_batch(array, mesh: Mesh, axis_name: str = "batch") -> torch.Tensor:
    """This rank's contiguous block of ``array``'s rows, on the mesh's
    device."""
    t = torch.as_tensor(array)
    return t[shard_rows(t.shape[0], mesh)].to(mesh.device)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order (JAX's tiled
    ``all_gather``)."""
    if mesh.group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=0)


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum over the ranks (a new tensor; ``t`` is left as it was)."""
    if mesh.group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def pmax(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The maximum over the ranks."""
    if mesh.group is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.group)
    return out
