"""Device meshes over the ranks of a torch.distributed run (port of
parallel/mesh.py).

The models here have at most 37M parameters, so every rank holds all of
them (the JAX package replicates them over its mesh; here each process
keeps its own identically seeded copy, and data-parallel training
all-reduces the gradients). The batch is split over the 'data' axis;
the guidance MC set can also be split over an 'mc' axis, whose importance-
weight reductions (row max, the p̄ and Z̄ means, Σw·X1) become all-reduces
over the mc group (sample/guided.py:mc_feng_guidance), exactly.

A mesh is a `torch.distributed.device_mesh.DeviceMesh`; JAX's
NamedSharding helpers (`batch_sharding`, `replicated_sharding`,
`replicate`) have no torch counterpart: a rank holds plain tensors, its
rows of a sharded batch (`shard_batch`) or the whole of a replicated one.
`None` stands for the one-process mesh, whose every axis has size 1.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch.distributed as dist


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data",),
              axis_sizes: Optional[Sequence[int]] = None):
    """A DeviceMesh over the first `n_devices` ranks (default: all),
    shaped `axis_sizes` (default: (n, 1, ...)), e.g. ('data', 'mc') with
    (1, 2) to split the MC set over two ranks. Rank r sits at the row-major
    coordinates of r. Without a process group and for n = 1: None (the
    one-process mesh)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else int(n_devices)
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(a) for a in axis_sizes)
    size = 1
    for a in axis_sizes:
        size *= a
    if size != n or len(axis_sizes) != len(axis_names):
        raise ValueError(f"mesh {dict(zip(axis_names, axis_sizes))} does "
                         f"not cover {n} ranks")
    if n == 1 and not dist.is_initialized():
        return None
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a run of {world}: the "
                         "mesh spans every rank")
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, axis_sizes,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of the ranks that share every other coordinate
    (None for an axis of size 1: nothing to reduce)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def shard_batch(mesh, tree, axis: str = "data"):
    """This rank's contiguous rows of every [B, ...] entry of `tree` (a
    tensor, an array, or a dict / tuple / list of them) along `axis`."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)

    def one(v):
        if len(v) % n:
            raise ValueError(f"batch axis {len(v)} not divisible by the "
                             f"{axis!r} axis size {n}")
        per = len(v) // n
        return v[i * per:(i + 1) * per]

    if isinstance(tree, dict):
        return {k: one(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(one(v) for v in tree)
    return one(tree)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m

