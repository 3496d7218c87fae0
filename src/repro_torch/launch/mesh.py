"""Device meshes over the ranks of a ``torch.distributed`` world.

The port of ``repro/launch/mesh.py``. A rank is one device:
``cuda:{local rank}`` on a card (one process per card), the CPU under
gloo. Axes:

* ``pod``   — data parallelism between pods (the gradient all-reduce
  crosses pods);
* ``data``  — FSDP within a pod (parameters and optimizer state split,
  gathered per layer) and data parallelism;
* ``model`` — tensor/sequence parallelism and the experts of
  ``moe_a2a``.

``make_production_mesh`` builds JAX's dry-run meshes (256 and 512 ranks),
``make_mesh_for`` the elastic runtime's ("data", "model") meshes; both go
through ``make_mesh``.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int], names: Sequence[str], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over ranks ``[0,
    prod(shape))`` of the default group, in row-major order (JAX's device
    order for ``jax.make_mesh``).

    Building a ``DeviceMesh`` creates one group for each line along each
    axis with ``new_group``, which every rank of the world must call, bound
    or not: call this on every rank, with the same arguments. A rank
    outside the mesh gets it back with no coordinate
    (``mesh.get_coordinate()`` is None). The groups live until the world
    is destroyed, so a caller that rebinds keeps one mesh for each shape
    (as ``ElasticRuntime`` does). The mesh also carries ``flat_groups``:
    for each set of two or more of its axes that have more than one rank,
    in the mesh's order, this rank's group over the flattened axes, built
    here alike. Its ranks in rank order are JAX's block order over those
    axes (``coord_a * size_b + coord_b`` for axes (a, b)), since ranks
    grow along the mesh's row-major order; ``parallel.sharding.axis_group``
    looks them up. ``device_type`` defaults to the default group's: "cuda"
    under NCCL, "cpu" otherwise."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = tuple(int(n) for n in shape), tuple(names)
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(shape)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    me = dist.get_rank()
    split = [i for i, k in enumerate(shape) if k > 1]
    mesh.flat_groups = {}
    for size in range(2, len(split) + 1):
        for dims in itertools.combinations(split, size):
            rest = [i for i in range(len(shape)) if i not in dims]
            lines = ranks.permute(*rest, *dims).reshape(-1, math.prod(shape[i] for i in dims))
            for line in lines.tolist():
                group = dist.new_group(line)
                if me in line:
                    mesh.flat_groups[tuple(names[i] for i in dims)] = group
    return mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """JAX's dry-run meshes: ("data" 16, "model" 16) over ranks [0, 256),
    or with ``multi_pod`` ("pod" 2, "data" 16, "model" 16) over [0, 512).
    Every rank of the world calls it (``make_mesh``); it raises on a
    smaller world."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, names, device_type)


def make_mesh_for(n_devices: int, model_axis: int = 1, device_type: Optional[str] = None):
    """A ("data", "model") mesh of shape ``(n // model_axis, model_axis)``
    over ranks ``[0, n_devices)`` of the default group (used by the elastic
    runtime after grow/shrink), or None without an initialised process
    group: a world of one device and no group. Call it on every rank, with
    the same arguments (``make_mesh``)."""
    if not dist.is_available() or not dist.is_initialized():
        if n_devices != 1:
            raise ValueError(f"a mesh of {n_devices} devices needs a process group")
        return None
    world = dist.get_world_size()
    if not 1 <= n_devices <= world or n_devices % model_axis:
        raise ValueError(f"cannot build a ({n_devices} // {model_axis}, {model_axis}) mesh "
                         f"over a world of {world}")
    return make_mesh((n_devices // model_axis, model_axis), ("data", "model"), device_type)
