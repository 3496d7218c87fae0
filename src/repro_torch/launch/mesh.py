"""Device meshes over the ranks of a ``torch.distributed`` world.

The port of ``repro/launch/mesh.py``'s ``make_mesh_for``. A rank is one
device: ``cuda:{local rank}`` on a card (one process per card), the CPU
under gloo. Axes:

* ``data``  — data parallelism (the gradient all-reduce);
* ``model`` — tensor/sequence parallelism and the experts of
  ``moe_a2a``.

``make_production_mesh`` (the 256- and 512-chip pod meshes of JAX's
dry-run) is not ported: its only caller is the dry-run tooling.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def make_mesh_for(n_devices: int, model_axis: int = 1, device_type: Optional[str] = None):
    """A ("data", "model") mesh of shape ``(n // model_axis, model_axis)``
    over ranks ``[0, n_devices)`` of the default group (used by the elastic
    runtime after grow/shrink), or None without an initialised process
    group: a world of one device and no group.

    Building a ``DeviceMesh`` creates one group for each row and column
    with ``new_group``, which every rank of the world must call, bound or
    not: call this on every rank, with the same arguments. A rank outside
    ``[0, n_devices)`` gets the mesh back with no coordinate
    (``mesh.get_coordinate()`` is None). The groups live until the world
    is destroyed, so a caller that rebinds keeps one mesh for each n (as
    ``ElasticRuntime`` does). Where both axes have more than one rank the
    mesh also carries ``flat_group``, the group of its n ranks in rank
    order (``parallel.sharding.axis_group``), built here alike. ``device_type`` defaults to the default
    group's: "cuda" under NCCL, "cpu" otherwise."""
    if not dist.is_available() or not dist.is_initialized():
        if n_devices != 1:
            raise ValueError(f"a mesh of {n_devices} devices needs a process group")
        return None
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    if not 1 <= n_devices <= world or n_devices % model_axis:
        raise ValueError(f"cannot build a ({n_devices} // {model_axis}, {model_axis}) mesh "
                         f"over a world of {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_devices).reshape(n_devices // model_axis, model_axis)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))
    if 1 < model_axis < n_devices:
        # the flattened ("data", "model") group, for a dimension split over
        # both axes: its rank i is world rank i, coordinate (i // m, i % m),
        # so its rank order is JAX's block order coord_data * m + coord_model
        mesh.flat_group = dist.new_group(list(range(n_devices)))
    return mesh
