"""Logical-axis sharding rules (DP / FSDP / TP / SP / EP).

The port of ``repro/parallel/sharding.py``. Arrays are annotated with
*logical* axis names; a ``Rules`` table maps logical names to physical
mesh axes. The default (baseline) scheme:

* ``batch``    -> ``('pod', 'data')``  — data parallelism across pods and
  the FSDP axis within a pod.
* ``seq``      -> ``'model'``          — context/sequence parallelism: the
  residual stream is sequence-sharded over the model axis.
* params: ``fsdp`` -> ``'data'`` (Zero-3 style), ``tp`` -> ``'model'``
  (MLP hidden / expert / vocab dims), and ``fsdp2d`` -> ``('data',
  'model')`` for weights whose only shardable dim is ``embed``.
* ``kv_seq``   -> ``'model'``          — decode-time KV caches are
  sequence-sharded.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
dimensions carry the axis names (``mesh_dim_names``). Where JAX maps a
spec to a ``NamedSharding``, the port maps it to DTensor placements, one
``Shard(dim)`` or ``Replicate()`` for each mesh dimension.

JAX's ``shard_map_compat`` has no counterpart: in PyTorch the body of a
``shard_map`` is the per-rank code itself, which runs on its local
shards and calls the collectives of ``torch.distributed`` over the
mesh's groups (``models/moe.py``'s ``moe_a2a``, ``parallel/compress.py``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

Physical = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A spec: for each array dimension, None, a mesh axis name or a tuple
    of several (JAX's ``PartitionSpec``, compared with it entry by entry)."""

    def __new__(cls, *parts: Physical) -> "PartitionSpec":
        # a one-axis tuple is that axis, as JAX's PartitionSpec holds it
        return super().__new__(cls, tuple(
            p[0] if isinstance(p, tuple) and len(p) == 1 else p for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


DEFAULT_RULES: Dict[str, Physical] = {
    "batch": ("pod", "data"),
    "seq": "model",
    "kv_seq": "model",
    "embed": None,            # activation embed dim: replicated
    "heads": None,
    "kv_heads": None,
    "head_dim": None,
    "fsdp": "data",           # param dim sharded Zero-3 style
    "tp": "model",            # param dim sharded tensor-parallel
    "fsdp2d": ("data", "model"),
    "vocab": "model",
    "expert": "model",
    "expert_cap": ("pod", "data"),
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,           # stacked-layer leading axis
    "window": None,
}


@dataclass(frozen=True)
class Rules:
    table: Dict[str, Physical] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def override(self, **kv: Physical) -> "Rules":
        t = dict(self.table)
        t.update(kv)
        return Rules(t)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        """Map logical axis names to a PartitionSpec."""
        phys = []
        used: set = set()
        for name in logical:
            if name is None:
                phys.append(None)
                continue
            p = self.table.get(name)
            # an axis may appear only once in a spec; drop duplicates
            if p is None:
                phys.append(None)
            elif isinstance(p, tuple):
                keep = tuple(a for a in p if a not in used)
                used.update(keep)
                phys.append(keep if keep else None)
            else:
                if p in used:
                    phys.append(None)
                else:
                    used.add(p)
                    phys.append(p)
        return PartitionSpec(*phys)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


@dataclass(frozen=True)
class ShardingCtx:
    """Rules + (optional) mesh. With ``mesh=None`` constraints are no-ops,
    so the same model code runs on one device and across ranks."""

    rules: Rules = field(default_factory=Rules)
    mesh: Optional[Any] = None          # a DeviceMesh with named dims

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        s = self.rules.spec(*logical)
        if self.mesh is None:
            return s
        # drop axes not present in this mesh (e.g. 'pod' on single-pod)
        present = set(self.mesh.mesh_dim_names)

        def keep(p):
            if p is None:
                return None
            if isinstance(p, tuple):
                t = tuple(a for a in p if a in present)
                return t if t else None
            return p if p in present else None
        return PartitionSpec(*[keep(p) for p in s])

    def placements(self, *logical: Optional[str]) -> Optional[List[Any]]:
        """DTensor placements of the logical spec on the mesh: for each mesh
        dimension ``Shard(d)`` where array dimension d names it, else
        ``Replicate()``. None without a mesh.

        A dimension sharded over several mesh axes is split by JAX in the
        order the spec lists them, and by DTensor in the mesh's order of
        its dimensions. Where the two differ (``expert=("model", "data")``
        on a ("data", "model") mesh) the layout has no such placements, and
        this raises."""
        if self.mesh is None:
            return None
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        dim_of = {}
        for d, p in enumerate(self.spec(*logical)):
            axes = (p,) if isinstance(p, str) else p or ()
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise NotImplementedError(
                    f"array dimension {d} is split over {axes}, against the mesh's order "
                    f"{tuple(names)}: DTensor's Shard placements split in the mesh's order")
            for a in axes:
                dim_of[a] = d
        return [Shard(dim_of[a]) if a in dim_of else Replicate() for a in names]

    def override(self, **kv: Physical) -> "ShardingCtx":
        return ShardingCtx(self.rules.override(**kv), self.mesh)


def constrain(x: torch.Tensor, ctx: ShardingCtx, *logical: Optional[str]) -> torch.Tensor:
    """The port of JAX's ``with_sharding_constraint`` by logical names. In
    JAX it is a hint to GSPMD, which partitions the program around it; the
    port has no GSPMD, so a plain tensor (each rank's local shard, or the
    whole array on one device) comes back unchanged, and a ``DTensor`` is
    redistributed to the spec's placements on its mesh."""
    if ctx.mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(ctx.mesh, ctx.placements(*logical))


def divisible(n: int, mesh, phys: Physical) -> bool:
    if phys is None:
        return True
    axes = (phys,) if isinstance(phys, str) else phys
    k = 1
    for a in axes:
        k *= mesh_shape(mesh).get(a, 1)
    return n % k == 0
