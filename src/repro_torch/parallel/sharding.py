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

The Zero-3 layout that GSPMD derives from JAX's parameter shardings is
explicit here. A rank holds plain tensors, its shards (``local_shard``:
the slice a mesh coordinate owns, in JAX's order of the spec's axes); a
leaf sharded over "data" travels through the model as a ``Sharded``,
which the layer that uses it gathers (``Sharded.full``: an all-gather
over "data" whose backward is the reduce-scatter of the gradient), and
``gather_full`` rebuilds a whole leaf from its shards over a group.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

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

    def sharding(self, *logical: Optional[str]) -> "Sharding":
        """The layout of an array with these logical axes: its spec, its
        placements (None without a mesh) and the mesh (JAX's
        ``NamedSharding``)."""
        return Sharding(self.spec(*logical), self.placements(*logical), self.mesh)

    def override(self, **kv: Physical) -> "ShardingCtx":
        return ShardingCtx(self.rules.override(**kv), self.mesh)


class Sharding(NamedTuple):
    """One array's layout on a mesh: JAX's spec, the DTensor placements
    (None without a mesh) and the mesh itself."""
    spec: PartitionSpec
    placements: Optional[List[Any]]
    mesh: Any = None

    def shard(self, full, name: str = ""):
        """This rank's shard of the whole array ``full`` (``local_shard``)."""
        return local_shard(full, self.spec, self.mesh, name)


def _axes(p: Physical) -> Tuple[str, ...]:
    return (p,) if isinstance(p, str) else tuple(p or ())


def shard_shape(shape: Sequence[int], spec: PartitionSpec, mesh, name: str = "") -> Tuple[int, ...]:
    """The shape of each rank's shard of an array of ``shape``. Raises
    ``ValueError`` where a sharded dimension does not divide by the product
    of its mesh axes: JAX pads no parameter's shards either."""
    if mesh is None:
        return tuple(shape)
    sizes = mesh_shape(mesh)
    out = []
    for d, (n, p) in enumerate(zip(shape, spec)):
        k = math.prod(sizes[a] for a in _axes(p))
        if n % k:
            raise ValueError(f"{name or 'array'} {tuple(shape)}: dimension {d} ({n}) does not "
                             f"divide over {_axes(p)} ({k} shards)")
        out.append(n // k)
    return tuple(out)


def local_shard(full, spec: PartitionSpec, mesh, name: str = ""):
    """The slice of ``full`` (a tensor or an array) that this rank's mesh
    coordinate owns: along each dimension split over axes (a, b, ...), the
    block of index ``(coord_a * size_b + coord_b) ...``, JAX's order of the
    spec's axes. ``full`` itself without a mesh."""
    if mesh is None:
        return full
    small = shard_shape(full.shape, spec, mesh, name)
    sizes = mesh_shape(mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    index = []
    for d, p in enumerate(spec):
        i = 0
        for a in _axes(p):
            i = i * sizes[a] + coord[a]
        index.append(slice(i * small[d], (i + 1) * small[d]))
    return full[tuple(index)]


def data_dim(spec: PartitionSpec) -> Optional[int]:
    """The dimension a spec splits over "data", or None."""
    for d, p in enumerate(spec):
        if "data" in _axes(p):
            return d
    return None


# the collectives of the Zero-3 layout's gathers, counted where they are
# issued (``Sharded.full``'s forward and backward)
COLLECTIVES = {"gather": 0, "reduce_scatter": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def all_gather_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` = every rank's ``x`` of ``group``, in rank order along
    dimension 0. torch 2.13 names this collective ``all_gather_single`` and
    deprecates ``all_gather_into_tensor``, its only name in earlier
    releases: the call takes whichever this torch has."""
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, x, group=group)


def reduce_scatter_flat(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``out`` = block r along dimension 0 of ``x`` summed over ``group``,
    on its rank r (``reduce_scatter_single`` from torch 2.13,
    ``reduce_scatter_tensor`` before, as ``all_gather_flat``)."""
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, x, op=dist.ReduceOp.SUM, group=group)


def gather_full(shard: torch.Tensor, dim: int, group, n: int, pieces: int = 1) -> torch.Tensor:
    """The whole array from each rank's ``shard`` over ``group`` (n ranks,
    rank i's block i along ``dim``), contiguous. Along dimension 0 the
    all-gather writes the array itself. Along another it writes the ranks'
    blocks side by side into a buffer, which is copied into place;
    ``pieces`` gathers the array in that many slices of its first
    dimension, one all-gather each, so that the buffer is that share of
    the array."""
    x = shard.contiguous()
    out = torch.empty(x.shape[:dim] + (n * x.shape[dim],) + x.shape[dim + 1:],
                      dtype=x.dtype, device=x.device)
    if dim == 0:
        all_gather_flat(out, x, group)
        return out
    blocks = out.view(x.shape[:dim] + (n,) + x.shape[dim:])
    rows = -(-x.shape[0] // pieces)
    for i in range(0, x.shape[0], rows):
        part = x[i:i + rows]
        buf = torch.empty((n * part.shape[0],) + tuple(part.shape[1:]), dtype=x.dtype,
                          device=x.device)
        all_gather_flat(buf, part, group)
        blocks[i:i + rows].copy_(buf.view((n,) + tuple(part.shape)).movedim(0, dim))
        del buf
    return out


def scatter_sum(full: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """``full`` summed over ``group``, rank i keeping its block i along
    ``dim`` (the reduce-scatter, the transpose of ``gather_full``)."""
    shape = tuple(full.shape)
    small = shape[:dim] + (shape[dim] // n,) + shape[dim + 1:]
    parts = full.reshape(shape[:dim] + (n, shape[dim] // n) + shape[dim + 1:]).movedim(dim, 0)
    parts = parts.contiguous().view((n * small[0],) + small[1:])
    out = torch.empty(small, dtype=full.dtype, device=full.device)
    reduce_scatter_flat(out, parts, group)
    return out


class _GatherShard(torch.autograd.Function):
    """A shard cast to ``dtype``, then gathered over the group; the backward
    takes the whole gradient back to the shard's dtype and reduce-scatters
    it. A cast acts elementwise, so casting before the gather is the cast of
    the gathered array, and the gather moves the cast's bytes; the
    gradient is summed in the shard's dtype, as the cast's backward would
    hand it to an all-reduce."""

    @staticmethod
    def forward(ctx, shard, dtype, dim, group, n):
        ctx.layout, ctx.shard_dtype = (dim, group, n), shard.dtype
        COLLECTIVES["gather"] += 1
        return gather_full(shard.to(dtype), dim, group, n)

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.layout
        COLLECTIVES["reduce_scatter"] += 1
        return scatter_sum(g.to(ctx.shard_dtype), dim, group, n), None, None, None, None


@dataclass(frozen=True)
class Sharded:
    """A leaf held as this rank's ``shard``, split along ``dim`` over the
    n ranks of ``group`` ("data"), and used in ``dtype``: ``to`` sets the
    dtype (the cast happens at the gather), ``unbind`` gives each layer's
    shard of a stacked ``[L, ...]`` leaf, ``full`` gathers it."""
    shard: torch.Tensor
    dim: int
    group: Any
    n: int
    dtype: torch.dtype

    def to(self, dtype: torch.dtype) -> "Sharded":
        return replace(self, dtype=dtype)

    def unbind(self, dim: int = 0) -> List["Sharded"]:
        if dim != 0 or self.dim == 0:
            raise ValueError("only a stacked leaf's layer axis, which is whole, unbinds")
        return [replace(self, shard=t, dim=self.dim - 1) for t in self.shard.unbind(0)]

    def full(self) -> torch.Tensor:
        return _GatherShard.apply(self.shard, self.dtype, self.dim, self.group, self.n)


def gathered(x):
    """``x`` whole: a ``Sharded`` gathered, a tensor as it is."""
    return x.full() if isinstance(x, Sharded) else x


def gather_tree(tree: Dict) -> Dict:
    """Every ``Sharded`` leaf of a tree gathered."""
    return {k: gather_tree(v) if isinstance(v, dict) else gathered(v) for k, v in tree.items()}


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
