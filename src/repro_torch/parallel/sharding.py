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
split leaf travels through the model as a ``Sharded``, which the layer
that uses it gathers (``Sharded.full``: one all-gather for each
dimension the spec splits, over that dimension's mesh axes, whose
backward is the reduce-scatter of the gradient), and ``gather_full``
rebuilds a whole leaf from its shards over a group. A dimension split
over ("data", "model") is gathered over the mesh's flattened group,
whose rank order is JAX's block order ``coord_data * m + coord_model``
(``launch/mesh.py::make_mesh_for`` keeps one for each mesh). The
embedding table is the one leaf never gathered: ``sharded_take`` looks
each rank's tokens up in its shard, as GSPMD partitions ``jnp.take``.

The activations' collectives of a model axis above 1 (``SeqShards``:
each rank holds one block of every sequence) are here too: the
sequence gather (``gather_seq``, attention's K and V, the SSD scan's B
and C), the conv's halo from the previous block (``halo_prev``), the
all-to-alls between sequence blocks and head blocks (``seq_to_heads``,
``heads_to_seq``) and the sum of a product's parts over the model ranks
(``sum_over_model``), each an autograd function whose backward is its
transpose.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..tally_hooks import record_collective

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


def _block_of(coord: Dict[str, int], axes: Sequence[str], sizes: Dict[str, int]) -> int:
    """The block index of mesh coordinate ``coord`` over ``axes`` (JAX's
    order: ``coord_a * size_b + coord_b``)."""
    i = 0
    for a in axes:
        i = i * sizes[a] + coord[a]
    return i


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
        i = _block_of(coord, _axes(p), sizes)
        index.append(slice(i * small[d], (i + 1) * small[d]))
    return full[tuple(index)]


def spec_axes(spec: PartitionSpec, dim: Optional[int] = None) -> Tuple[str, ...]:
    """The mesh axes a spec names, on dimension ``dim`` or (None) on any."""
    parts = spec if dim is None else (spec[dim],)
    return tuple(a for p in parts for a in _axes(p))


def axis_group(mesh, axes: Sequence[str]) -> Tuple[Any, int]:
    """The process group over the mesh axes ``axes`` that have more than
    one rank, and its size: one axis's group; for several, the mesh's group
    over them flattened (its ranks in JAX's block order, ``coord_a *
    size_b + coord_b``, as ``launch.mesh.make_mesh`` builds it). (None, 1)
    where no such axis is left."""
    if mesh is None:
        return None, 1
    sizes = mesh_shape(mesh)
    axes = tuple(a for a in mesh.mesh_dim_names if a in axes and sizes[a] > 1)
    if not axes:
        return None, 1
    if len(axes) == 1:
        return mesh.get_group(axes[0]), sizes[axes[0]]
    flat = getattr(mesh, "flat_groups", {}).get(axes)
    if flat is None:
        raise ValueError(f"the mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)} has no "
                         f"group over {axes}: build it with launch.mesh.make_mesh")
    return flat, math.prod(sizes[a] for a in axes)


def batch_axes(ctx: Optional["ShardingCtx"]) -> Tuple[str, ...]:
    """The mesh axes a global batch's rows are split over: those the rules
    map "batch" to (by default "pod" and "data"), of ``ctx``'s mesh."""
    if ctx is None or ctx.mesh is None:
        return ()
    return spec_axes(ctx.spec("batch"))


def batch_size(ctx: Optional["ShardingCtx"]) -> int:
    """The number of blocks the batch's rows are split into."""
    if ctx is None or ctx.mesh is None:
        return 1
    sizes = mesh_shape(ctx.mesh)
    return math.prod(sizes[a] for a in batch_axes(ctx))


class Split(NamedTuple):
    """One dimension of a leaf split over mesh axes: the dimension, the
    axes (JAX's order), their process group and its size."""
    dim: int
    axes: Tuple[str, ...]
    group: Any
    n: int


def splits_of(spec: PartitionSpec, mesh) -> Tuple[Split, ...]:
    """The dimensions ``spec`` splits over axes of more than one rank, in
    order. Raises where a dimension names several axes against the mesh's
    order (its blocks are then not the flattened group's ranks)."""
    if mesh is None:
        return ()
    sizes, names = mesh_shape(mesh), list(mesh.mesh_dim_names)
    out = []
    for d, p in enumerate(spec):
        axes = tuple(a for a in _axes(p) if sizes.get(a, 1) > 1)
        if not axes:
            continue
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise NotImplementedError(f"dimension {d} is split over {axes}, against the "
                                      f"mesh's order {tuple(names)}")
        out.append(Split(d, axes, *axis_group(mesh, axes)))
    return tuple(out)


def gather_splits(t: torch.Tensor, splits: Sequence[Split], pieces: bool = False) -> torch.Tensor:
    """The whole leaf from this rank's shard ``t``: one ``gather_full`` for
    each split dimension (with ``pieces``, through a buffer of one shard's
    size)."""
    for s in splits:
        t = gather_full(t, s.dim, s.group, s.n, pieces=s.n if pieces else 1)
    return t


# the collectives of the Zero-3 layout's gathers, of the sharded table
# lookup and of the sequence split, counted where they are issued, one a
# call of a collective (a lookup, and its backward, once)
COLLECTIVES = {"gather": 0, "reduce_scatter": 0, "take": 0, "take_grad": 0, "seq_gather": 0,
               "seq_reduce_scatter": 0, "seq_sum": 0, "seq_sum_grad": 0, "halo": 0,
               "halo_grad": 0, "all_to_all": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def all_gather_flat(out: torch.Tensor, x: torch.Tensor, group,
                    kind: Optional[str] = "all-gather") -> None:
    """``out`` = every rank's ``x`` of ``group``, in rank order along
    dimension 0. torch 2.13 names this collective ``all_gather_single`` and
    deprecates ``all_gather_into_tensor``, its only name in earlier
    releases: the call takes whichever this torch has. Counted in the
    active tally as ``kind`` (None: the caller counts it)."""
    getattr(dist, "all_gather_single", dist.all_gather_into_tensor)(out, x, group=group)
    if kind:
        record_collective(kind, out)


def reduce_scatter_flat(out: torch.Tensor, x: torch.Tensor, group,
                        kind: Optional[str] = "reduce-scatter") -> None:
    """``out`` = block r along dimension 0 of ``x`` summed over ``group``,
    on its rank r (``reduce_scatter_single`` from torch 2.13,
    ``reduce_scatter_tensor`` before, as ``all_gather_flat``)."""
    getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)(
        out, x, op=dist.ReduceOp.SUM, group=group)
    if kind:
        record_collective(kind, out)


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """``t`` reduced in place over ``group``, counted in the active tally."""
    dist.all_reduce(t, op=op, group=group)
    record_collective("all-reduce", t)


def all_to_all(out: torch.Tensor, x: torch.Tensor, group, out_splits=None,
               in_splits=None) -> None:
    """``all_to_all_single`` of ``x`` into ``out`` over ``group`` (equal
    blocks of dimension 0, or the row counts given), counted in the active
    tally."""
    dist.all_to_all_single(out, x, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=group)
    record_collective("all-to-all", out)


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


class _Gather(torch.autograd.Function):
    """``x`` cast to ``dtype``, then gathered along each of ``splits`` in
    turn; the backward takes the whole gradient back to x's dtype and
    reduce-scatters it along them in reverse. A cast acts elementwise, so
    casting before the gather is the cast of the gathered array, and the
    gather moves the cast's bytes; the gradient is summed in x's dtype, as
    the cast's backward would hand it to an all-reduce. ``kind`` names the
    counters: "" a leaf's gathers, "seq_" the sequence gathers."""

    @staticmethod
    def forward(ctx, x, dtype, splits, kind):
        ctx.splits, ctx.kind, ctx.x_dtype = splits, kind, x.dtype
        x = x.to(dtype)
        for s in splits:
            COLLECTIVES[kind + "gather"] += 1
            x = gather_full(x, s.dim, s.group, s.n)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.x_dtype)
        for s in reversed(ctx.splits):
            COLLECTIVES[ctx.kind + "reduce_scatter"] += 1
            g = scatter_sum(g, s.dim, s.group, s.n)
        return g, None, None, None


@dataclass(frozen=True)
class Sharded:
    """A leaf held as this rank's ``shard``, split along ``splits`` (each
    dimension over its mesh axes), and used in ``dtype``: ``to`` sets the
    dtype (the cast happens at the gather), ``unbind`` gives each layer's
    shard of a stacked ``[L, ...]`` leaf, ``full`` gathers it."""
    shard: torch.Tensor
    splits: Tuple[Split, ...]
    dtype: torch.dtype

    def to(self, dtype: torch.dtype) -> "Sharded":
        return replace(self, dtype=dtype)

    def unbind(self, dim: int = 0) -> List["Sharded"]:
        if dim != 0 or any(s.dim == 0 for s in self.splits):
            raise ValueError("only a stacked leaf's layer axis, which is whole, unbinds")
        splits = tuple(s._replace(dim=s.dim - 1) for s in self.splits)
        return [replace(self, shard=t, splits=splits) for t in self.shard.unbind(0)]

    def full(self) -> torch.Tensor:
        return _Gather.apply(self.shard, self.dtype, self.splits, "")


def gathered(x):
    """``x`` whole: a ``Sharded`` gathered, a tensor as it is."""
    return x.full() if isinstance(x, Sharded) else x


def gathered_but_model(x):
    """``x`` gathered over every split but those over "model" alone, which
    stay the rank's block (a tensor-parallel layer's slice of its weight);
    a tensor as it is."""
    if not isinstance(x, Sharded):
        return x
    return _Gather.apply(x.shard, x.dtype, tuple(s for s in x.splits if s.axes != ("model",)),
                         "")


def gather_tree(tree: Dict) -> Dict:
    """Every ``Sharded`` leaf of a tree gathered."""
    return {k: gather_tree(v) if isinstance(v, dict) else gathered(v) for k, v in tree.items()}


class TakePlan(NamedTuple):
    """How a rank looks its tokens up in its shard of a [V, e] table:
    its first row (``row0``), the group that sums the rows of the vocab
    blocks (None where the vocab is whole), the group over which the e
    blocks are exchanged (None where e is whole) and, for each of that
    group's ranks in order (only this rank where there is none), the
    (rows, positions) of its tokens among the gathered ones."""
    row0: int
    sum_group: Any
    ex_group: Any
    members: Tuple[Tuple[slice, slice], ...]


class _Take(torch.autograd.Function):
    """Rows of a sharded table for the gathered token ids, as GSPMD
    partitions JAX's ``jnp.take`` (see ``sharded_take``). The backward
    sends each rank its rows' gradients back, sums them over the vocab
    blocks' group and adds them, in fp32, into the rank's own rows
    (``index_add_``): the gradient of the shard itself, every use of each
    row summed."""

    @staticmethod
    def forward(ctx, shard, ids, plan, dtype):
        V = shard.shape[0]
        local = ids - plan.row0
        hit = (local >= 0) & (local < V)
        rows = shard[local.clamp(0, V - 1)].to(dtype)
        rows.masked_fill_(~hit[..., None], 0)
        if plan.sum_group is not None:
            # one block holds each row: the sum is exact in any dtype
            all_reduce(rows, plan.sum_group)
        ctx.plan, ctx.shard_meta = plan, (shard.shape, shard.dtype)
        ctx.save_for_backward(local, hit)
        if plan.ex_group is None:
            b, s = plan.members[0]
            return rows[b, s].contiguous()
        send = torch.stack([rows[b, s] for b, s in plan.members])
        recv = torch.empty_like(send)
        all_to_all(recv, send, plan.ex_group)
        n, bl, sl, el = recv.shape
        return recv.permute(1, 2, 0, 3).reshape(bl, sl, n * el)

    @staticmethod
    def backward(ctx, g):
        plan, (shape, dtype) = ctx.plan, ctx.shard_meta
        local, hit = ctx.saved_tensors
        grid = g.new_zeros(tuple(local.shape) + (shape[1],))
        if plan.ex_group is None:
            b, s = plan.members[0]
            grid[b, s] = g
        else:
            n = len(plan.members)
            bl, sl = g.shape[:2]
            send = g.reshape(bl, sl, n, shape[1]).permute(2, 0, 1, 3).contiguous()
            recv = torch.empty_like(send)
            all_to_all(recv, send, plan.ex_group)
            for (b, s), part in zip(plan.members, recv):
                grid[b, s] += part
        if plan.sum_group is not None:
            # each position is one rank's: the sum adds zeros, exact in g's dtype
            all_reduce(grid, plan.sum_group)
        COLLECTIVES["take_grad"] += 1
        # every position added (the others' rows as zeros): no shape here
        # follows the token ids
        grid.masked_fill_(~hit[..., None], 0)
        out = torch.zeros(shape, dtype=torch.float32, device=g.device)
        out.index_add_(0, local.clamp(0, shape[0] - 1).flatten(),
                       grid.reshape(-1, shape[1]).float())
        return out.to(dtype), None, None, None


def sharded_take(table: Sharded, tokens: torch.Tensor, ctx: "ShardingCtx",
                 seq_split: bool, dtype: torch.dtype) -> torch.Tensor:
    """The rows [b, s, e] of this rank's tokens [b, s] (its block of a
    global batch: rows over the batch axes, positions over "model" with
    ``seq_split``) of a [V, e] ``table`` held as shards, in ``dtype``,
    without gathering the table. As GSPMD partitions JAX's ``jnp.take``
    (``repro/models/layers.py:280``): the token ids are all-gathered over
    the table's axes that split them (as [b, s, 1], JAX's index shape),
    each rank reads the rows its shard holds and zeroes the rest; where
    the vocab is split (over "model") the rows are all-reduced over it,
    the all-reduce of JAX's HLO; where e is split (over "data", or
    ("data", "model") for an ``fsdp2d`` table) the e blocks of each rank's
    tokens come to it by an all-to-all over e's axes. (For the e-split
    table JAX all-gathers the rows whole, [B, S, e], and keeps its block;
    the all-to-all moves 1 / n of that.)"""
    mesh = ctx.mesh
    names, sizes = list(mesh.mesh_dim_names), mesh_shape(mesh)
    coord = dict(zip(names, mesh.get_coordinate()))
    vocab = [s for s in table.splits if s.dim == 0]
    emb = [s for s in table.splits if s.dim == 1]
    used = {a for s in table.splits for a in s.axes}
    ids = tokens.to(torch.int32)[..., None]
    b, s = tokens.shape
    row_axes = tuple(a for a in batch_axes(ctx) if a in used and sizes[a] > 1)
    seq_axes = ("model",) if seq_split and "model" in used and sizes.get("model", 1) > 1 else ()
    for dim, axes in ((0, row_axes), (1, seq_axes)):
        if axes:
            ids = gather_full(ids, dim, *axis_group(mesh, axes))
    ex_axes = emb[0].axes if emb else ()
    members = []
    for j in range(math.prod(sizes[a] for a in ex_axes)):
        c, rest = dict(coord), j
        for a in reversed(ex_axes):
            c[a], rest = rest % sizes[a], rest // sizes[a]
        bi = _block_of(c, row_axes, sizes)
        si = c["model"] if seq_axes else 0
        members.append((slice(bi * b, (bi + 1) * b), slice(si * s, (si + 1) * s)))
    row0 = _block_of(coord, vocab[0].axes, sizes) * table.shard.shape[0] if vocab else 0
    plan = TakePlan(row0, vocab[0].group if vocab else None, emb[0].group if emb else None,
                    tuple(members))
    COLLECTIVES["take"] += 1
    return _Take.apply(table.shard, ids[..., 0].long(), plan, dtype)


class SeqShards(NamedTuple):
    """The "model" axis of a mesh, over which each rank holds one block of
    every sequence: its process group, its size n and this rank's block r
    (positions [r s/n, (r+1) s/n) of a sequence of s)."""
    group: Any
    n: int
    rank: int


def seq_shards(ctx: Optional["ShardingCtx"]) -> Optional[SeqShards]:
    """The sequence split of ``ctx``'s mesh, None without one or where its
    "model" axis has one rank."""
    mesh = None if ctx is None else ctx.mesh
    if mesh is None or mesh_shape(mesh).get("model", 1) == 1:
        return None
    names = list(mesh.mesh_dim_names)
    return SeqShards(mesh.get_group("model"), mesh_shape(mesh)["model"],
                     mesh.get_coordinate()[names.index("model")])


def gather_seq(x: torch.Tensor, dim: int, sp: SeqShards) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim`` (the sequence), in rank
    order; the backward reduce-scatters the gradient: each rank gets its
    block's gradient summed over the ranks that used it."""
    return _Gather.apply(x, x.dtype, (Split(dim, ("model",), sp.group, sp.n),), "seq_")


class _Halo(torch.autograd.Function):
    """The last k positions of the previous rank's block of u [b, s, c]
    (zeros on rank 0): an all-gather of every rank's tail. The backward
    hands each tail's gradient back to its rank (a reduce-scatter in which
    rank r contributes only to rank r - 1's block). Rank 0's zeros are
    this function's output too, so that its backward joins the
    reduce-scatter that the other ranks' backwards issue."""

    @staticmethod
    def forward(ctx, u, k, group, n, r):
        ctx.meta = (u.shape, k, group, n, r)
        COLLECTIVES["halo"] += 1
        tail = u[:, -k:].contiguous()
        tails = torch.empty((n * tail.shape[0],) + tuple(tail.shape[1:]), dtype=u.dtype,
                            device=u.device)
        all_gather_flat(tails, tail, group, kind=None)
        record_collective("collective-permute", tail)       # JAX's halo exchange
        if r == 0:
            return torch.zeros_like(tail)
        return tails.view((n,) + tuple(tail.shape))[r - 1].clone()

    @staticmethod
    def backward(ctx, g):
        shape, k, group, n, r = ctx.meta
        COLLECTIVES["halo_grad"] += 1
        parts = g.new_zeros((n,) + tuple(g.shape))
        if r > 0:
            parts[r - 1] = g
        mine = torch.empty_like(g)
        reduce_scatter_flat(mine, parts.view((n * g.shape[0],) + tuple(g.shape[1:])), group,
                            kind=None)
        record_collective("collective-permute", mine)
        gu = g.new_zeros(shape)
        gu[:, -k:] = mine
        return gu, None, None, None, None


class _SeqSum(torch.autograd.Function):
    """x summed over the "model" group: the parts of a product split over
    "model" (the rank's heads' rows of a weight). Without ``dim`` an
    all-reduce, whose backward is the all-reduce of the ranks' gradients;
    with ``dim`` a reduce-scatter, the rank keeping its block of that
    dimension, whose backward is the all-gather of the blocks'
    gradients."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.meta = (dim, group, n)
        COLLECTIVES["seq_sum"] += 1
        if dim is not None:
            return scatter_sum(x, dim, group, n)
        x = x.clone(memory_format=torch.contiguous_format)
        all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.meta
        COLLECTIVES["seq_sum_grad"] += 1
        if dim is None:
            g = g.clone(memory_format=torch.contiguous_format)
            all_reduce(g, group)
        else:
            g = gather_full(g, dim, group, n)
        return g, None, None, None


def sum_over_model(x: torch.Tensor, sp: SeqShards, dim: Optional[int] = None) -> torch.Tensor:
    """``x`` summed over the model ranks, and with ``dim`` the rank's block
    of that dimension (its positions, where x covers every position)."""
    return _SeqSum.apply(x, dim, sp.group, sp.n)


def halo_prev(u: torch.Tensor, k: int, sp: SeqShards) -> torch.Tensor:
    """The k positions before this rank's block of u [b, s_block, c]: the
    previous rank's last k (zeros on the first rank, the causal pad)."""
    return _Halo.apply(u, k, sp.group, sp.n, sp.rank)


def _to_heads(x: torch.Tensor, group, n: int) -> torch.Tensor:
    b, sl, H = x.shape[:3]
    rest = tuple(x.shape[3:])
    send = x.reshape((b, sl, n, H // n) + rest).movedim(2, 0).contiguous()
    recv = torch.empty_like(send)
    COLLECTIVES["all_to_all"] += 1
    all_to_all(recv, send, group)
    return recv.movedim(0, 1).reshape((b, n * sl, H // n) + rest)


def _to_seq(y: torch.Tensor, group, n: int) -> torch.Tensor:
    b, s, Hl = y.shape[:3]
    rest = tuple(y.shape[3:])
    send = y.reshape((b, n, s // n, Hl) + rest).movedim(1, 0).contiguous()
    recv = torch.empty_like(send)
    COLLECTIVES["all_to_all"] += 1
    all_to_all(recv, send, group)
    return recv.movedim(0, 2).reshape((b, s // n, n * Hl) + rest)


class _SeqToHeads(torch.autograd.Function):
    """[b, s/n, H, ...] (this rank's positions, every head) -> [b, s, H/n,
    ...] (every position, this rank's heads): an all-to-all; the backward
    is the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.meta = (group, n)
        return _to_heads(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g, *ctx.meta), None, None


class _HeadsToSeq(torch.autograd.Function):
    """The inverse of ``_SeqToHeads``."""

    @staticmethod
    def forward(ctx, y, group, n):
        ctx.meta = (group, n)
        return _to_seq(y, group, n)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g, *ctx.meta), None, None


def seq_to_heads(x: torch.Tensor, sp: SeqShards) -> torch.Tensor:
    """x [b, s/n, H, ...] -> [b, s, H/n, ...]: rank r's heads [r H/n, (r+1)
    H/n) over every position (JAX's constraint to "ssm_heads")."""
    if x.shape[2] % sp.n:
        raise ValueError(f"{x.shape[2]} heads do not split over {sp.n} model ranks")
    return _SeqToHeads.apply(x, sp.group, sp.n)


def heads_to_seq(y: torch.Tensor, sp: SeqShards) -> torch.Tensor:
    """y [b, s, H/n, ...] -> [b, s/n, H, ...], the inverse of ``seq_to_heads``."""
    return _HeadsToSeq.apply(y, sp.group, sp.n)


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
