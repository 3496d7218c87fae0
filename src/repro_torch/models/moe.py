"""Mixture-of-Experts layer (token-choice top-k, capacity-based dispatch).

The port of ``repro/models/moe.py``, plain functions on tensors:

1. route: the router's logits in fp32, softmax, top-k experts per token,
   the gates renormalised over the top-k;
2. rank each (token, k) pair within its expert by a stable sort of the
   flat expert ids (``dispatch_plan``);
3. scatter the kept pairs into a dispatch buffer [E, C, e]; a pair whose
   rank is C or more goes to a dump row ``E*C`` that is cut off;
4. the experts' products, batched over E;
5. gather back, scale by the gates, sum each token's k parts.

``moe_dense`` runs every expert on every token and combines by the gate
weights: the oracle of the tests. The JAX layer's sharding constraints
are hints to GSPMD; where the one on the dispatch buffer splits work over
"data", ``moe_dispatch`` splits it itself across the data group's ranks.

``moe_a2a`` is JAX's expert parallelism over an all-to-all (``local_moe``
in ``repro/models/moe.py``): the pairs are ranked twice, into a send
buffer by their destination shard (capacity ``S_cap`` a shard), then,
after the all-to-all over "model", into each local expert's buffer
(capacity ``C2`` an expert). Its body is three stages (``a2a_pack``,
``a2a_experts``, ``a2a_combine``) joined by an exchange: the mesh's
collectives (``group_exchange``, each rank holding one shard), the
identity at one shard without a mesh (JAX's runtime always binds a mesh,
so on one device it runs this body), or ``loopback_exchange``, which runs
n_sh shards in one process.

Inside the model (``moe``) each rank holds its block of the batch, rows
over "data" and positions over "model" (decode's one position whole over
"model"), and, where E divides by the "model" axis, its E / m experts
(``expert_shards``): ``moe_a2a`` runs there over the "model" group; where
JAX falls back to the dispatch (decode, E % n_sh nonzero, or
``moe_impl="dispatch"``) the dispatch plans the tokens of the whole mesh
in their global order, as GSPMD's partitioned ``moe_dispatch`` does, and
splits its buffer as JAX's constraint does: the experts over "model", the
capacity over the batch axes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.sharding import (SeqShards, all_gather_flat, all_reduce, all_to_all, axis_group,
                                 batch_axes, mesh_shape, reduce_scatter_flat, seq_shards)
from .config import ArchConfig
from .layers import ParamSpec, rmsnorm


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    e, f, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    specs = {
        "router": ParamSpec((e, E), (None, None), init="small"),
        "w_up": ParamSpec((E, e, f), ("expert", "fsdp", None)),
        "w_gate": ParamSpec((E, e, f), ("expert", "fsdp", None)),
        "w_down": ParamSpec((E, f, e), ("expert", None, "fsdp")),
        "norm": ParamSpec((e,), (None,), init="zeros"),
    }
    if cfg.moe_shared:
        specs["shared_up"] = ParamSpec((e, f * cfg.moe_shared), ("fsdp", "tp"))
        specs["shared_gate"] = ParamSpec((e, f * cfg.moe_shared), ("fsdp", "tp"))
        specs["shared_down"] = ParamSpec((f * cfg.moe_shared, e), ("tp", "fsdp"))
    return specs


def _expert_ffn(xb: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """xb: [E, C, e] (or [T, e], which every expert takes) -> [E, C, e]
    through each expert's SwiGLU / activation, batched over E."""
    cdt = xb.dtype
    up = torch.matmul(xb, p["w_up"].to(cdt))
    if cfg.mlp_act == "swiglu":
        h = F.silu(torch.matmul(xb, p["w_gate"].to(cdt))) * up
    elif cfg.mlp_act == "relu2":
        r = F.relu(up)
        h = r * r
    else:
        # jax.nn.gelu is the tanh form (torch's default is erf)
        h = F.gelu(up, approximate="tanh")
    return torch.matmul(h, p["w_down"].to(cdt))


def _route(xn: torch.Tensor, p: Dict, cfg: ArchConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """xn [T, e] -> gates [T, k] fp32 (renormalised), ids [T, k] int64."""
    logits = xn.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    return gates, ids


def capacity(T: int, cfg: ArchConfig) -> int:
    """Slots per expert for T tokens: ``T k capacity_factor / E`` (at least
    1), rounded up to a multiple of 64 from T = 4096 on (where JAX shards
    the buffer's capacity axis)."""
    C = max(int(T * cfg.top_k * cfg.capacity_factor / cfg.n_experts), 1)
    return -(-C // 64) * 64 if T >= 4096 else C


class DispatchPlan(NamedTuple):
    """Where each of the T*k (token, k) pairs goes, flat in token-major
    order: whether it fits (its rank among the pairs routed to its expert,
    in token order, is below C), and its buffer row (``E*C``, the dump row,
    where it does not)."""
    keep: torch.Tensor       # [T*k] bool
    dest: torch.Tensor       # [T*k] int64
    capacity: int


def _ranks(keys: torch.Tensor) -> torch.Tensor:
    """The rank of each entry among the entries of its key, in order: a
    stable sort, then each position less the first of its key."""
    order = torch.argsort(keys, stable=True)
    sorted_keys = keys[order]
    first = torch.searchsorted(sorted_keys, sorted_keys, side="left")
    rank = torch.empty_like(keys)
    rank[order] = torch.arange(keys.numel(), device=keys.device) - first
    return rank


def dispatch_plan(ids: torch.Tensor, cfg: ArchConfig) -> DispatchPlan:
    """The plan of ``moe_dispatch`` for expert ids [T, k]."""
    C = capacity(ids.shape[0], cfg)
    fid = ids.reshape(-1)
    rank = _ranks(fid)
    keep = rank < C
    dest = torch.where(keep, fid * C + rank, cfg.n_experts * C)
    return DispatchPlan(keep, dest, C)


def _shared(xn_flat: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    if not cfg.moe_shared:
        return torch.zeros_like(xn_flat)
    cdt = xn_flat.dtype
    up = xn_flat @ p["shared_up"].to(cdt)
    gate = xn_flat @ p["shared_gate"].to(cdt)
    return (F.silu(gate) * up) @ p["shared_down"].to(cdt)


def moe_dense(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """Oracle path: every expert computed for every token."""
    b, s, e = x.shape
    cdt = x.dtype
    flat = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(b * s, e)
    gates, ids = _route(flat, p, cfg)
    ally = _expert_ffn(flat, p, cfg)                                    # [E, T, e]
    weights = torch.zeros((b * s, cfg.n_experts), dtype=torch.float32, device=x.device)
    weights.scatter_add_(1, ids, gates)                                 # [T, E]
    y = torch.einsum("te,etd->td", weights.to(cdt), ally)
    y = y + _shared(flat, p, cfg)
    return y.reshape(b, s, e)


def moe_dispatch(x: torch.Tensor, p: Dict, cfg: ArchConfig, group=None,
                 seq_ranks: int = 1, model: Optional[SeqShards] = None) -> torch.Tensor:
    """Capacity-based scatter dispatch (see the module docstring).

    ``group``: the process group over whose ranks the batch is split, each
    holding its block: rows over the group's ranks in order, and with
    ``seq_ranks`` m > 1 the sequence over each m consecutive ranks too
    (rank i holds rows block i // m, positions block i % m: a ("data",
    "model") mesh's flattened group). JAX's dispatch under a mesh is
    partitioned by GSPMD and keeps its global meaning: the capacity comes
    from the global T and the pairs are ranked over every rank's tokens
    (``repro/models/moe.py:95-114``), and the [E, C, e] buffer's C is split
    over "data" (``constrain(..., "expert", "expert_cap", "embed")``). So
    the expert ids are gathered over the group and the global batch's plan
    is made, over the tokens in their global (row, position) order; rank r
    of n owns slots [r C/n, (r+1) C/n) of every expert (C
    padded up to a multiple of n with empty slots, as GSPMD pads the
    constraint's split) and runs the experts over its [E, C/n, e] buffer
    alone. Each kept pair's row travels to the rank that owns its slot and
    its expert output back, by all-to-alls over the group.

    ``model``: the "model" axis over which p's experts are split, E / m a
    rank (``expert_shards``), as JAX's constraint splits the buffer's
    experts. Where the group holds the model ranks too (``seq_ranks`` m)
    rank (d, j) owns the slots of block d of the capacity of experts block
    j; where the tokens are whole over "model" (decode) each model rank
    takes its experts' pairs alone, over the group of the batch axes, and
    the partial outputs are summed over "model"."""
    b, s, e = x.shape
    cdt = x.dtype
    E, k, T = cfg.n_experts, cfg.top_k, b * s
    xn = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, e)
    gates, ids = _route(xn, p, cfg)                                     # [T, k]
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    if model is not None or (group is not None and dist.get_world_size(group) > 1):
        y = _dispatch_split(xn, gates, ids, tok, p, cfg, group, (b, s, seq_ranks), model)
    else:
        plan = dispatch_plan(ids, cfg)
        C, kept, dest = plan.capacity, plan.keep, plan.dest
        # each kept pair has a row of its own; the dropped ones add zeros into the dump row
        buf = torch.zeros((E * C + 1, e), dtype=cdt, device=x.device)
        buf = buf.index_add(0, dest, xn[tok] * kept.to(cdt)[:, None])
        yb = _expert_ffn(buf[:E * C].view(E, C, e), p, cfg)             # [E, C, e]
        gathered = yb.reshape(E * C, e)[dest.clamp(0, E * C - 1)]
        gathered = gathered * (gates.reshape(T * k) * kept).to(cdt)[:, None]
        # each token's k parts summed in a fixed order (JAX scatter-adds them)
        y = gathered.view(T, k, e).sum(1)
    y = y + _shared(xn, p, cfg)
    return y.reshape(b, s, e)


def _global_order(n: int, block: Tuple[int, int, int], device) -> torch.Tensor:
    """The index, in the ranks' concatenated tokens, of each token of the
    global batch in (row, position) order, for n ranks each holding a block
    (b, s, m) of b rows and s positions, m ranks to a sequence."""
    b, s, m = block
    return torch.arange(n * b * s, device=device).view(n // m, m, b, s).transpose(1, 2).reshape(-1)


def _dispatch_split(xn: torch.Tensor, gates: torch.Tensor, ids: torch.Tensor,
                    tok: torch.Tensor, p: Dict, cfg: ArchConfig, group,
                    block: Tuple[int, int, int], model: Optional[SeqShards]) -> torch.Tensor:
    """``moe_dispatch`` with the buffer split over the n ranks of
    ``group``, each holding a ``block`` (b, s, m) of the batch
    (``_global_order``), and its experts over ``model``'s ranks if given:
    y [T, e] of this rank's tokens before the shared expert."""
    T, e = xn.shape
    E, k, cdt = cfg.n_experts, cfg.top_k, xn.dtype
    # (no group: decode's batch whole, one rank of it on each model rank)
    n, r = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    fid = (ids if group is None else _gather_rows(ids, group)).reshape(-1)   # [n T k], by rank
    order = _global_order(n, block, ids.device)
    plan = dispatch_plan(fid.view(n * T, k)[order], cfg)
    # the plan of the global order, back in the ranks' order
    keep, dest = torch.empty_like(plan.keep), torch.empty_like(plan.dest)
    keep.view(n * T, k)[order] = plan.keep.view(n * T, k)
    dest.view(n * T, k)[order] = plan.dest.view(n * T, k)
    C = plan.capacity
    # the experts' blocks: over the group's model ranks where it holds them
    # (rank d m + j owns expert block j), else over "model" beside the
    # group, each model rank sending its own block's pairs alone
    e_loc = E // (1 if model is None else model.n)
    blk = fid // e_loc
    split = block[2] if model is not None and block[2] > 1 else 1
    if model is not None and split == 1:
        keep = keep & (blk == model.rank)
    Cl = -(-C // (n // split))                        # a rank's slots of each expert
    slot = dest - fid * C                             # the pair's slot in its expert
    owner = torch.where(keep, (slot // Cl) * split + blk % split, n)   # n: not sent
    row = (fid % e_loc) * Cl + slot % Cl              # its row of the owner's buffer
    owner, row = owner.view(n, T * k), row.view(n, T * k)
    # this rank's kept pairs, by the rank that owns their slot (pair order within)
    mine = torch.argsort(owner[r], stable=True)
    mine = mine[owner[r][mine] < n]
    send_counts = torch.bincount(owner[r][mine], minlength=n).tolist()
    # the rows every rank sends here, by source rank, each in its pair order
    to_me = owner == r                                                  # [n, T k]
    recv_counts = to_me.sum(1).tolist()
    recv_row = row[to_me]
    recv = _exchange_rows(xn[tok[mine]], recv_counts, send_counts, group)
    buf = torch.zeros((e_loc * Cl, e), dtype=cdt, device=xn.device).index_add(0, recv_row, recv)
    yb = _expert_ffn(buf.view(e_loc, Cl, e), p, cfg)                    # [E/m, C/n, e]
    back = _exchange_rows(yb.reshape(e_loc * Cl, e)[recv_row], send_counts, recv_counts, group)
    got = torch.zeros((T * k, e), dtype=cdt, device=xn.device).index_add(0, mine, back)
    got = got * (gates.reshape(T * k) * keep.view(n, T * k)[r]).to(cdt)[:, None]
    # each token's k parts summed in a fixed order (JAX scatter-adds them)
    y = got.view(T, k, e).sum(1)
    if model is not None and split == 1:
        # decode: the model ranks' experts' parts of the same tokens
        all_reduce(y, model.group)
    return y


class _AllToAllRows(torch.autograd.Function):
    """``all_to_all_single`` of rows over ``group``, ``in_splits`` rows to
    each rank and ``out_splits`` from each; its backward sends the
    gradient's rows back with the splits swapped."""

    @staticmethod
    def forward(ctx, x, out_splits, in_splits, group):
        ctx.meta = (out_splits, in_splits, group)
        return _all_to_all_rows(x, out_splits, in_splits, group)

    @staticmethod
    def backward(ctx, g):
        out_splits, in_splits, group = ctx.meta
        return _all_to_all_rows(g, in_splits, out_splits, group), None, None, None


def _exchange_rows(x: torch.Tensor, out_splits: List[int], in_splits: List[int],
                   group) -> torch.Tensor:
    """``_AllToAllRows`` over ``group``; without one (a group of one rank)
    the rows as they are."""
    return x if group is None else _AllToAllRows.apply(x, out_splits, in_splits, group)


def _all_to_all_rows(x: torch.Tensor, out_splits: List[int], in_splits: List[int],
                     group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((sum(out_splits),) + tuple(x.shape[1:]))
    all_to_all(out, x, group, out_splits, in_splits)
    return out


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's t [T, ...] of ``group``, concatenated in rank order."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    all_gather_flat(out, t, group)
    return out


class SendPlan(NamedTuple):
    """The first stage of ``moe_a2a``'s plan on one shard: a pair of its
    T*k (token, k) pairs fits if its rank among the pairs bound for its
    expert's shard, in token order, is below ``send_capacity`` (S_cap), and
    takes row ``slot`` of the send buffer (the dump row n_sh*S_cap where it
    does not); the buffer's local expert ids [n_sh, S_cap] (-1 in the rows
    no pair took)."""
    keep: torch.Tensor           # [T*k] bool
    slot: torch.Tensor           # [T*k] int64
    send_capacity: int
    send_eid: torch.Tensor       # [n_sh, S_cap] int64

    def kept(self, recv: "RecvPlan") -> torch.Tensor:
        """[T*k] bool at one shard, where what is sent is received: the
        pairs that reach an expert (``keep`` and ``recv_keep[slot]``)."""
        n = recv.recv_keep.numel()
        return self.keep & recv.recv_keep[self.slot.clamp(0, n - 1)]


class RecvPlan(NamedTuple):
    """The second stage on one shard, for the N rows it received: a row
    that holds a pair (local expert id >= 0) fits if its rank among the rows
    of that expert is below ``expert_capacity`` (C2), and takes row
    ``recv_slot`` of the experts' buffer (the dump row e_loc*C2 where it
    does not)."""
    recv_keep: torch.Tensor      # [N] bool
    recv_slot: torch.Tensor      # [N] int64
    expert_capacity: int


def send_plan(ids: torch.Tensor, cfg: ArchConfig, n_sh: int) -> SendPlan:
    """The pairs of expert ids [T, k] packed by destination shard, as JAX's
    ``local_moe`` ranks them: S_cap = max(int(T k cf / n_sh), 8)."""
    T, k = ids.shape
    e_loc = cfg.n_experts // n_sh
    S = max(int(T * k * cfg.capacity_factor / n_sh), 8)
    fid = ids.reshape(-1)
    dest = fid // e_loc                                       # the target shard
    rank = _ranks(dest)
    keep = rank < S
    slot = torch.where(keep, dest * S + rank, n_sh * S)
    N = n_sh * S
    # the dropped pairs write -1 into the dump row, which is cut off
    eid = torch.full((N + 1,), -1, dtype=fid.dtype, device=fid.device)
    eid[slot] = torch.where(keep, fid % e_loc, -1)
    return SendPlan(keep, slot, S, eid[:N].view(n_sh, S))


def recv_plan(rid: torch.Tensor, cfg: ArchConfig, n_sh: int) -> RecvPlan:
    """The N received rows' local expert ids ``rid`` [N] ranked into the
    shard's experts: C2 = max(int(N cf / e_loc), 8)."""
    N = rid.numel()
    e_loc = cfg.n_experts // n_sh
    C2 = max(int(N * cfg.capacity_factor / e_loc), 8)
    rank2 = _ranks(rid)
    keep2 = (rid >= 0) & (rank2 < C2)
    slot2 = torch.where(keep2, rid * C2 + rank2, e_loc * C2)
    return RecvPlan(keep2, slot2, C2)


# ---------------------------------------------------------------------- #
# the exchanges between the stages: each takes the buffers [n_sh, ...] of
# the shards this process holds, one list entry a shard, and returns what
# each of them receives, in the same order
# ---------------------------------------------------------------------- #
Exchange = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def _identity(sends: List[torch.Tensor]) -> List[torch.Tensor]:
    """One shard and no mesh: what is sent is received."""
    return sends


def loopback_exchange(sends: List[torch.Tensor]) -> List[torch.Tensor]:
    """All n_sh shards in one process: shard r receives ``sends[src][r]``
    from every src, at position src (JAX's ``all_to_all`` over "model"
    with split and concat axis 0). Differentiable through autograd."""
    n = len(sends)
    return [torch.stack([sends[src][r] for src in range(n)]) for r in range(n)]


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` with equal splits on dim 0; its
    backward is the all-to-all of the gradient (the exchange is its own
    transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    all_to_all(out, x, group)
    return out


def group_exchange(group) -> Exchange:
    """The exchange of one rank's shard over the model axis's process
    group: floating buffers through ``_AllToAll`` (differentiable), the
    integer expert ids through ``all_to_all_single``."""
    def exchange(sends: List[torch.Tensor]) -> List[torch.Tensor]:
        (x,) = sends
        if x.is_floating_point():
            return [_AllToAll.apply(x, group)]
        return [_all_to_all(x, group)]
    return exchange


def _gather_data(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """[e_loc, C2, e] of each data rank -> [e_loc, n*C2, e], rank d's rows
    at d*C2 (JAX's ``all_gather(axis=1, tiled=True)``)."""
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    all_gather_flat(out, x, group)
    return out.view((n,) + tuple(x.shape)).movedim(0, 1).reshape(
        x.shape[0], n * x.shape[1], x.shape[2])


def _scatter_data(y: torch.Tensor, group, n: int) -> torch.Tensor:
    """[e_loc, n*C2, e] summed over the data ranks, rank d keeping rows
    [d*C2, (d+1)*C2) (JAX's ``psum_scatter(scatter_dimension=1,
    tiled=True)``)."""
    e_loc, nc, e = y.shape
    parts = y.reshape(e_loc, n, nc // n, e).movedim(1, 0).reshape(n * e_loc, nc // n, e)
    out = torch.empty((e_loc, nc // n, e), dtype=y.dtype, device=y.device)
    reduce_scatter_flat(out, parts, group)
    return out


class _GatherData(torch.autograd.Function):
    """``moe_ep2d``'s gather over "data"; its backward is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return _gather_data(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return _scatter_data(g, ctx.group, ctx.n), None, None


class _ScatterData(torch.autograd.Function):
    """``moe_ep2d``'s reduce-scatter over "data"; its backward is the gather."""

    @staticmethod
    def forward(ctx, y, group, n):
        ctx.group, ctx.n = group, n
        return _scatter_data(y, group, n)

    @staticmethod
    def backward(ctx, g):
        return _gather_data(g, ctx.group, ctx.n), None, None


# ---------------------------------------------------------------------- #
# the three stages of ``moe_a2a``, each on one shard
# ---------------------------------------------------------------------- #
class Packed(NamedTuple):
    """A shard's tokens after stage 1: the normed tokens [T, e], the gates
    [T, k], the first stage's plan and the send buffer [n_sh, S_cap, e]."""
    xn: torch.Tensor
    gates: torch.Tensor
    plan: SendPlan
    send: torch.Tensor


def a2a_pack(x: torch.Tensor, p: Dict, cfg: ArchConfig, n_sh: int) -> Packed:
    """Stage 1: route the shard's tokens x [b, s, e] and pack the kept
    pairs into the send buffer, by destination shard."""
    b, s, e = x.shape
    cdt = x.dtype
    k, T = cfg.top_k, b * s
    xn = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, e)
    gates, ids = _route(xn, p, cfg)                                     # [T, k]
    plan = send_plan(ids, cfg, n_sh)
    N = n_sh * plan.send_capacity
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    send = torch.zeros((N + 1, e), dtype=cdt, device=x.device)
    send = send.index_add(0, plan.slot, xn[tok] * plan.keep.to(cdt)[:, None])[:N]
    return Packed(xn, gates, plan, send.view(n_sh, plan.send_capacity, e))


def a2a_experts(recv: torch.Tensor, recv_eid: torch.Tensor, p: Dict, cfg: ArchConfig,
                n_sh: int, data=None) -> Tuple[torch.Tensor, RecvPlan]:
    """Stage 2: the received rows [n_sh, S_cap, e] (with their local expert
    ids) into the shard's e_loc experts' buffers, the experts' products,
    and the rows back in their received order [n_sh, S_cap, e]. ``data``,
    under ``moe_ep2d``, is (the "data" group, its size): the buffers are
    gathered over it before the products (the shard holds its data slice
    of each expert's f) and the partial outputs reduce-scattered after."""
    _, S, e = recv.shape
    cdt = recv.dtype
    N = n_sh * S
    e_loc = cfg.n_experts // n_sh
    rp = recv_plan(recv_eid.reshape(N), cfg, n_sh)
    C2 = rp.expert_capacity
    keep2 = rp.recv_keep.to(cdt)[:, None]
    buf = torch.zeros((e_loc * C2 + 1, e), dtype=cdt, device=recv.device)
    buf = buf.index_add(0, rp.recv_slot, recv.reshape(N, e) * keep2)[:e_loc * C2]
    xb = buf.view(e_loc, C2, e)
    if data is not None:
        xb = _GatherData.apply(xb, *data)                               # [e_loc, D*C2, e]
    yb = _expert_ffn(xb, p, cfg)
    if data is not None:
        yb = _ScatterData.apply(yb, *data)                              # [e_loc, C2, e]
    ry = yb.reshape(e_loc * C2, e)[rp.recv_slot.clamp(0, e_loc * C2 - 1)] * keep2
    return ry.view(n_sh, S, e), rp


def a2a_combine(back: torch.Tensor, packed: Packed, cfg: ArchConfig) -> torch.Tensor:
    """Stage 3: the rows back in their send slots [n_sh, S_cap, e], scaled
    by the gates, each token's k parts summed: y [T, e]."""
    cdt = back.dtype
    N, e = back.shape[0] * back.shape[1], back.shape[2]
    T, k = packed.gates.shape
    plan = packed.plan
    got = back.reshape(N, e)[plan.slot.clamp(0, N - 1)]
    got = got * (plan.keep.to(cdt) * packed.gates.reshape(T * k).to(cdt))[:, None]
    # each token's k parts summed in a fixed order (JAX scatter-adds them)
    return got.view(T, k, e).sum(1)


class ShardRun(NamedTuple):
    """What ``moe_a2a_shards`` returns for each shard: y [b, s, e] without
    the shared expert, and both stages' plans."""
    y: torch.Tensor
    send: SendPlan
    recv: RecvPlan


def moe_a2a_shards(xs: List[torch.Tensor], ps: List[Dict], cfg: ArchConfig, n_sh: int,
                   exchange: Exchange, data=None) -> List[ShardRun]:
    """The body of JAX's ``local_moe`` for the shards this process holds:
    xs[i] [b, s, e] and ps[i] (the router and norm, and the shard's e_loc
    experts) are shard i's. The model passes its one shard and the model
    group's exchange (``group_exchange``); a test or a card check passes
    all n_sh shards and ``loopback_exchange``."""
    packs = [a2a_pack(x, p, cfg, n_sh) for x, p in zip(xs, ps)]
    recv = exchange([pk.send for pk in packs])
    recv_eid = exchange([pk.plan.send_eid for pk in packs])
    outs = [a2a_experts(r, i, p, cfg, n_sh, data) for r, i, p in zip(recv, recv_eid, ps)]
    back = exchange([ry for ry, _ in outs])
    return [ShardRun(a2a_combine(bk, pk, cfg).view(x.shape), pk.plan, rp)
            for bk, pk, (_, rp), x in zip(back, packs, outs, xs)]


def moe_shard_params(p: Dict, cfg: ArchConfig, model: Tuple[int, int],
                     data: Tuple[int, int] = (0, 1)) -> Dict:
    """Shard (m, n_sh) of the model axis's slice of a full parameter dict:
    its e_loc = E / n_sh experts (JAX's ``w_spec``); under ``moe_ep2d``
    with data (d, D), also data rank d's slice of each expert's f
    (``wu_spec`` / ``wd_spec``). The rest is replicated."""
    (m, n_sh), (d, D) = model, data
    e_loc = cfg.n_experts // n_sh
    ex = slice(m * e_loc, (m + 1) * e_loc)
    out = dict(p)
    out["w_up"], out["w_gate"], out["w_down"] = p["w_up"][ex], p["w_gate"][ex], p["w_down"][ex]
    if cfg.moe_ep2d and D > 1:
        f = cfg.expert_ff // D
        fs = slice(d * f, (d + 1) * f)
        out["w_up"], out["w_gate"] = out["w_up"][:, :, fs], out["w_gate"][:, :, fs]
        out["w_down"] = out["w_down"][:, fs]
    return out


def moe_shard_input(x: torch.Tensor, cfg: ArchConfig, model: Tuple[int, int],
                    data: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Rank (d, m)'s slice of x [b, s, e] (JAX's ``x_spec``): its batch rows
    over "data", its sequence positions over "model"; where s % n_sh is
    nonzero, where JAX's ``moe_a2a`` falls back to the dispatch, every
    position (decode's token is whole over "model")."""
    b, s, _ = x.shape
    (m, n_sh), (d, D) = model, data
    if b % D:
        raise ValueError(f"batch {b} does not split over {D} data ranks")
    rows = slice(d * b // D, (d + 1) * b // D)
    if s % n_sh:
        # JAX's moe_a2a falls back to the dispatch, over tokens whole on
        # every model shard (decode's one position)
        return x[rows]
    return x[rows, m * s // n_sh:(m + 1) * s // n_sh]


def moe_a2a(x: torch.Tensor, p: Dict, cfg: ArchConfig, ctx=None) -> torch.Tensor:
    """JAX's ``moe_a2a``: the pairs packed into the send buffer by their
    expert's shard, the all-to-all out over "model", the received rows into
    the local experts' buffers, the experts' products, the all-to-all back
    and the gated parts summed into their tokens; the shared expert added
    outside, as JAX adds it.

    Without a mesh (``ctx`` None, or ``ctx.mesh`` None) it runs one shard,
    over which the all-to-alls are the identity. Under a ("data", "model")
    mesh each rank calls it on its own x [b_loc, s_loc, e] (batch over
    "data", sequence over "model": ``moe_shard_input``) and p
    (``moe_shard_params``), and the
    exchanges are the mesh's collectives; under ``moe_ep2d`` the buffers
    are also gathered and reduce-scattered over "data". Where JAX falls
    back to ``moe_dispatch`` under a mesh (``repro/models/moe.py:165-174``:
    no "model" axis, or E % n_sh nonzero) p holds every expert and the
    dispatch plans the mesh's tokens (``moe_dispatch`` over the mesh's
    flattened group), as GSPMD's partitioned dispatch does."""
    n_sh, exchange, data = 1, _identity, None
    mesh = None if ctx is None else ctx.mesh
    if mesh is not None:
        sizes = mesh_shape(mesh)
        n_sh = sizes.get("model", 0)
        if not n_sh or cfg.n_experts % n_sh:
            return moe_dispatch(x, p, cfg, *_token_group(ctx))
        exchange = group_exchange(mesh.get_group("model"))
        if cfg.moe_ep2d and "data" in sizes:
            data = (mesh.get_group("data"), sizes["data"])
    return add_shared(moe_a2a_shards([x], [p], cfg, n_sh, exchange, data)[0].y, x, p, cfg)


def add_shared(y: torch.Tensor, x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """y [b, s, e] plus the shared expert of x, as ``moe_a2a`` adds it
    outside the all-to-all body (y itself without a shared expert)."""
    if not cfg.moe_shared:
        return y
    b, s, e = x.shape
    xn = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(b * s, e)
    return y + _shared(xn, p, cfg).view(b, s, e)


def _token_group(ctx, seq_split: bool = True) -> Tuple[object, int]:
    """(the group over which ``ctx``'s mesh splits the batch, the ranks to
    a sequence): with ``seq_split`` the flattened batch and "model" axes,
    whose consecutive "model" ranks hold one sequence's blocks; without
    (decode's token, whole over "model") the batch axes alone."""
    if not seq_split:
        return axis_group(ctx.mesh, batch_axes(ctx))[0], 1
    group, _ = axis_group(ctx.mesh, batch_axes(ctx) + ("model",))
    return group, mesh_shape(ctx.mesh).get("model", 1)


def expert_shards(cfg: ArchConfig, mesh) -> int:
    """The "model" shards over which the layer holds its experts under
    ``mesh``, E / m a rank (the model keeps their split): the axis's size
    m where it exceeds 1, E divides by it and the layer routes (JAX's
    "expert" -> "model" rule, which ``moe_a2a``'s shards and the dispatch
    buffer's constraint follow), else 1 (the dense oracle's experts, and
    an E that does not divide, stay whole)."""
    m = 1 if mesh is None else mesh_shape(mesh).get("model", 1)
    return m if cfg.moe_impl != "dense" and m > 1 and cfg.n_experts % m == 0 else 1


def _f_slice(p: Dict, cfg: ArchConfig, mesh) -> Dict:
    """Under ``moe_ep2d``, data rank d's slice of each expert's f (JAX's
    ``wu_spec`` / ``wd_spec``) from the rank's experts whole over "data"."""
    sizes = mesh_shape(mesh)
    D = sizes.get("data", 1)
    if not cfg.moe_ep2d or D == 1:
        return p
    d = mesh.get_coordinate()[list(mesh.mesh_dim_names).index("data")]
    f = slice(d * cfg.expert_ff // D, (d + 1) * cfg.expert_ff // D)
    return {**p, "w_up": p["w_up"][:, :, f], "w_gate": p["w_gate"][:, :, f],
            "w_down": p["w_down"][:, f]}


def moe(x: torch.Tensor, p: Dict, cfg: ArchConfig, ctx=None,
        seq_split: bool = True) -> torch.Tensor:
    """The layer ``cfg.moe_impl`` names, on this rank's block of the batch
    under ``ctx``'s mesh: its rows over the batch axes and, with
    ``seq_split``, its positions over "model" (decode's one position is
    whole over "model"); p holds the rank's E / m experts where
    ``expert_shards`` is m > 1 (under ``moe_ep2d`` their f is sliced over
    "data" here for ``moe_a2a``). The dense oracle couples no tokens.
    ``moe_a2a`` runs over the "model" group where the experts are split and
    so is the sequence, and at one model shard on the rank's own tokens, as
    JAX's ``shard_map`` body does. The dispatch, and ``moe_a2a`` where JAX
    falls back to it (decode: s % n_sh nonzero), ranks its pairs over the
    mesh's tokens in their global order and splits its buffer: the
    capacity over the ranks that hold distinct tokens, the experts over
    "model" (``moe_dispatch``)."""
    if cfg.moe_impl == "dense":
        return moe_dense(x, p, cfg)
    mesh = None if ctx is None else ctx.mesh
    split = expert_shards(cfg, mesh) > 1
    if cfg.moe_impl == "a2a" and seq_split and split:
        return moe_a2a(x, _f_slice(p, cfg, mesh), cfg, ctx)
    if cfg.moe_impl == "a2a" and (mesh is None or mesh_shape(mesh).get("model", 1) == 1):
        return moe_a2a(x, p, cfg)
    if mesh is None:
        return moe_dispatch(x, p, cfg)
    return moe_dispatch(x, p, cfg, *_token_group(ctx, seq_split),
                        model=seq_shards(ctx) if split else None)
