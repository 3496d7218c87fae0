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
are no-ops without a mesh and are dropped.

``moe_a2a`` is the body of JAX's expert parallelism over an all-to-all
(``local_moe`` in ``repro/models/moe.py``) at one model shard: the pairs
are ranked twice, into a send buffer by their destination shard
(``a2a_plan``'s first stage, capacity ``S_cap`` a shard), then into each
local expert's buffer (its second stage, capacity ``C2`` an expert). JAX's
runtime always binds a ("data", "model") mesh, so on one device it runs
this body; the port has one shard, over which the two all-to-alls, and
``moe_ep2d``'s gather and reduce-scatter over a data axis of size 1, are
the identity. The all-to-all over several cards is not ported.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .config import ArchConfig
from .layers import ParamSpec, rmsnorm


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    e, f, E = cfg.d_model, cfg.expert_ff, cfg.n_experts
    specs = {
        "router": ParamSpec((e, E), init="small"),
        "w_up": ParamSpec((E, e, f)),
        "w_gate": ParamSpec((E, e, f)),
        "w_down": ParamSpec((E, f, e)),
        "norm": ParamSpec((e,), init="zeros"),
    }
    if cfg.moe_shared:
        specs["shared_up"] = ParamSpec((e, f * cfg.moe_shared))
        specs["shared_gate"] = ParamSpec((e, f * cfg.moe_shared))
        specs["shared_down"] = ParamSpec((f * cfg.moe_shared, e))
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


def moe_dispatch(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """Capacity-based scatter dispatch (see the module docstring)."""
    b, s, e = x.shape
    cdt = x.dtype
    E, k, T = cfg.n_experts, cfg.top_k, b * s
    xn = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, e)
    gates, ids = _route(xn, p, cfg)                                     # [T, k]
    plan = dispatch_plan(ids, cfg)
    C = plan.capacity
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    keep = plan.keep.to(cdt)[:, None]
    # each kept pair has a row of its own; the dropped ones add zeros into the dump row
    buf = torch.zeros((E * C + 1, e), dtype=cdt, device=x.device)
    buf = buf.index_add(0, plan.dest, xn[tok] * keep)
    yb = _expert_ffn(buf[:E * C].view(E, C, e), p, cfg)                 # [E, C, e]
    gathered = yb.reshape(E * C, e)[plan.dest.clamp(0, E * C - 1)]
    gathered = gathered * (gates.reshape(T * k) * plan.keep).to(cdt)[:, None]
    # each token's k parts summed in a fixed order (JAX scatter-adds them)
    y = gathered.view(T, k, e).sum(1)
    y = y + _shared(xn, p, cfg)
    return y.reshape(b, s, e)


# the model shards ``moe_a2a`` spreads the experts over: one card
A2A_SHARDS = 1


class A2aPlan(NamedTuple):
    """Where the T*k (token, k) pairs go in ``moe_a2a``, in two stages.
    First into the send buffer: a pair fits if its rank among the pairs
    bound for its expert's shard, in token order, is below ``send_capacity``
    (S_cap), and takes row ``slot`` (the dump row n_sh*S_cap where it does
    not). Then each received row into its local expert's buffer: a row
    that holds a pair (``recv_eid`` >= 0, -1 in an empty row) fits if its
    rank among the rows of that expert is below ``expert_capacity`` (C2),
    and takes row ``recv_slot`` (the dump row e_loc*C2 where it does not).
    A pair reaches an expert where ``keep`` and ``recv_keep[slot]`` hold."""
    keep: torch.Tensor           # [T*k] bool
    slot: torch.Tensor           # [T*k] int64
    send_capacity: int
    recv_eid: torch.Tensor       # [n_sh*S_cap] int64, the local expert or -1
    recv_keep: torch.Tensor      # [n_sh*S_cap] bool
    recv_slot: torch.Tensor      # [n_sh*S_cap] int64
    expert_capacity: int

    def kept(self) -> torch.Tensor:
        """[T*k] bool: the pairs that reach an expert."""
        n = self.recv_keep.numel()
        return self.keep & self.recv_keep[self.slot.clamp(0, n - 1)]


def a2a_plan(ids: torch.Tensor, cfg: ArchConfig) -> A2aPlan:
    """The plan of ``moe_a2a`` for expert ids [T, k] at ``A2A_SHARDS``
    shards: JAX's ``local_moe`` ranks, with both capacities,
    S_cap = max(int(T k cf / n_sh), 8) and C2 = max(int(N cf / e_loc), 8)
    for the N = n_sh * S_cap received rows."""
    T, k = ids.shape
    n_sh = A2A_SHARDS
    e_loc = cfg.n_experts // n_sh
    S = max(int(T * k * cfg.capacity_factor / n_sh), 8)
    fid = ids.reshape(-1)
    dest = fid // e_loc                                       # the target shard
    rank = _ranks(dest)
    keep = rank < S
    slot = torch.where(keep, dest * S + rank, n_sh * S)
    N = n_sh * S
    # the send buffer's local expert ids, -1 in the rows no pair took; the
    # dropped pairs write -1 into the dump row, which is cut off. The
    # all-to-all at one shard is the identity: what is sent is received
    eid = torch.full((N + 1,), -1, dtype=fid.dtype, device=fid.device)
    eid[slot] = torch.where(keep, fid % e_loc, -1)
    rid = eid[:N]
    C2 = max(int(N * cfg.capacity_factor / e_loc), 8)
    rank2 = _ranks(rid)
    keep2 = (rid >= 0) & (rank2 < C2)
    slot2 = torch.where(keep2, rid * C2 + rank2, e_loc * C2)
    return A2aPlan(keep, slot, S, rid, keep2, slot2, C2)


def moe_a2a(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    """JAX's ``moe_a2a`` at one model shard: the pairs packed into the send
    buffer, the received rows into the local experts' buffers, the experts'
    products, the rows back to their send slots and the gated parts summed
    into their tokens; the shared expert added outside, as JAX adds it."""
    b, s, e = x.shape
    cdt = x.dtype
    k, T = cfg.top_k, b * s
    xn = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, e)
    gates, ids = _route(xn, p, cfg)                                     # [T, k]
    plan = a2a_plan(ids, cfg)
    N = plan.recv_eid.numel()
    e_loc, C2 = cfg.n_experts // A2A_SHARDS, plan.expert_capacity
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    send = torch.zeros((N + 1, e), dtype=cdt, device=x.device)
    send = send.index_add(0, plan.slot, xn[tok] * plan.keep.to(cdt)[:, None])[:N]
    # all-to-all out at one shard: the rows received are the rows sent
    keep2 = plan.recv_keep.to(cdt)[:, None]
    buf = torch.zeros((e_loc * C2 + 1, e), dtype=cdt, device=x.device)
    buf = buf.index_add(0, plan.recv_slot, send * keep2)[:e_loc * C2]
    # moe_ep2d's gather over "data" before the products and its
    # reduce-scatter after them: the identity over a data axis of size 1
    yb = _expert_ffn(buf.view(e_loc, C2, e), p, cfg)                    # [e_loc, C2, e]
    ry = yb.reshape(e_loc * C2, e)[plan.recv_slot.clamp(0, e_loc * C2 - 1)] * keep2
    # all-to-all back at one shard: the rows return to their send slots
    got = ry[plan.slot.clamp(0, N - 1)]
    got = got * (plan.keep.to(cdt) * gates.reshape(T * k).to(cdt))[:, None]
    # each token's k parts summed in a fixed order (JAX scatter-adds them)
    y = got.view(T, k, e).sum(1)
    if cfg.moe_shared:
        y = y + _shared(xn, p, cfg)
    return y.reshape(b, s, e)


def moe(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.moe_impl == "dense":
        return moe_dense(x, p, cfg)
    if cfg.moe_impl == "a2a":
        return moe_a2a(x, p, cfg)
    return moe_dispatch(x, p, cfg)
