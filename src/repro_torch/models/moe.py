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
are no-ops without a mesh and are dropped; ``moe_a2a``, its expert
parallelism over an all-to-all, needs several cards and is not ported.
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


def dispatch_plan(ids: torch.Tensor, cfg: ArchConfig) -> DispatchPlan:
    """The plan of ``moe_dispatch`` for expert ids [T, k]."""
    T = ids.shape[0]
    C = capacity(T, cfg)
    fid = ids.reshape(-1)
    order = torch.argsort(fid, stable=True)
    sorted_fid = fid[order]
    # the first position of each expert in the sorted stream
    first = torch.searchsorted(sorted_fid, sorted_fid, side="left")
    rank = torch.empty_like(fid)
    rank[order] = torch.arange(fid.numel(), device=fid.device) - first
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


def moe(x: torch.Tensor, p: Dict, cfg: ArchConfig) -> torch.Tensor:
    if cfg.moe_impl == "dense":
        return moe_dense(x, p, cfg)
    if cfg.moe_impl == "a2a":
        raise NotImplementedError(
            "moe_impl='a2a' (expert parallelism over an all-to-all) lands with "
            "parallel/ (A14)")
    return moe_dispatch(x, p, cfg)
