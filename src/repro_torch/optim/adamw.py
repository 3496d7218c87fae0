"""Optimizers: AdamW and Adafactor, the port of ``repro/optim/adamw.py``.

The parameters are a flat ``{name: tensor}`` dict in JAX's flatten order
(the model's ``state_dict`` names); the state mirrors it. ``apply_updates``
follows JAX's arithmetic step for step, in fp32: the global-norm clip of
the gradients, then AdamW with ``rsqrt(v / bc2 + eps^2)`` (eps inside the
square root, unlike ``torch.optim.AdamW``) and decay only where ``ndim >=
2``, or Adafactor with factored second moments and its RMS update clip.

Unlike JAX's pure function it updates the parameters and the state in
place, one leaf at a time, and AdamW one slice of at most
``CHUNK_ELEMENTS`` elements at a time (its arithmetic is elementwise): at
full width the fp32 masters, gradients and both moments already fill most
of the card, so no temporary may span the whole tree or a whole stacked
leaf.

Under the Zero-3 layout (``LeafShards``) each rank updates its shards of
the masters and the moments: AdamW is elementwise and needs nothing more;
the global norm sums each rank's squares of a split leaf over the mesh
axes the leaf is split over (the whole leaves once), and Adafactor sums
its means over the axes a dimension is split over before dividing. The
state mirrors the masters' layout (``opt_state_specs``, as JAX's).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..parallel.sharding import PartitionSpec, all_reduce, axis_group, spec_axes
from .schedule import warmup_cosine

CHUNK_ELEMENTS = 1 << 26        # 256 MB of fp32 per temporary


class OptState(NamedTuple):
    step: int
    mu: Dict[str, torch.Tensor]     # first moment (AdamW) or {} (Adafactor)
    nu: Dict[str, object]           # second moment; Adafactor: {"row", "col"} or {"full"}


@dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"        # adamw | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup: int = 100
    total_steps: int = 10_000


class LeafShards(NamedTuple):
    """The layout of a tree of leaves over a mesh: each leaf's spec (the
    mesh axes each dimension is split over) and the mesh (None in one
    process, where every leaf is whole)."""
    specs: Dict[str, PartitionSpec]
    mesh: Any = None

    def axes(self, name: str, dim: Optional[int] = None) -> Tuple[str, ...]:
        """The mesh axes leaf ``name`` is split over, on ``dim`` or (None)
        on any dimension."""
        return spec_axes(self.specs[name], dim)

    def group(self, axes: Tuple[str, ...]) -> Tuple[Any, int]:
        """(group, size) over ``axes``' ranks; (None, 1) without a mesh."""
        return axis_group(self.mesh, axes)


def _factored(shape: Tuple[int, ...]) -> bool:
    return len(shape) >= 2


def opt_state_specs(param_specs: Dict, cfg: OptConfig) -> OptState:
    """The ParamSpecs of the optimizer state for a flat {name: ParamSpec}
    of the parameters: the moments mirror each parameter's axes; Adafactor's
    ``row`` takes ``axes[:-1]``, ``col`` ``axes[:-2] + axes[-1:]``."""
    from ..models.layers import ParamSpec

    def mirror(s):
        return ParamSpec(s.shape, s.axes, init="zeros", dtype="float32")

    step = ParamSpec((), (), "zeros", "int32")
    if cfg.kind == "adafactor":
        def nu_leaf(s):
            if _factored(s.shape):
                return {"row": ParamSpec(s.shape[:-1], s.axes[:-1], "zeros", "float32"),
                        "col": ParamSpec(s.shape[:-2] + s.shape[-1:], s.axes[:-2] + s.axes[-1:],
                                         "zeros", "float32")}
            return {"full": mirror(s)}
        return OptState(step=step, mu={}, nu={n: nu_leaf(s) for n, s in param_specs.items()})
    return OptState(step=step, mu={n: mirror(s) for n, s in param_specs.items()},
                    nu={n: mirror(s) for n, s in param_specs.items()})


def init_opt_state(params: Dict[str, torch.Tensor], cfg: OptConfig) -> OptState:
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    if cfg.kind == "adafactor":
        nu = {n: ({"col": zeros(p.shape[:-2] + p.shape[-1:], p), "row": zeros(p.shape[:-1], p)}
                  if _factored(p.shape) else {"full": zeros(p.shape, p)})
              for n, p in params.items()}
        return OptState(step=0, mu={}, nu=nu)
    return OptState(step=0, mu={n: zeros(p.shape, p) for n, p in params.items()},
                    nu={n: zeros(p.shape, p) for n, p in params.items()})


def global_norm(tree: Dict[str, torch.Tensor], shards: Optional[LeafShards] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32. With ``shards``
    the leaves split over the same mesh axes have their squares summed
    together and, across the ranks of those axes, over their group; the
    whole leaves' are added once. Without, every leaf is whole. In one
    process the partition is kept, so that groups of one are the same
    arithmetic."""
    zero = torch.zeros((), dtype=torch.float32, device=next(iter(tree.values())).device)
    sums: Dict[Tuple[str, ...], torch.Tensor] = {}
    for n, g in tree.items():
        key = () if shards is None else tuple(sorted(set(shards.axes(n))))
        sums[key] = sums.get(key, zero) + torch.sum(torch.square(g.float()))
    whole = sums.pop((), zero)
    split = zero
    for key in sorted(sums):
        group, _ = (None, 1) if shards is None else shards.group(key)
        if group is not None:
            all_reduce(sums[key], group)
        split = split + sums[key]
    return torch.sqrt(split + whole)


def _mean(t: torch.Tensor, dim: Optional[int], axes: Tuple[str, ...],
          shards: Optional[LeafShards], keepdim: bool = False) -> torch.Tensor:
    """The mean of ``t`` over ``dim`` (every element where None); where that
    dimension (any, for None) is split over the mesh ``axes``, the ranks'
    sums are summed over their group and divided by the whole count."""
    group, n = (None, 1) if shards is None else shards.group(axes)
    if shards is None or shards.mesh is None or not axes:
        return torch.mean(t) if dim is None else t.mean(dim=dim, keepdim=keepdim)
    s = torch.sum(t) if dim is None else t.sum(dim=dim, keepdim=keepdim)
    if group is not None:
        all_reduce(s, group)
    count = t.numel() if dim is None else t.shape[dim]
    return s / (count * n)


def _chunks(t: torch.Tensor):
    """Slices of ``t`` along its first axis of at most about
    ``CHUNK_ELEMENTS`` elements (views: writes land in ``t``)."""
    if t.dim() == 0 or t.numel() <= CHUNK_ELEMENTS:
        return [t]
    rows = max(1, CHUNK_ELEMENTS // (t.numel() // t.shape[0]))
    return list(torch.split(t, rows))


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                  state: OptState, cfg: OptConfig,
                  shards: Optional[LeafShards] = None) -> OptState:
    """One optimizer step: updates ``params`` (and the moments in
    ``state``) in place and returns the state with its step advanced. The
    gradients are scaled in place when they are fp32 (they are consumed).
    ``shards``: the layout of ``params`` (and of ``grads``) over the mesh,
    when they are this rank's shards."""
    dev = next(iter(params.values())).device
    step = state.step + 1
    stepf = torch.tensor(step, dtype=torch.float32, device=dev)
    lr = warmup_cosine(stepf, cfg.lr, cfg.warmup, cfg.total_steps)
    gn = global_norm(grads, shards)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

    if cfg.kind == "adafactor":
        eps2 = 1e-30
        decay = 1.0 - torch.pow(stepf + 1.0, -0.8)
        for name, p in params.items():
            g = grads[name].float() * scale
            nu = state.nu[name]
            g2 = g * g + eps2
            def axes(dim=None):
                return () if shards is None else shards.axes(name, dim)
            if _factored(p.shape):
                last, rows = p.dim() - 1, p.dim() - 2
                nu["row"].copy_(decay * nu["row"]
                                + (1 - decay) * _mean(g2, -1, axes(last), shards))
                nu["col"].copy_(decay * nu["col"]
                                + (1 - decay) * _mean(g2, -2, axes(rows), shards))
                rmean = _mean(nu["row"], -1, axes(rows), shards, keepdim=True)
                vhat = (nu["row"] / torch.clamp(rmean, min=eps2))[..., None] \
                    * nu["col"][..., None, :]
                u = g * torch.rsqrt(torch.clamp(vhat, min=eps2))
            else:
                nu["full"].copy_(decay * nu["full"] + (1 - decay) * g2)
                u = g * torch.rsqrt(torch.clamp(nu["full"], min=eps2))
            # the RMS update clip
            rms = torch.sqrt(_mean(u * u, None, axes(), shards) + eps2)
            u = u / torch.clamp(rms, min=1.0)
            keep = 1 - lr * cfg.weight_decay * float(p.dim() >= 2)
            p.copy_((p.float() * keep - lr * u).to(p.dtype))
        return OptState(step=step, mu={}, nu=state.nu)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), stepf)
    eps2 = cfg.eps * cfg.eps
    for name, p in params.items():
        keep = 1 - lr * cfg.weight_decay * float(p.dim() >= 2)
        for pc, gc, m, v in zip(_chunks(p), _chunks(grads[name]), _chunks(state.mu[name]),
                                _chunks(state.nu[name])):
            g = gc.mul_(scale) if gc.dtype == torch.float32 else gc.float() * scale
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            u = (m / bc1).mul_(torch.rsqrt(v / bc2 + eps2))
            if pc.dtype == torch.float32:
                pc.mul_(keep).sub_(u.mul_(lr))
            else:
                pc.copy_((pc.float() * keep - lr * u).to(pc.dtype))
    return OptState(step=step, mu=state.mu, nu=state.nu)
