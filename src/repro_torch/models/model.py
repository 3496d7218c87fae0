"""Model facade: config -> parameters, train step, prefill step, serve
step, cache.

The port of ``repro/models/model.py``. ``Model`` is an ``nn.Module``
holding the stacked ``[L, ...]`` parameters of ``transformer.init_specs``;
its ``state_dict`` keys are the JAX tree's paths joined by dots
(``blocks.attn.wq``), so ``convert.params_from_jax`` loads JAX weights one
to one.

Parameters are fp32 masters, cast to the compute dtype at each use in
JAX. For serving, the model keeps a copy of the matrices that JAX casts
(the attention, MLP and expert ``w*``, the MoE shared expert's
``shared_*``, Mamba's ``in_proj``, ``conv_w``, ``conv_b`` and
``out_proj``) already in the compute dtype, made once when the weights
are set: the same rounding of the same fp32 numbers, so the values are
bit-identical to a cast at each use, without re-reading 11 GB of fp32
masters every step at full width. Norm weights, the MoE router, Mamba's
``A_log``, ``D`` and ``dt_bias``, and the embedding/LM head stay fp32.

Training (``train_step``) builds that cast anew inside the autograd graph
at every step, from the masters as they are, and drops the serving copy:
a cached cast would be detached from the graph and stale after the
update. The optimizer (``optim/adamw.py``) updates the masters in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from ..optim.adamw import OptConfig, OptState, apply_updates, init_opt_state
from .config import ArchConfig, ShapeConfig
from .layers import ParamSpec
from .transformer import decode_step, forward, init_cache_specs, init_specs, loss_fn


def _params_module(specs: Dict, device: torch.device) -> nn.Module:
    if all(isinstance(s, ParamSpec) for s in specs.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.empty(s.shape, dtype=getattr(torch, s.dtype),
                                        device=device), requires_grad=False)
            for k, s in specs.items()})
    return nn.ModuleDict({k: _params_module(v, device) for k, v in specs.items()})


def _tree(module: nn.Module) -> Dict:
    if isinstance(module, nn.ParameterDict):
        return dict(module.items())
    return {k: _tree(m) for k, m in module.items()}


# the parameters that JAX casts to the compute dtype at each use besides
# those that start with "w" (attention, MLP, experts): Mamba2's
# (repro/models/mamba2.py) and the MoE shared expert's (repro/models/moe.py);
# the MoE router stays fp32, as JAX reads it
_CAST = ("in_proj", "conv_w", "conv_b", "out_proj", "shared_up", "shared_gate", "shared_down")


def _cast(tree: Dict, dtype: torch.dtype) -> Dict:
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if k.startswith("w") or k in _CAST else v
            for k, v in tree.items()}


def _unflatten(flat: Mapping[str, torch.Tensor]) -> Dict:
    """{"a.b.c": t} -> {"a": {"b": {"c": t}}}."""
    tree: Dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def _flat_specs(specs: Dict, prefix: str = "") -> Dict[str, ParamSpec]:
    out = {}
    for k in sorted(specs):
        v = specs[k]
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device] = "cuda",
                 opt: Optional[OptConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.opt = opt if opt is not None else OptConfig(kind=cfg.optimizer)
        self.device = resolve_device(device)
        specs = init_specs(cfg)
        self.parts = tuple(specs)                    # embed, blocks (, shared)
        for name in self.parts:
            setattr(self, name, _params_module(specs[name], self.device))
        self._compute: Optional[Dict] = None

    # -------------------------------------------------------------- #
    # params
    # -------------------------------------------------------------- #
    def param_specs(self) -> Dict[str, ParamSpec]:
        """Flat {state_dict key: ParamSpec}, in JAX's flatten order."""
        return _flat_specs(init_specs(self.cfg))

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with JAX's init rule."""
        state = self.state_dict()
        for name, spec in self.param_specs().items():
            spec.materialize_(state[name], generator)
        self._compute = None

    @torch.no_grad()
    def load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy a full state dict (e.g. from ``convert.params_from_jax``)."""
        self.load_state_dict(state, strict=True)
        self._compute = None

    def compute_params(self) -> Dict:
        """The parameter tree the layers use: the matrices JAX casts in the
        compute dtype (cast once), the rest, and the embeddings, as stored."""
        if self._compute is None:
            cdt = getattr(torch, self.cfg.dtype)
            self._compute = {name: _cast(_tree(getattr(self, name)), cdt)
                             for name in self.parts}
        return self._compute

    def masters(self) -> Dict[str, torch.Tensor]:
        """The fp32 master parameters, {state_dict name: tensor} in JAX's
        flatten order; updating them updates the model."""
        params = dict(self.named_parameters())
        return {name: params[name].data for name in self.param_specs()}

    # -------------------------------------------------------------- #
    # training
    # -------------------------------------------------------------- #
    def init_opt(self) -> OptState:
        return init_opt_state(self.masters(), self.opt)

    def _value_and_grad(self, batch: Dict[str, torch.Tensor], group=None):
        """(loss, {name: grad}) of ``loss_fn`` at the current masters. The
        leaves are the masters themselves (detached aliases), or with
        ``cfg.bf16_grads`` copies of the fp32 ones in the compute dtype,
        whose gradients come back in that dtype (JAX's
        ``_value_and_grad``). The compute-dtype casts of the weight
        matrices are made inside the graph, from those leaves."""
        cdt = getattr(torch, self.cfg.dtype)
        leaves = {}
        for name, p in self.masters().items():
            leaf = p.detach()
            if self.cfg.bf16_grads and leaf.dtype == torch.float32:
                leaf = leaf.to(cdt)
            leaves[name] = leaf.requires_grad_()
        tree = _unflatten(leaves)
        params = {name: _cast(tree[name], cdt) for name in self.parts}
        loss = loss_fn(params, self.cfg, batch, group)
        # a stub frontend's model never reads its embedding table: its
        # gradient is zeros, as JAX's
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {name: torch.zeros_like(leaf) if g is None else g
                               for (name, leaf), g in zip(leaves.items(), grads)}

    def value_and_grad(self, batch: Dict[str, torch.Tensor], group=None):
        """(loss, {name: grad}) of a step's batch. With ``cfg.grad_accum``
        k > 1 the batch is split into k microbatches whose gradients are
        summed in fp32 and divided by k, and the loss is their mean (JAX's
        ``train_step``). ``group``: the data-parallel group when the batch
        is this rank's rows of a global one, microbatch i its rows of the
        global microbatch i (``loss_fn``)."""
        k = self.cfg.grad_accum
        if k <= 1:
            return self._value_and_grad(batch, group)
        micro = {n: t.reshape((k, t.shape[0] // k) + t.shape[1:]) for n, t in batch.items()}
        grads, losses = {}, []
        for i in range(k):
            loss, g = self._value_and_grad({n: t[i] for n, t in micro.items()}, group)
            losses.append(loss)
            for name, gi in g.items():
                if name in grads:
                    grads[name].add_(gi.float())
                else:
                    grads[name] = gi.float() if gi.dtype != torch.float32 else gi
            del g
        for g in grads.values():
            g.div_(k)
        return torch.stack(losses).mean(), grads

    def train_step(self, opt_state: OptState, batch: Dict[str, torch.Tensor],
                   reduce: Optional[Callable] = None, group=None):
        """One optimizer step on ``batch`` ({"tokens", "labels"} [b, s] on
        the model's device; a stub frontend's {"embeds" [b, s, e],
        "labels"}): updates the masters and the moments in place
        and returns (opt_state, {"loss": loss}). ``reduce(loss, grads)``,
        if given, returns the (loss, grads) the optimizer takes: across
        ranks, their mean over the data-parallel group ``group``, over
        which the batch is split (``value_and_grad``)."""
        self._compute = None                 # the serving cast is stale after the step
        loss, grads = self.value_and_grad(batch, group)
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        opt_state = apply_updates(self.masters(), grads, opt_state, self.opt)
        return opt_state, {"loss": loss}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss of ``batch`` at the current masters."""
        return loss_fn(self.compute_params(), self.cfg, batch)

    # -------------------------------------------------------------- #
    # serving steps
    # -------------------------------------------------------------- #
    # the stub frontends (audio, vision) take ``embeds`` [b, s, e] in place
    # of ``tokens`` [b, s], as JAX's batch dicts carry them
    @torch.no_grad()
    def prefill_step(self, tokens: Optional[torch.Tensor] = None, *,
                     embeds: Optional[torch.Tensor] = None):
        """Full-context forward returning (last-token logits [b, 1, v],
        the prefill cache of ``transformer.forward``)."""
        mode = "last" if self.cfg.prefill_last_logits else "all"
        logits, cache = forward(self.compute_params(), self.cfg, tokens,
                                want_cache=True, logits_positions=mode, embeds=embeds)
        return logits[:, -1:, :], cache

    @torch.no_grad()
    def serve_step(self, cache: Dict, tokens: Optional[torch.Tensor], pos: int, *,
                   embeds: Optional[torch.Tensor] = None):
        """One decode step: (logits [b, 1, v], cache updated in place)."""
        return decode_step(self.compute_params(), cache, self.cfg, tokens, pos,
                           embeds=embeds)

    @torch.no_grad()
    def forward_logits(self, tokens: Optional[torch.Tensor] = None, *,
                       embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [b, s, v] of a full forward, no cache."""
        return forward(self.compute_params(), self.cfg, tokens, embeds=embeds)[0]

    # -------------------------------------------------------------- #
    # cache
    # -------------------------------------------------------------- #
    def cache_specs(self, shape: ShapeConfig):
        return init_cache_specs(self.cfg, shape.global_batch, shape.seq_len)

    def init_cache(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Zeroed decode buffers, each in its own dtype (bf16 KV, fp32 states)."""
        return {k: torch.zeros(s, dtype=dt, device=self.device)
                for k, (s, dt) in self.cache_specs(shape).items()}


def make_model(cfg: ArchConfig, device: Union[str, torch.device] = "cuda",
               opt: Optional[OptConfig] = None) -> Model:
    return Model(cfg, device=device, opt=opt)
