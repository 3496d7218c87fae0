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

Under a mesh (``ctx``) the model holds JAX's Zero-3 layout: each leaf is
this rank's shard (``param_shardings``: "fsdp" over "data", "tp",
"vocab" and "expert" over "model", "fsdp2d" over both; the norms, the
router, the conv weights, ``A_log``, ``D`` and ``dt_bias`` whole), and
the optimizer state mirrors it (``opt_shardings``). A training step
hands the layers each split leaf as a ``Sharded``, which the layer body
gathers where it uses it (``models/transformer.py``; the experts keep
their split over "model", each rank running its own: ``moe.expert_shards``);
the gradients come back as shards, summed over the gathers' axes by
their reduce-scatters. The step's batch is this rank's block of the
global one: its rows over "data" and, where the "model" axis has more
than one rank, its positions over "model" (``input_shardings``).
Serving under a mesh (``prefill_step``, ``serve_step``: JAX's dry-run
compiles both on the production meshes) runs the layers on the rank's
block in the same way, without autograd: prefill's positions over
"model", decode's one token whole over "model" against the rank's block
of the sequence-split cache (``cache_shardings``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from ..optim.adamw import (LeafShards, OptConfig, OptState, apply_updates, init_opt_state,
                           opt_state_specs)
from ..parallel.sharding import (Sharded, Sharding, ShardingCtx, all_reduce, axis_group,
                                 batch_size, gather_seq, gather_splits, seq_shards, shard_shape,
                                 splits_of)
from ..tally_hooks import span
from .config import ArchConfig, ShapeConfig
from .layers import ParamSpec
from .moe import expert_shards
from .transformer import (cache_shardings, decode_step, forward, init_cache_specs, init_specs,
                          loss_fn)


def _params_module(specs: Dict, device: torch.device, shapes: Dict[str, Tuple[int, ...]],
                   prefix: str = "") -> nn.Module:
    if all(isinstance(s, ParamSpec) for s in specs.values()):
        return nn.ParameterDict({
            k: nn.Parameter(torch.empty(shapes[prefix + k], dtype=getattr(torch, s.dtype),
                                        device=device), requires_grad=False)
            for k, s in specs.items()})
    return nn.ModuleDict({k: _params_module(v, device, shapes, f"{prefix}{k}.")
                          for k, v in specs.items()})


def _map(tree: Any, fn: Callable) -> Any:
    """``fn`` on each ParamSpec of an OptState or a dict of ParamSpecs."""
    if isinstance(tree, OptState):
        return OptState(step=fn(tree.step), mu=_map(tree.mu, fn), nu=_map(tree.nu, fn))
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


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
    """``ctx``: the sharding rules and the mesh (None, or a ``ShardingCtx``
    without a mesh: one device holding every leaf whole). ``device="meta"``
    allocates nothing, for the layout alone."""

    def __init__(self, cfg: ArchConfig, ctx: Optional[ShardingCtx] = None,
                 device: Union[str, torch.device] = "cuda", opt: Optional[OptConfig] = None):
        super().__init__()
        self.cfg = cfg
        self.ctx = ctx if ctx is not None else ShardingCtx()
        self.opt = opt if opt is not None else OptConfig(kind=cfg.optimizer)
        self.device = torch.device("meta") if str(device) == "meta" else resolve_device(device)
        specs = init_specs(cfg)
        self.parts = tuple(specs)                    # embed, blocks (, shared)
        shapes = {n: shard_shape(s.shape, sh.spec, self.ctx.mesh, n)
                  for (n, s), sh in zip(self.param_specs().items(),
                                        self.param_shardings().values())}
        for name in self.parts:
            setattr(self, name, _params_module(specs[name], self.device, shapes, f"{name}."))
        self._compute: Optional[Dict] = None
        self.prefills = 0                            # prefill batches run: their spans' step

    # -------------------------------------------------------------- #
    # params and their layout
    # -------------------------------------------------------------- #
    def param_specs(self) -> Dict[str, ParamSpec]:
        """Flat {state_dict key: ParamSpec}, in JAX's flatten order."""
        return _flat_specs(init_specs(self.cfg))

    def param_shardings(self) -> Dict[str, Sharding]:
        """{name: the leaf's layout on the mesh} (JAX's ``param_shardings``)."""
        return {n: self.ctx.sharding(*s.axes) for n, s in self.param_specs().items()}

    def param_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """{name: (whole shape, dtype)}."""
        return {n: (s.shape, getattr(torch, s.dtype)) for n, s in self.param_specs().items()}

    def opt_specs(self) -> OptState:
        return opt_state_specs(self.param_specs(), self.opt)

    def opt_shardings(self) -> OptState:
        """The optimizer state's layout, mirroring the masters' (JAX's
        ``opt_shardings``)."""
        return _map(self.opt_specs(), lambda s: self.ctx.sharding(*s.axes))

    def opt_shapes(self) -> OptState:
        return _map(self.opt_specs(), lambda s: (s.shape, getattr(torch, s.dtype)))

    def input_shardings(self, shape: ShapeConfig) -> Dict[str, Sharding]:
        """The batch's layout: rows over the batch axes, positions over
        "model" except in decode (JAX's ``input_shardings``)."""
        sh = self.ctx.sharding
        seq_ax = "seq" if shape.mode != "decode" else None
        out: Dict[str, Sharding] = {}
        if self.cfg.frontend != "token":
            out["embeds"] = sh("batch", seq_ax, "embed")
        else:
            out["tokens"] = sh("batch", seq_ax)
        if shape.mode == "train":
            out["labels"] = sh("batch", seq_ax)
        return out

    def cache_shardings(self) -> Optional[Dict[str, Sharding]]:
        """The decode cache's layout, None without a mesh."""
        return cache_shardings(self.cfg, self.ctx)

    def shards(self) -> LeafShards:
        """The masters' layout over the mesh: each leaf's spec and the mesh."""
        return LeafShards({n: sh.spec for n, sh in self.param_shardings().items()},
                          self.ctx.mesh)

    def gather(self, t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
        """The whole leaf from this rank's shard ``t`` (a collective over the
        axes of each split dimension), built in place with a buffer of one
        shard's size (``gather_full``'s ``pieces``)."""
        return gather_splits(t, splits_of(sharding.spec, sharding.mesh), pieces=True)

    def full_params(self, keep: bool = True) -> Optional[Dict[str, torch.Tensor]]:
        """A copy of the whole masters on the host, gathered one leaf at a
        time. Every rank of the mesh calls it; a rank with ``keep`` False
        takes part in the gathers, keeps no copy and gets None."""
        masters, psh = self.masters(), self.param_shardings()
        out = {}
        for n in masters:
            full = self.gather(masters[n], psh[n])
            if keep:
                out[n] = full.to("cpu", copy=True)
            del full
        return out if keep else None

    def full_opt_state(self, state: OptState, keep: bool = True) -> Optional[OptState]:
        """``state`` whole on the host, one leaf at a time, as ``full_params``."""
        def walk(tree, sh):
            if isinstance(tree, dict):
                return {k: walk(tree[k], sh[k]) for k in tree}
            full = self.gather(tree, sh)
            return full.to("cpu", copy=True) if keep else None
        osh = self.opt_shardings()
        mu, nu = walk(state.mu, osh.mu), walk(state.nu, osh.nu)
        return OptState(step=state.step, mu=mu, nu=nu) if keep else None

    @torch.no_grad()
    def adopt(self, shards: Mapping[str, torch.Tensor]) -> None:
        """Take ``shards``, this rank's shard of every master, as the
        masters' storage, with no copy, and their device as the model's. A
        model built on "meta" for its layout gets its tensors so, made one
        leaf at a time (``ElasticRuntime._reshard``)."""
        params = dict(self.named_parameters())
        if set(shards) != set(params):
            raise KeyError(f"the shards {sorted(set(shards) ^ set(params))} "
                           "are not the model's leaves")
        for name, t in shards.items():
            if t.shape != params[name].shape:
                raise ValueError(f"{name}: shard {tuple(t.shape)}, not "
                                 f"{tuple(params[name].shape)}")
            parent, leaf = name.rsplit(".", 1)
            self.get_submodule(parent)[leaf] = nn.Parameter(t, requires_grad=False)
        self.device = next(iter(shards.values())).device
        self._compute = None

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` with JAX's init rule. A
        split leaf is drawn whole, one leaf at a time, and this rank keeps
        its shard: the values do not depend on the mesh."""
        state, psh = self.state_dict(), self.param_shardings()
        for name, spec in self.param_specs().items():
            if tuple(state[name].shape) == spec.shape:
                spec.materialize_(state[name], generator)
                continue
            full = torch.empty(spec.shape, dtype=state[name].dtype, device=state[name].device)
            spec.materialize_(full, generator)
            state[name].copy_(psh[name].shard(full, name))
            del full
        self._compute = None

    @torch.no_grad()
    def init_shards(self, generator: torch.Generator) -> None:
        """Draw this rank's shard of every parameter from ``generator`` (on
        the model's device) with the init rule's distribution, and never
        build a whole leaf: a model whose whole masters do not fit one
        device (qwen2-vl-72b, llama4-maverick) is laid out this way for the
        dry-run. The values are random and depend on the mesh; nothing the
        dry-run counts depends on them."""
        state = self.state_dict()
        for name, spec in self.param_specs().items():
            spec.materialize_(state[name], generator)
        self._compute = None

    @torch.no_grad()
    def load_params(self, state: Mapping[str, torch.Tensor]) -> None:
        """Copy whole leaves (e.g. from ``convert.params_from_jax``), each
        rank its shard."""
        masters, specs, psh = self.masters(), self.param_specs(), self.param_shardings()
        if set(state) != set(masters):
            raise KeyError(f"the state's leaves {sorted(set(state) ^ set(masters))} "
                           "are not the model's")
        for name, t in state.items():
            if tuple(t.shape) != specs[name].shape:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, not {specs[name].shape}")
            masters[name].copy_(psh[name].shard(t, name))
        self._compute = None

    def compute_params(self) -> Dict:
        """The parameter tree the layers use: the matrices JAX casts in the
        compute dtype (cast once), the rest, and the embeddings, as stored.
        Under a mesh, the step tree of this rank's shards (``_step_tree``),
        which each layer gathers where it uses it."""
        if self.ctx.mesh is not None:
            return self._step_tree(dict(self.masters()))
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
        """Zeroed moments in the masters' layout (this rank's shards)."""
        return init_opt_state(self.masters(), self.opt)

    def _step_tree(self, leaves: Dict[str, torch.Tensor]) -> Dict:
        """The parameter tree a step's layers take, from its leaves: under a
        mesh each split leaf as a ``Sharded`` (gathered by the layer that
        uses it), then the compute-dtype casts of ``_cast``. The experts
        keep their split over "model" where the MoE layer runs on it
        (``moe.expert_shards``)."""
        cdt = getattr(torch, self.cfg.dtype)
        mesh = self.ctx.mesh
        if mesh is not None:
            keep_model = expert_shards(self.cfg, mesh) > 1
            specs = self.param_specs()
            for name, sh in self.param_shardings().items():
                splits = splits_of(sh.spec, mesh)
                if keep_model and "expert" in specs[name].axes:
                    splits = tuple(s for s in splits if s.axes != ("model",))
                if splits:
                    leaves[name] = Sharded(leaves[name], splits, leaves[name].dtype)
        tree = _unflatten(leaves)
        return {name: _cast(tree[name], cdt) for name in self.parts}

    def _value_and_grad(self, batch: Dict[str, torch.Tensor]):
        """(loss, {name: grad}) of ``loss_fn`` at the current masters. The
        leaves are the masters themselves (detached aliases), or with
        ``cfg.bf16_grads`` copies of the fp32 ones in the compute dtype,
        whose gradients come back in that dtype (JAX's
        ``_value_and_grad``). The compute-dtype casts of the weight
        matrices are made inside the graph, from those leaves. Under a mesh
        the loss and the gradients are this rank's parts (``loss_fn``),
        which the caller sums over the mesh. The spans ``train.forward``
        (the leaves, the casts, the loss) and ``train.backward``."""
        cdt = getattr(torch, self.cfg.dtype)
        leaves = {}
        with span("train.forward"):
            for name, p in self.masters().items():
                leaf = p.detach()
                if self.cfg.bf16_grads and leaf.dtype == torch.float32:
                    leaf = leaf.to(cdt)
                leaves[name] = leaf.requires_grad_()
            params = self._step_tree(dict(leaves))
            loss = loss_fn(params, self.cfg, batch, self.ctx)
        # a stub frontend's model never reads its embedding table: its
        # gradient is zeros, as JAX's
        with span("train.backward"):
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {name: torch.zeros_like(leaf) if g is None else g
                               for (name, leaf), g in zip(leaves.items(), grads)}

    def value_and_grad(self, batch: Dict[str, torch.Tensor]):
        """(loss, {name: grad}) of a step's batch. With ``cfg.grad_accum``
        k > 1 the batch is split into k microbatches whose gradients are
        summed in fp32 and divided by k, and the loss is their mean (JAX's
        ``train_step``). Under a mesh the batch is this rank's block of a
        global one, microbatch i its rows of the global microbatch i."""
        k = self.cfg.grad_accum
        if k <= 1:
            return self._value_and_grad(batch)
        micro = {n: t.reshape((k, t.shape[0] // k) + t.shape[1:]) for n, t in batch.items()}
        grads, losses = {}, []
        for i in range(k):
            loss, g = self._value_and_grad({n: t[i] for n, t in micro.items()})
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
                   reduce: Optional[Callable] = None):
        """One optimizer step on ``batch`` ({"tokens", "labels"} [b, s] on
        the model's device; a stub frontend's {"embeds" [b, s, e],
        "labels"}): updates the masters and the moments in place
        and returns (opt_state, {"loss": loss}). ``reduce(loss, grads)``,
        if given, returns the (loss, grads) the optimizer takes: across
        ranks, this rank's parts summed over the mesh into the global
        batch's mean (``ElasticRuntime._mean_over_data``). The update is
        the span ``train.optimizer``."""
        self._compute = None                 # the serving cast is stale after the step
        loss, grads = self.value_and_grad(batch)
        if reduce is not None:
            loss, grads = reduce(loss, grads)
        with span("train.optimizer"):
            opt_state = apply_updates(self.masters(), grads, opt_state, self.opt, self.shards())
        return opt_state, {"loss": loss}

    @torch.no_grad()
    def mean_over_batch(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
        """This rank's loss and gradients, its parts of the global batch's,
        summed over the mesh and divided by the number of batch blocks
        (pod x data): after it, each rank's gradient shard is its block of
        JAX's global-batch-mean gradient, and the loss is the global mean,
        before clipping reads the global norm. The batch axes split the
        rows and the model ranks one sequence (``loss_fn``'s part is over
        the rank's rows' tokens), so only the batch axes divide. A leaf's
        gradient shard already holds its sum over the axes the leaf is
        split over (its gathers' reduce-scatters; a shard that a layer uses
        unsplit, as the MoE layer uses its experts, holds every use of it); it
        is all-reduced over the mesh's other axes, a whole leaf's over the
        whole mesh (a ``train_step``'s ``reduce``)."""
        mesh = self.ctx.mesh
        shards, n = self.shards(), batch_size(self.ctx)
        for name, g in grads.items():
            rest = tuple(a for a in mesh.mesh_dim_names if a not in shards.axes(name))
            group, _ = axis_group(mesh, rest)
            if group is not None:
                all_reduce(g, group)
            g.div_(n)
        loss = loss.clone()
        group, _ = axis_group(mesh, mesh.mesh_dim_names)
        if group is not None:
            all_reduce(loss, group)
        return loss / n, grads

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The loss of ``batch`` at the current masters."""
        return loss_fn(self.compute_params(), self.cfg, batch, self.ctx)

    # -------------------------------------------------------------- #
    # serving steps
    # -------------------------------------------------------------- #
    # the stub frontends (audio, vision) take ``embeds`` [b, s, e] in place
    # of ``tokens`` [b, s], as JAX's batch dicts carry them
    @torch.no_grad()
    def prefill_step(self, tokens: Optional[torch.Tensor] = None, *,
                     embeds: Optional[torch.Tensor] = None):
        """Full-context forward returning (last-token logits [b, 1, v],
        the prefill cache of ``transformer.forward``). Under a mesh the
        batch is this rank's block ({tokens [b/(pod data), s/model]}:
        ``input_shardings``), every layer runs on it as in training, without
        autograd, gathering each split leaf where it uses it; the logits are
        those of the sequence's last position (on the last model rank),
        and the cache is this rank's blocks in ``cache_shardings``' layout.
        The batch is the span ``serve.prefill``, its ``step`` the count of
        prefill batches this model has run (``prefills``)."""
        self.prefills += 1
        with span("serve.prefill", step=self.prefills):
            mode = "last" if self.cfg.prefill_last_logits else "all"
            logits, cache = forward(self.compute_params(), self.cfg, tokens, want_cache=True,
                                    logits_positions=mode, embeds=embeds, ctx=self.ctx)
            sp = seq_shards(self.ctx)
            if sp is not None and mode == "all":
                # the rank's block's logits: the sequence's last is the last rank's
                logits = gather_seq(logits[:, -1:, :].contiguous(), 1, sp)
            return logits[:, -1:, :], cache

    @torch.no_grad()
    def serve_step(self, cache: Dict, tokens: Optional[torch.Tensor], pos: int, *,
                   embeds: Optional[torch.Tensor] = None):
        """One decode step: (logits [b, 1, v], cache updated in place).
        Under a mesh tokens [b/(pod data), 1] are the rank's rows, whole
        over "model", and ``cache`` its blocks (``init_cache``)."""
        return decode_step(self.compute_params(), cache, self.cfg, tokens, pos,
                           embeds=embeds, ctx=self.ctx)

    @torch.no_grad()
    def forward_logits(self, tokens: Optional[torch.Tensor] = None, *,
                       embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [b, s, v] of a full forward, no cache."""
        return forward(self.compute_params(), self.cfg, tokens, embeds=embeds,
                       ctx=self.ctx)[0]

    # -------------------------------------------------------------- #
    # cache
    # -------------------------------------------------------------- #
    def cache_specs(self, shape: ShapeConfig):
        return init_cache_specs(self.cfg, shape.global_batch, shape.seq_len)

    def cache_shapes(self, shape: ShapeConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(this rank's shape, dtype) of each decode buffer: the whole
        buffer without a mesh, its block in ``cache_shardings``' layout."""
        specs, csh = self.cache_specs(shape), self.cache_shardings()
        return {k: (shard_shape(s, csh[k].spec, self.ctx.mesh, k) if csh else s, dt)
                for k, (s, dt) in specs.items()}

    def init_cache(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Zeroed decode buffers, each in its own dtype (bf16 KV, fp32
        states), this rank's blocks under a mesh."""
        return {k: torch.zeros(s, dtype=dt, device=self.device)
                for k, (s, dt) in self.cache_shapes(shape).items()}


def make_model(cfg: ArchConfig, ctx: Optional[ShardingCtx] = None,
               device: Union[str, torch.device] = "cuda",
               opt: Optional[OptConfig] = None) -> Model:
    return Model(cfg, ctx, device=device, opt=opt)
