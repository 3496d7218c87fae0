"""Model facade: config -> parameters, prefill step, serve step, cache.

The port of ``repro/models/model.py`` for serving (no optimizer in this
slice). ``Model`` is an ``nn.Module`` holding the stacked ``[L, ...]``
parameters of ``transformer.init_specs``; its ``state_dict`` keys are the
JAX tree's paths joined by dots (``blocks.attn.wq``), so
``convert.params_from_jax`` loads JAX weights one to one.

Parameters are fp32 masters, cast to the compute dtype at each use in
JAX. For serving, the model keeps a copy of the matrices that JAX casts
(the attention and MLP ``w*``, Mamba's ``in_proj``, ``conv_w``, ``conv_b``
and ``out_proj``) already in the compute dtype, made once when the
weights are set: the same rounding of the same fp32 numbers, so the
values are bit-identical to a cast at each use, without re-reading 11 GB
of fp32 masters every step at full width. Norm weights, Mamba's
``A_log``, ``D`` and ``dt_bias``, and the embedding/LM head stay fp32.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch
from torch import nn

from ..device import resolve_device
from .config import ArchConfig, ShapeConfig
from .layers import ParamSpec
from .transformer import decode_step, forward, init_cache_specs, init_specs


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


# the Mamba2 parameters that JAX casts to the compute dtype at each use
# (repro/models/mamba2.py); the attention and MLP ones all start with "w"
_MAMBA_CAST = ("in_proj", "conv_w", "conv_b", "out_proj")


def _cast(tree: Dict, dtype: torch.dtype) -> Dict:
    return {k: _cast(v, dtype) if isinstance(v, dict)
            else v.to(dtype) if k.startswith("w") or k in _MAMBA_CAST else v
            for k, v in tree.items()}


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
    def __init__(self, cfg: ArchConfig, device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.cfg = cfg
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

    # -------------------------------------------------------------- #
    # steps
    # -------------------------------------------------------------- #
    @torch.no_grad()
    def prefill_step(self, tokens: torch.Tensor):
        """Full-context forward returning (last-token logits [b, 1, v],
        the prefill cache of ``transformer.forward``)."""
        mode = "last" if self.cfg.prefill_last_logits else "all"
        logits, cache = forward(self.compute_params(), self.cfg, tokens,
                                want_cache=True, logits_positions=mode)
        return logits[:, -1:, :], cache

    @torch.no_grad()
    def serve_step(self, cache: Dict, tokens: torch.Tensor, pos: int):
        """One decode step: (logits [b, 1, v], cache updated in place)."""
        return decode_step(self.compute_params(), cache, self.cfg, tokens, pos)

    @torch.no_grad()
    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits [b, s, v] of a full forward, no cache."""
        return forward(self.compute_params(), self.cfg, tokens)[0]

    # -------------------------------------------------------------- #
    # cache
    # -------------------------------------------------------------- #
    def cache_specs(self, shape: ShapeConfig):
        return init_cache_specs(self.cfg, shape.global_batch, shape.seq_len)

    def init_cache(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """Zeroed decode buffers, each in its own dtype (bf16 KV, fp32 states)."""
        return {k: torch.zeros(s, dtype=dt, device=self.device)
                for k, (s, dt) in self.cache_specs(shape).items()}


def make_model(cfg: ArchConfig, device: Union[str, torch.device] = "cuda") -> Model:
    return Model(cfg, device=device)
