"""The plain model around a family's layer: the embedding, the stack of
layers, the final norm and the float32 LM head (the tied embedding where
the configuration ties it); the loss and every gradient of a step, one
layer at a time; AdamW's steps; the prefill of a batch of prompts.

``params`` is {layout name: float32 tensor}; stacked leaves ``blocks.*``
hold one row a layer. Nothing here imports the program."""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from . import family
from .common import adamw_step, cross_entropy, norm, rmsnorm

PREFIX = "blocks."


def _layers(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len(PREFIX):]: v for k, v in params.items() if k.startswith(PREFIX)}


def _head(params: Dict[str, torch.Tensor], c: dict) -> torch.Tensor:
    return params["embed.embedding"].T if c.get("tie_embeddings") else params["embed.lm_head"]


def logits(x: torch.Tensor, params: Dict[str, torch.Tensor], c: dict) -> torch.Tensor:
    return rmsnorm(x, params["embed.final_norm"], c["norm_eps"]) @ _head(params, c)


@torch.no_grad()
def prefill(params: Dict[str, torch.Tensor], c: dict, tokens: torch.Tensor, fp8: bool = False,
            want_cache: bool = False) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The last position's logits [b, V] of prompts [b, s], and with
    ``want_cache`` the cache a decode step reads, stacked over layers:
    K (rotated) and V [L, b, s, kvh, d], or the conv window [L, b, K-1,
    conv] and the SSM state [L, b, H, P, N]."""
    fam, blocks = family(c), _layers(params)
    x = params["embed.embedding"][tokens]
    cache: Dict[str, List[torch.Tensor]] = {}
    for i in range(c["n_layers"]):
        x, part = fam.layer(x, {k: v[i] for k, v in blocks.items()}, c, fp8, want_cache)
        for k, t in (part or {}).items():
            cache.setdefault(k, []).append(t)
    out = logits(x[:, -1], params, c)
    return out, ({k: torch.stack(v) for k, v in cache.items()} if want_cache else None)


def loss_and_grads(params: Dict[str, torch.Tensor], c: dict, tokens: torch.Tensor,
                   labels: torch.Tensor, fp8: bool = False
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The mean cross-entropy of a batch and the gradient of every leaf.
    The forward keeps only each layer's input; the backward runs each
    layer again under autograd, last to first."""
    fam, blocks = family(c), _layers(params)
    L = c["n_layers"]
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    with torch.no_grad():
        x = params["embed.embedding"][tokens]
        xs = [x]
        for i in range(L):
            x, _ = fam.layer(x, {k: v[i] for k, v in blocks.items()}, c, fp8)
            xs.append(x)
    top = {k: params[k].detach().requires_grad_() for k in params if not k.startswith(PREFIX)}
    last = xs.pop().requires_grad_()
    loss = cross_entropy(logits(last, top, c), labels)
    loss.backward()
    for k, t in top.items():
        if t.grad is not None:
            grads[k] += t.grad
    g = last.grad
    del top, last
    for i in reversed(range(L)):
        x = xs.pop().requires_grad_()
        p = {k: v[i].detach().requires_grad_() for k, v in blocks.items()}
        y, _ = fam.layer(x, p, c, fp8)
        y.backward(g)
        for k, t in p.items():
            grads[PREFIX + k][i] = t.grad
        g = x.grad
        del x, p, y
    grads["embed.embedding"].index_add_(0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
    return float(loss.detach()), grads


def train_readings(params: Dict[str, torch.Tensor], c: dict, batches, opt: dict,
                   initial, fp8: bool = False) -> dict:
    """Steps of AdamW from ``params`` (updated in place) on ``batches``
    [(tokens, labels)]: each step's loss; after the first, each leaf's
    gradient norm before (``raw_grad_norms``) and after the clip (the
    gradient the optimizer takes, ``grad_norms``); after the last, each
    leaf's change from ``initial(name)``, its starting value."""
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    out: dict = {"losses": []}
    for step, (tokens, labels) in enumerate(batches, 1):
        loss, grads = loss_and_grads(params, c, tokens, labels, fp8)
        out["losses"].append(loss)
        raw = {k: norm(g) for k, g in grads.items()} if step == 1 else None
        scale = adamw_step(params, grads, mu, nu, step, opt)
        if raw is not None:
            out["raw_grad_norms"] = raw
            out["grad_norms"] = {k: v * scale for k, v in raw.items()}
        del grads
    del mu, nu
    change = {}
    for k, p in params.items():
        p0 = initial(k)
        change[k] = norm(p - p0)
        del p0
    out["change_norms"] = change
    return out
