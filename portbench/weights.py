"""The weights of a cell, made from the seed: the benchmark's own layout
of every parameter (name, shape, distribution) and its draws.

Both sides get the same numbers: the program's masters are filled in
place, and the reference draws them again after the window. Each leaf has
a generator of its own, seeded from (seed, name), so that one leaf can be
drawn again alone; a stacked ``[L, ...]`` leaf is one call on the device.
The names are the port's ``state_dict`` names, so that the program's
masters can be matched to the layout leaf by leaf; shapes are checked.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from .reference import family


@dataclass(frozen=True)
class Leaf:
    shape: Tuple[int, ...]
    init: str                 # normal | zeros | ones | uniform | a_log | dt_bias
    scale: float = 0.0        # std for "normal", half-width for "uniform"


def layout(c: dict, config: dict) -> Dict[str, Leaf]:
    """{name: Leaf} of a configuration: the embedding, the final norm and
    an untied head here, the stacked layers' leaves from its family's
    module (``reference/<family>.py``); ``c`` as ``reference.sizes``."""
    e, V = c["d_model"], c["vocab"]
    std = config["init_std"]
    res_std = std / math.sqrt(2 * config["residual_std_layers"])
    out = {"embed.embedding": Leaf((V, e), "normal", std),
           "embed.final_norm": Leaf((e,), "zeros")}
    if not c.get("tie_embeddings", False):
        out["embed.lm_head"] = Leaf((e, V), "normal", std)
    out.update(family(c).leaves(c, std, res_std))
    return dict(sorted(out.items()))


def leaf_seed(seed: int, name: str) -> int:
    """A 63-bit seed for one leaf from the run's seed (any size) and its name."""
    state = np.random.SeedSequence([int(seed), zlib.crc32(name.encode())]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


@torch.no_grad()
def fill_(out: torch.Tensor, leaf: Leaf, seed: int, name: str) -> torch.Tensor:
    """Draw ``leaf`` into ``out`` (contiguous float32, on any device)."""
    if tuple(out.shape) != leaf.shape or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"{name}: got {tuple(out.shape)} {out.dtype}, the layout has "
                         f"{leaf.shape} float32 (contiguous)")
    g = torch.Generator(device=out.device).manual_seed(leaf_seed(seed, name))
    if leaf.init == "zeros":
        out.zero_()
    elif leaf.init == "ones":
        out.fill_(1.0)
    elif leaf.init == "normal":
        out.normal_(0.0, leaf.scale, generator=g)
    elif leaf.init == "uniform":
        out.uniform_(-leaf.scale, leaf.scale, generator=g)
    elif leaf.init == "a_log":
        # Mamba2's A_init_range: A ~ U[1, 16], stored as log A
        out.uniform_(1.0, 16.0, generator=g).log_()
    elif leaf.init == "dt_bias":
        # dt log-uniform in [dt_min, dt_max], floored; the bias is softplus^-1(dt)
        out.uniform_(math.log(1e-3), math.log(1e-1), generator=g).exp_().clamp_(min=1e-4)
        out.add_(torch.log(-torch.expm1(-out)))
    else:
        raise ValueError(f"{name}: unknown init {leaf.init!r}")
    return out


def draw(leaf: Leaf, seed: int, name: str, device) -> torch.Tensor:
    return fill_(torch.empty(leaf.shape, dtype=torch.float32, device=device), leaf, seed, name)


def fill_program(masters: Dict[str, torch.Tensor], lay: Dict[str, Leaf], seed: int) -> None:
    """Draw every leaf into the program's masters, in place."""
    if set(masters) != set(lay):
        raise KeyError(f"the program's leaves differ from the layout: "
                       f"{sorted(set(masters) ^ set(lay))}")
    for name, leaf in lay.items():
        fill_(masters[name], leaf, seed, name)


def n_params(lay: Dict[str, Leaf]) -> int:
    return sum(math.prod(leaf.shape) for leaf in lay.values())
