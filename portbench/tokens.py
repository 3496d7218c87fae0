"""Token ids from the seed: the one generator every traffic mix reads.

``{"kind": "zipf", "exponent": s}`` draws ids with the frequency of rank r
proportional to 1 / r^s (natural text is close to s = 1), the ranks
mapped to ids by a permutation drawn from the seed. Everything is numpy
on the host, so that the reference draws the same ids again on any
device; a stream is a pure function of (seed, stream, index).
"""
from __future__ import annotations

import numpy as np


class TokenSource:
    def __init__(self, params: dict, vocab: int, seed: int):
        if params.get("kind") != "zipf":
            raise ValueError(f"unknown token distribution {params!r}")
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = ranks ** -float(params["exponent"])
        self.cdf = np.cumsum(p / p.sum())
        self.cdf[-1] = 1.0
        self.ids = np.random.default_rng([int(seed), 0]).permutation(vocab)
        self.seed = int(seed)

    def draw(self, stream: int, index: int, shape) -> np.ndarray:
        """int64 ids of ``shape`` for item ``index`` of ``stream``."""
        rng = np.random.default_rng([self.seed, 1 + int(stream), int(index)])
        return self.ids[np.searchsorted(self.cdf, rng.random(shape), side="right")]
