"""The numbers that decide ``correct``, each held to a limit of its own.

Training (the program's first steps against the reference's, from the
same weights on the same batches):

- ``loss_gap``: the largest relative gap of a step's loss, over the first
  ``LOSS_STEPS`` steps (the weights as drawn, and after one update). A
  later step's loss follows AdamW's first, sign-like updates, which
  amplify round-off from seed to seed; the weights after every checked
  step are held by ``change_gap``;
- ``grad_gap``: the first step's gradient as the optimizer takes it (after
  the clip), by leaf: the gap between the program's norm and the
  reference's, over the larger of the reference's norm of that leaf and
  of the median leaf; the worst leaf;
- ``change_gap``: each leaf's change over the steps, the same way, leaving
  out the leaves whose gradient in the reference is under a thousandth of
  the median leaf's (their change is round-off alone under AdamW).

Prefill (sampled requests of the window; the last batch's cache):

- ``token_gap``: the widest gap by which a served token's logit lies below
  the reference's best, in logits;
- ``logit_err``: the largest ||logits - reference|| / ||reference|| of a
  served position;
- ``cache_err``: the largest such relative error of a layer's cache handed
  to the decode buffers (K and V, or the conv window and the SSM state).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

import numpy as np
import torch

QUIET = 1e-3        # a leaf whose gradient is under this share of the median leaf's
LOSS_STEPS = 2      # the steps whose loss ``loss_gap`` compares


def _by_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in names)


def quiet_leaves(ref: dict) -> list:
    raw = ref["raw_grad_norms"]
    med = statistics.median(raw.values())
    return sorted(k for k, v in raw.items() if v < QUIET * med)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    quiet = set(quiet_leaves(ref))
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in
                        zip(prog["losses"][:LOSS_STEPS], ref["losses"][:LOSS_STEPS])),
        "grad_gap": _by_leaf(prog["grad_norms"], ref["grad_norms"]),
        "change_gap": _by_leaf(prog["change_norms"], ref["change_norms"],
                               keep=set(ref["change_norms"]) - quiet),
    }


def _rel(a, b) -> float:
    """||a - b|| / ||b|| in float64, of numpy arrays or tensors (on their
    device)."""
    if isinstance(b, torch.Tensor):
        a, b = a.to(b.device, torch.float64), b.to(torch.float64)
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def prefill_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    rows = ref["rows"]
    gap = max(float(rows[r].max() - rows[r][prog["served"][r]]) for r in rows)
    logit = max(_rel(prog["rows"][r], rows[r]) for r in rows)
    cache = max(_rel(prog["cache"][k][i], ref["cache"][k][i])
                for k in ref["cache"] for i in range(len(ref["cache"][k])))
    return {"token_gap": gap, "logit_err": logit, "cache_err": cache}


def verdict(numbers: Dict[str, float], limits: dict) -> Tuple[bool, Dict[str, dict]]:
    """(every number finite and within its limit, {name: {value, limit}});
    a number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        fine = limit is not None and math.isfinite(value) and value <= limit
        ok = ok and fine
        checks[name] = {"value": value, "limit": limit}
    return ok, checks
