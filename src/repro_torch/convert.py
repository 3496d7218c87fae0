"""Bridge from the JAX package's parameter tree to the port's state dict.

``params_from_jax`` takes the JAX param pytree as nested dicts of numpy
arrays (the caller runs ``jax.device_get`` on its side: this module
imports no JAX) and returns the port's ``state_dict`` one to one: the
same names joined by dots, the same stacked ``[L, ...]`` shapes, the
same dtypes.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(params_from_jax(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = _to_tensor(v)
    return out
