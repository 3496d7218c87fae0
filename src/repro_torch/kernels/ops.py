"""Dispatch between the CUDA kernels and their plain versions.

The tensor's device decides: CPU tensors go to the plain PyTorch
version in ``ref.py``, CUDA tensors to the kernel. There is no fallback:
a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from .feasibility import feasible_mask
from .flash_attention import flash_attention, flash_decode
from .ref import ref_attention, ref_decode, ref_feasible


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [b, h, sq, d]; k, v: [b, kvh, skv, d]."""
    if _on_cuda(q):
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref_attention(q, k, v, causal=causal, window=window)


def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: [b, h, 1, d]; k, v: [b, kvh, S, d] (any strides); lengths [b]."""
    if _on_cuda(q):
        return flash_decode(q, k, v, lengths)
    return ref_decode(q, k, v, lengths)


def batched_feasible_op(vtype: torch.Tensor, vok: torch.Tensor, vsize: torch.Tensor,
                        vmask: torch.Tensor, agg: torch.Tensor, tid: torch.Tensor,
                        msize: torch.Tensor, rmask: torch.Tensor,
                        need: torch.Tensor) -> torch.Tensor:
    """[U, V] uint8 root-feasibility mask; the ``feasible_mask`` contract."""
    args = (vtype, vok, vsize, vmask, agg, tid, msize, rmask, need)
    if _on_cuda(vtype):
        return feasible_mask(*args)
    return ref_feasible(*args)
