"""Dispatch between the CUDA kernels and their plain versions.

The tensor's device decides: CPU tensors go to the plain PyTorch
version in ``ref.py``, CUDA tensors to the kernel. There is no fallback:
a kernel that fails to build or launch raises.

No gradient stops silently at a kernel. Attention carries gradients
through ``FlashAttention`` and the SSD scan through ``SsdChunk`` (each a
forward kernel and a backward kernel on the card, the plain pair on the
CPU, so a step does the same products on both: ``launch/tally.py``). The
decode kernel has no backward: decode only serves, so on CUDA tensors
that want a gradient it raises. On the CPU the plain decode is
differentiated by autograd.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .feasibility import feasible_mask
from .flash_attention import FlashAttention, flash_attention, flash_decode
from .ref import ref_attention, ref_decode, ref_feasible, seg_hi_lo
from .ssd_scan import SsdChunk


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for device {t.device}")


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_backward(kernel: str, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"{kernel} has no backward kernel ({why}); run it under torch.no_grad()")


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [b, h, sq, d]; k, v: [b, kvh, skv, d]. A gradient goes through
    ``FlashAttention`` (the forward saves each row's logsumexp; the
    backward is the kernel on the card, ``ref_attention_bwd`` on the CPU),
    so both devices run the same pair of functions; without one the
    forward kernel, or its plain version, runs alone."""
    on_card = _on_cuda(q)
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window)
    if on_card:
        return flash_attention(q, k, v, causal=causal, window=window)
    return ref_attention(q, k, v, causal=causal, window=window)


def decode_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: torch.Tensor, starts: Optional[torch.Tensor] = None,
                        lse: bool = False):
    """q: [b, h, 1, d]; k, v: [b, kvh, S, d] (any strides); row i attends
    positions ``starts[i] <= t < lengths[i]`` (int32 [b]; ``starts``
    defaults to zeros); with ``lse`` also the (row, head) logsumexps, fp32
    [b, h, 1] (the ``flash_decode`` contract)."""
    if _on_cuda(q):
        if _wants_grad(q, k, v):
            raise _no_backward("flash_decode",
                               "decode serves; training runs the full-sequence path")
        return flash_decode(q, k, v, lengths, starts, lse)
    return ref_decode(q, k, v, lengths, starts, lse)


def batched_feasible_op(vtype: torch.Tensor, vok: torch.Tensor, vsize: torch.Tensor,
                        vmask: torch.Tensor, agg: torch.Tensor, tid: torch.Tensor,
                        msize: torch.Tensor, rmask: torch.Tensor,
                        need: torch.Tensor) -> torch.Tensor:
    """[U, V] uint8 root-feasibility mask; the ``feasible_mask`` contract."""
    args = (vtype, vok, vsize, vmask, agg, tid, msize, rmask, need)
    if _on_cuda(vtype):
        return feasible_mask(*args)
    return ref_feasible(*args)


def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, initial_state: Optional[torch.Tensor] = None,
                return_state: bool = False):
    """Full SSD scan: the intra-chunk part through ``SsdChunk`` (the
    ``ssd_chunk`` kernels on CUDA tensors, ``ref_ssd_chunk`` and
    ``ref_ssd_chunk_bwd`` on CPU tensors; without a gradient only its
    forward runs), then the inter-chunk recurrence of
    ``repro/kernels/ops.py::ssd_scan_op`` in plain PyTorch, which autograd
    differentiates.

    x: [b, s, H, P]; dt: [b, s, H] (positive); A: [H] (negative); B, C:
    [b, s, G, N]; ``initial_state`` [b, H, P, N]. A ragged ``s`` is padded
    to a chunk multiple with dt = 0 steps (decay 1, zero input: a no-op for
    the outputs and the carried state), as ``ssd_chunked`` does. Returns y
    [b, s, H, P] in x's dtype (and the final state [b, H, P, N], fp32)."""
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    pad = -s % chunk
    if pad:
        x, dt, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, B, C))
    sp, nc, rep = s + pad, (s + pad) // chunk, H // G
    _on_cuda(x)                                       # rejects other devices
    y_intra, states, decay_log = SsdChunk.apply(x, dt, A, B, C, chunk)

    # the state entering each chunk: a sequential carry of (exp(decay), state)
    chunk_decay = torch.exp(decay_log)                            # [b, nc, H]
    carry = (torch.zeros_like(states[:, 0]) if initial_state is None
             else initial_state.transpose(-1, -2).float())        # [b, H, N, P]
    prev = torch.empty_like(states)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]

    # y_inter[i] = exp(seg_i) C_i S_prev, over the G groups of H / G heads,
    # with seg kept as the kernel keeps it (e^seg = e^hi e^lo)
    hi, lo = seg_hi_lo((dt.float() * A.float()).reshape(b, nc, chunk, H), dim=2)
    y_inter = torch.einsum("bcqgn,bcgrnp->bcqgrp",
                           C.float().reshape(b, nc, chunk, G, N),
                           prev.view(b, nc, G, rep, N, P)).reshape(b, nc, chunk, H, P)
    y = y_intra.reshape(b, nc, chunk, H, P) + y_inter * (torch.exp(hi) * torch.exp(lo))[..., None]
    y = y.reshape(b, sp, H, P)[:, :s].to(x.dtype)
    return (y, carry.transpose(-1, -2)) if return_state else y
