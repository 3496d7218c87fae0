"""Wrappers of the CUDA attention kernels (``csrc/flash_attention.cu``).

``flash_attention`` replaces the Pallas kernel of the same name in
``repro/kernels/flash_attention.py`` (prefill), ``flash_decode`` replaces
``flash_decode`` there (decode over the KV cache). Both keep the JAX
signatures and layouts at their public functions. ``flash_attention_bwd``
is the backward of ``flash_attention``, which the Pallas kernel lacks (the
JAX package trains through XLA's autodiff of its einsum attention);
``FlashAttention`` joins the two in a ``torch.autograd.Function``. They
take CUDA tensors only and launch the kernel or raise: the plain versions
are in ``ref.py``, and ``ops.py`` picks between the two by the tensor's
device. Each wrapper call adds one to its count in ``build.LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import build
from .build import LAUNCHES
from ..tally_hooks import counts_as
from .ref import ref_attention, ref_attention_bwd, ref_decode

SUPPORTED_HEAD_DIMS = (16, 32, 64, 80, 128)
# decode keeps q and the accumulators of all g heads of a kv head in each
# thread's registers (2 x g x 8 floats at a bf16 cache): past g 8 they would
# spill
MAX_GQA_GROUP = 8
DECODE_TILE = 64             # keys per split unit
DECODE_BLOCKS_PER_SM = 3     # a block takes 64 KB of shared memory: three fit an SM
DECODE_MAX_SPLITS = 8        # the splits of a (row, kv head) are one cluster: <= 8 blocks
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built
    ``flash_attention.cu``'s C entry points on ``lib``, and return it."""
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.flash_attention_fwd.argtypes = [I, I, P, P, P, P, I, I, I, I, I, P, F, I, I, P, P]
    lib.flash_attention_fwd.restype = I
    lib.flash_attention_bwd.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P,
                                        F, I, I, P]
    lib.flash_attention_bwd.restype = I
    lib.flash_decode_fwd.argtypes = [I, I, I, P, P, P, P, P, P, P, I, I, I, I, I, I, P, F, P]
    lib.flash_decode_fwd.restype = I
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.load("flash_attention"))


def _check_common(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous")
    if k.dtype != v.dtype:
        raise ValueError("k and v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % k.shape[1]:
        raise ValueError("GQA requires h % kvh == 0")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")


def _check_16b_rows(what: str, **ts: torch.Tensor) -> None:
    """Kernels that read rows 16 bytes at a time (the bf16 prefill's and
    backward's cp.async, decode's K/V loads) need every row to start on a
    16-byte boundary: the pointer aligned, every stride but the head dim's
    a multiple of 16 bytes. The model's views meet this; anything else
    raises."""
    for name, t in ts.items():
        if t.data_ptr() % 16 or any(st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{name}: {what} needs a 16-byte aligned pointer and strides "
                             f"that are multiples of 16 bytes, got pointer "
                             f"{t.data_ptr():#x}, strides {t.stride()} of {t.dtype}")


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


@counts_as(ref_attention)
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0, return_lse: bool = False):
    """q: [b, h, sq, d]; k, v: [b, kvh, skv, d] -> [b, h, sq, d] (and, with
    ``return_lse``, each row's logsumexp, fp32 [b, h, sq], for the backward).

    Any strides with a contiguous head dim (in bf16, 16-byte aligned
    rows: see ``_check_16b_rows``); any sq and skv (ragged edges are
    masked in the kernel). The window applies with the causal mask.
    bf16 runs on the tensor cores (P rounded to bf16 before P·V, as
    FlashAttention does), fp32 on the CUDA cores. The result is a
    [b, h, sq, d] view of a [b, sq, h, d] buffer, so the model's merge
    of the heads is free."""
    _check_common(q, k, v)
    if q.dtype != k.dtype:
        raise ValueError("q, k and v must share one dtype")
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    if causal and sq > skv:
        raise ValueError("causal attention needs skv >= sq (every query row "
                         "must see a key)")
    if q.dtype == torch.bfloat16:
        _check_16b_rows("bf16 prefill", q=q, k=k, v=v)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if return_lse else None
    with torch.cuda.device(q.device):
        strides = (ctypes.c_longlong * 12)(
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1),
            out.stride(2))
        rc = _lib().flash_attention_fwd(
            _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, h, kvh, sq, skv, strides, 1.0 / math.sqrt(d),
            int(causal), int(window), None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


@counts_as(ref_attention_bwd)
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        lse: torch.Tensor, dO: torch.Tensor, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal,
    window)`` = o against the output gradient dO, from the forward's
    ``lse`` (fp32 [b, h, sq]). Any strides with a contiguous head dim for
    q, k, v and o; dO is made contiguous here. Returns tensors of q's, k's
    and v's shapes in their dtype, as views of [b, s, heads, d] buffers
    (the layout the model's head split reads back without a copy).
    Three launches (the row sums D = rowsum(dO o), then dK and dV, then
    dQ) on the current stream; D lives in a scratch allocated here. bf16
    runs on the tensor cores (P and dS rounded to bf16 before their
    products, as FlashAttention-2 does) and copies rows 16 bytes at a
    time, so every one of the eight tensors needs 16-byte aligned rows
    (see ``_check_16b_rows``); fp32 runs on the CUDA cores."""
    _check_common(q, k, v)
    if q.dtype != k.dtype or o.dtype != q.dtype or dO.dtype != q.dtype:
        raise ValueError("q, k, v, o and dO must share one dtype")
    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("dO", dO)):
        if t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} on {t.device}")
    if o.stride(-1) != 1:
        raise ValueError("o: the head dim must be contiguous")
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous() \
            or lse.device != q.device:
        raise ValueError("lse must be a contiguous fp32 [b, h, sq] tensor on q's device")
    if causal and sq > skv:
        raise ValueError("causal attention needs skv >= sq")
    dO = dO.contiguous()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    dk = torch.empty((b, skv, kvh, d), dtype=k.dtype, device=q.device).permute(0, 2, 1, 3)
    dv = torch.empty((b, skv, kvh, d), dtype=v.dtype, device=q.device).permute(0, 2, 1, 3)
    ts = (q, k, v, o, dO, dq, dk, dv)
    if q.dtype == torch.bfloat16:
        _check_16b_rows("bf16 backward", **dict(zip(("q", "k", "v", "o", "dO", "dq", "dk", "dv"),
                                                    ts)))
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        strides = (ctypes.c_longlong * 24)(*(t.stride(i) for t in ts for i in range(3)))
        rc = _lib().flash_attention_bwd(
            _DTYPES[q.dtype], d, *(t.data_ptr() for t in ts[:5]), lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, kvh, sq,
            skv, strides, 1.0 / math.sqrt(d), int(causal), int(window),
            torch.cuda.current_stream().cuda_stream)
    _check(rc, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with a gradient: the forward kernel (saving each row's
    logsumexp) and the backward kernel on CUDA tensors, the plain pair
    (``ref_attention`` with its logsumexp, ``ref_attention_bwd``) on CPU
    tensors. ``ops.attention_op`` calls it when a gradient is wanted."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, window: int = 0):
        fwd = flash_attention if _on_card(q) else ref_attention
        o, lse = fwd(q, k, v, causal=causal, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, dO):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_attention_bwd if _on_card(q) else ref_attention_bwd
        dq, dk, dv = bwd(q, k, v, o, lse, dO, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def decode_plan(b: int, kvh: int, S: int, sms: int) -> tuple:
    """(split_len, n_splits) of the decode kernel's grid (n_splits, kvh, b):
    as many splits of the cache as let every block be resident at once
    (``DECODE_BLOCKS_PER_SM`` on each of ``sms`` SMs), no more than there
    are tiles or than a cluster holds (``DECODE_MAX_SPLITS``), and at least
    one. A cluster holds its SMs until its last split is done, so a second
    wave of clusters would wait on the first's slowest split. Each split is
    a whole number of ``DECODE_TILE``-key tiles (rounding up, which can halve
    the count), and together they cover [0, S)."""
    tiles = -(-S // DECODE_TILE)
    n = max(1, min(DECODE_BLOCKS_PER_SM * sms // (b * kvh), tiles, DECODE_MAX_SPLITS))
    split_len = -(-tiles // n) * DECODE_TILE
    return split_len, -(-S // split_len)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@counts_as(ref_decode)
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, starts: Optional[torch.Tensor] = None,
                 lse: bool = False):
    """Single-token attention over a KV cache, or over a piece of it.

    q: [b, h, 1, d]; k, v: [b, kvh, S, d] with any strides whose rows
    start on 16-byte boundaries (the model passes a permuted view of its
    [b, S, kvh, d] cache); lengths, and ``starts`` if given: int32 [b].
    Cache position t of row i is attended when ``starts[i] <= t <
    lengths[i]`` (``starts`` defaults to zeros): a sliding window, or a
    rank's block of a sequence-split cache. A row may attend no position:
    its output is 0 and its logsumexp -inf. The cache may be bf16 under an
    fp32 q (the model's cache is always bf16). Returns [b, h, 1, d] in q's
    dtype; with ``lse`` also each (row, head)'s logsumexp of the scaled
    scores, fp32 [b, h, 1], from the kernel's own running max and sum."""
    if (q.dtype, k.dtype) == (torch.bfloat16, torch.float32):
        raise ValueError("an fp32 cache needs an fp32 q")
    _check_common(q, k, v)
    b, h, one, d = q.shape
    kvh, S = k.shape[1], k.shape[2]
    if one != 1:
        raise ValueError(f"flash_decode takes one query per row, got {one}")
    if h // kvh > MAX_GQA_GROUP:
        raise ValueError(f"GQA group {h // kvh} > {MAX_GQA_GROUP}")
    for name, t in (("lengths", lengths), ("starts", starts)):
        if t is not None and (t.dtype != torch.int32 or t.shape != (b,)
                              or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 [b] tensor on q's device")
    split_len, n_splits = decode_plan(b, kvh, S, _sm_count(q.device.index))
    _check_16b_rows("flash_decode", k=k, v=v)
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    out_lse = torch.empty((b, h, 1), dtype=torch.float32, device=q.device) if lse else None
    with torch.cuda.device(q.device):
        strides = (ctypes.c_longlong * 10)(
            q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1))
        rc = _lib().flash_decode_fwd(
            _DTYPES[q.dtype], _DTYPES[k.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths.data_ptr(), None if starts is None else starts.data_ptr(), out.data_ptr(),
            None if out_lse is None else out_lse.data_ptr(), b, h, kvh, S, split_len, n_splits,
            strides, 1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    _check(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return (out, out_lse) if lse else out
