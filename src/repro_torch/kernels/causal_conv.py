"""Wrapper of the CUDA causal-conv kernels (``csrc/causal_conv.cu``).

Mamba2's depthwise causal conv over the sequence and its SiLU,
``silu(bias + sum_i w[i] u[t - K + 1 + i])`` with K = 4 taps, on u [b, s,
c] as ``models/mamba2.py`` feeds it: a strided view of the block's input
projection (``xBC``), and on the sequence-split path a halo [b, K - 1, c],
the positions before the rank's block. No TPU kernel stands behind it: the
JAX package's conv is plain jnp, which XLA fuses on a TPU, while eager
PyTorch makes a dozen passes over [b, s, c] (``ref_causal_conv``) and
autograd as many again.

``causal_conv`` is one launch of ``causal_conv_fwd_kernel`` (one count in
``build.LAUNCHES["causal_conv"]``); ``causal_conv_bwd`` one of
``causal_conv_bwd_kernel`` and one of ``causal_conv_reduce_kernel``, which
sums the taps' and the bias's per-run partials in a fixed order (one count
in ``build.LAUNCHES["causal_conv_bwd"]``). Both take CUDA tensors only and
launch or raise. Their plain versions are ``ref_causal_conv`` (the
model's arithmetic: taps added one at a time in the input type, as the
JAX model adds them) and ``ref_causal_conv_bwd`` (the backward by explicit
formulas, in fp32 or wider). ``CausalConv`` pairs the kernels on CUDA
tensors and the plain pair on CPU tensors for autograd.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build
from .build import LAUNCHES
from ..tally_hooks import counts_as

TAPS = 4                 # kK: the taps are a compile-time constant of the kernels


def ref_causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv over seq and its SiLU: u [b, s, c], w [K, c],
    bias [c]; ``halo`` [b, K-1, c], the positions before u's first (zeros
    where None). The taps are added one at a time in u's dtype."""
    K, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, K - 1, 0)) if halo is None else torch.cat([halo, u], dim=1)
    out = torch.zeros_like(u)
    for i in range(K):
        out = out + pad[:, i:i + s, :] * w[i]
    return F.silu(out + bias)


def ref_causal_conv_bwd(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                        halo: Optional[torch.Tensor], gy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   Optional[torch.Tensor]]:
    """The gradients (gu, gw, gb, ghalo) of ``ref_causal_conv``'s inputs
    from gy [b, s, c], computed as the kernel does: the pre-activation
    again, ``gpre = gy silu'(pre)``, ``gu[p] = sum_i w[i] gpre[p + K - 1 -
    i]``, ``gw[i] = sum_t gpre[t] u[t - K + 1 + i]``, ``gb = sum_t gpre``,
    in fp32 (fp64 inputs in fp64), each returned in its input's dtype
    (ghalo None without a halo)."""
    K, s = w.shape[0], u.shape[1]
    f = torch.promote_types(u.dtype, torch.float32)
    uf, wf = u.to(f), w.to(f)
    pad = F.pad(uf, (0, 0, K - 1, 0)) if halo is None else torch.cat([halo.to(f), uf], dim=1)
    pre = bias.to(f) + sum(pad[:, i:i + s] * wf[i] for i in range(K))
    sig = torch.sigmoid(pre)
    gpre = gy.to(f) * sig * (1 + pre * (1 - sig))
    gpad = torch.zeros_like(pad)                    # the gradient of every padded position
    for i in range(K):
        gpad[:, i:i + s] += gpre * wf[i]
    gw = torch.stack([(gpre * pad[:, i:i + s]).sum((0, 1)) for i in range(K)])
    gb = gpre.sum((0, 1))
    ghalo = None if halo is None else gpad[:, :K - 1].to(halo.dtype)
    return gpad[:, K - 1:].to(u.dtype), gw.to(w.dtype), gb.to(bias.dtype), ghalo


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and result types of a built ``causal_conv.cu``'s
    C entry points on ``lib``, and return it."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.causal_conv_fwd.argtypes = [P] * 5 + [I] * 3 + [L] * 4 + [I, P]
    lib.causal_conv_fwd.restype = I
    lib.causal_conv_bwd.argtypes = [P] * 10 + [I] * 3 + [P, I, P]
    lib.causal_conv_bwd.restype = I
    lib.causal_conv_partial_floats.argtypes = [I] * 3
    lib.causal_conv_partial_floats.restype = L
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.load("causal_conv"))


def _check(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
           halo: Optional[torch.Tensor], gy: Optional[torch.Tensor] = None) -> None:
    """Raise on inputs the kernels do not take (the device last)."""
    if u.dim() != 3:
        raise ValueError(f"u must be [b, s, c], got {tuple(u.shape)}")
    b, s, c = u.shape
    if u.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"u: dtype {u.dtype}, expected torch.bfloat16 or torch.float32")
    if w.dim() != 2 or w.shape[0] != TAPS:
        raise ValueError(f"w: shape {tuple(w.shape)}, the kernels take K = {TAPS} taps")
    named = [("w", w, (TAPS, c)), ("bias", bias, (c,))]
    if halo is not None:
        named.append(("halo", halo, (b, TAPS - 1, c)))
    if gy is not None:
        named.append(("gy", gy, (b, s, c)))
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != u.dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, expected u's {u.dtype}")
    for name, t in (("u", u), ("halo", halo), ("gy", gy)):
        if t is not None and t.stride(2) != 1:
            raise ValueError(f"{name}: channel stride {t.stride(2)}, the kernels take 1")
    if not (w.is_contiguous() and bias.is_contiguous()):
        raise ValueError("w and bias must be contiguous")
    if max(b, s, c) >= 2 ** 31:     # the C entry points take ints (and refuse a grid too large)
        raise ValueError(f"[{b}, {s}, {c}] does not fit the kernels' int sizes")
    for name, t in (("u", u), ("w", w), ("bias", bias), ("halo", halo), ("gy", gy)):
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t is not None and t.device != u.device:
            raise ValueError("u, w, bias, halo and gy must be on one device")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _halo_strides(halo: Optional[torch.Tensor]) -> Tuple[int, int]:
    return (0, 0) if halo is None else (halo.stride(0), halo.stride(1))


@counts_as(ref_causal_conv)
def causal_conv(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                halo: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``ref_causal_conv`` on the card: u [b, s, c] (any batch and row
    strides, channel stride 1), w [K, c], bias [c] contiguous, halo [b,
    K-1, c] or None; one dtype, bf16 or fp32. Returns y [b, s, c]
    contiguous in u's dtype."""
    _check(u, w, bias, halo)
    b, s, c = u.shape
    y = torch.empty((b, s, c), dtype=u.dtype, device=u.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(u.device):
        rc = _lib().causal_conv_fwd(
            u.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(halo), y.data_ptr(), b, s, c,
            u.stride(0), u.stride(1), *_halo_strides(halo), int(u.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"causal_conv: CUDA error {rc} at launch")
    LAUNCHES["causal_conv"] += 1
    return y


@counts_as(ref_causal_conv_bwd)
def causal_conv_bwd(u: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    halo: Optional[torch.Tensor], gy: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Optional[torch.Tensor]]:
    """``ref_causal_conv_bwd`` on the card: the inputs as ``causal_conv``
    takes them and gy [b, s, c] (channel stride 1). Returns gu [b, s, c],
    gw [K, c], gb [c] and ghalo [b, K-1, c] (None without a halo),
    contiguous, in the inputs' dtype; two calls agree bit for bit."""
    _check(u, w, bias, halo, gy)
    b, s, c = u.shape
    dev = u.device
    gu = torch.empty((b, s, c), dtype=u.dtype, device=dev)
    gw = torch.empty((TAPS, c), dtype=u.dtype, device=dev)
    gb = torch.empty((c,), dtype=u.dtype, device=dev)
    ghalo = None if halo is None else torch.empty((b, TAPS - 1, c), dtype=u.dtype, device=dev)
    if gu.numel() == 0:
        return gu, gw.zero_(), gb.zero_(), None if ghalo is None else ghalo.zero_()
    with torch.cuda.device(dev):
        lib = _lib()
        part = torch.empty(lib.causal_conv_partial_floats(b, s, c), dtype=torch.float32,
                           device=dev)
        strides = (ctypes.c_longlong * 6)(u.stride(0), u.stride(1), *_halo_strides(halo),
                                          gy.stride(0), gy.stride(1))
        rc = lib.causal_conv_bwd(
            u.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(halo), gy.data_ptr(),
            gu.data_ptr(), gw.data_ptr(), gb.data_ptr(), _ptr(ghalo), part.data_ptr(), b, s, c,
            strides, int(u.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"causal_conv_bwd: CUDA error {rc} at launch")
    LAUNCHES["causal_conv_bwd"] += 1
    return gu, gw, gb, ghalo


class CausalConv(torch.autograd.Function):
    """``causal_conv`` with a gradient: the kernels on CUDA tensors, the
    plain pair (``ref_causal_conv``, ``ref_causal_conv_bwd``) on CPU
    tensors. Saves u as it was given (for the model, a view of the input
    projection, which the block keeps anyway) and the halo; the backward
    recomputes the pre-activation."""

    @staticmethod
    def forward(ctx, u, w, bias, halo):
        ctx.save_for_backward(u, w, bias, halo)
        fwd = causal_conv if _on_card(u) else ref_causal_conv
        return fwd(u, w, bias, halo)

    @staticmethod
    def backward(ctx, gy):
        u, w, bias, halo = ctx.saved_tensors
        bwd = causal_conv_bwd if _on_card(u) else ref_causal_conv_bwd
        return bwd(u, w, bias, halo, gy.contiguous())


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"
