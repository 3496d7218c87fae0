"""Plain PyTorch pieces of the reference: float32 with TF32 off, or, for
the control, the same computation with every bfloat16 product of the
program taken in float8.

The control quantizes both operands of a projection to float8 e4m3 (one
scale a tensor, amax to 448) and, under autograd, the gradient that
enters its backward to float8 e5m2; the products and sums are float32, as
an fp8 GEMM accumulates.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _q8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    top = torch.finfo(dtype).max
    scale = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / scale).to(dtype).to(t.dtype) * scale


class _GradQ8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _q8(g, torch.float8_e5m2)


def mm(x: torch.Tensor, w: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """x @ w in float32, or with float8 operands (the control)."""
    if not fp8:
        return x @ w
    xq = x + (_q8(x) - x).detach()
    wq = w + (_q8(w) - w).detach()
    return _GradQ8.apply(xq @ wq)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with gain 1 + w (the stored weight is the gain less one)."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1.0 + w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy over every position."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return (logz - gold).mean()


def lr_at(step: int, opt: dict) -> float:
    """Linear warmup to lr, then a cosine to a tenth of it at total_steps."""
    lr, warm, total = opt["lr"], opt["warmup"], opt["total_steps"]
    if step < warm:
        return lr * min(step / max(warm, 1), 1.0)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))


@torch.no_grad()
def adamw_step(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor], step: int,
               opt: dict) -> float:
    """AdamW as the configuration states it: the gradients clipped to a
    global norm, eps inside the square root, weight decay on every leaf of
    two or more dimensions (the stacked [L, ...] leaves included). Updates
    in place; returns the clip's scale."""
    total = sum(float(torch.sum(g.double() ** 2)) for g in grads.values())
    scale = min(opt["clip_norm"] / max(math.sqrt(total), 1e-9), 1.0)
    lr = lr_at(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    for name, p in params.items():
        g = grads[name] * scale
        mu[name].mul_(b1).add_(g, alpha=1 - b1)
        nu[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (mu[name] / bc1) * torch.rsqrt(nu[name] / bc2 + opt["eps"] ** 2)
        decay = lr * opt["weight_decay"] if p.dim() >= 2 else 0.0
        p.mul_(1 - decay).sub_(lr * u)
    return scale


def norm(t: torch.Tensor) -> float:
    """The 2-norm, summed in float64 over slices of 2^24 elements."""
    return math.sqrt(sum(float(torch.sum(s.double() ** 2))
                         for s in t.reshape(-1).split(1 << 24)))
