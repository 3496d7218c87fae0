"""Batched serving entry point: prefill + greedy decode with a KV cache.

The port of ``repro/launch/serve.py``. Prefill runs once (attention
through the ``flash_attention`` kernel, every Mamba2 block's scan through
the ``ssd_chunk`` kernel); its cache is spliced in place into the
max_len buffers (bf16 KV, fp32 SSM states); then decode steps (attention
through the ``flash_decode`` kernel, Mamba2 blocks by their recurrence)
update those buffers in place.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
      --no-smoke --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --no-smoke --batch 8 --prompt-len 512 --gen 32

MoE models route each token's top-k experts through the capacity
dispatch of ``models/moe.py`` in prefill and decode alike. The stub
frontends (musicgen-medium's audio, qwen2-vl-72b's vision) are fed random
embeddings from the seed, as JAX's ``run_serving`` feeds them:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \\
      --no-smoke --batch 8 --prompt-len 512 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config
from ..device import resolve_device
from ..models.config import ShapeConfig
from ..models.model import Model, make_model
from ..parallel.sharding import ShardingCtx, gather_seq, seq_shards
from ..tally_hooks import span


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def splice_cache(cache: Dict[str, torch.Tensor], pcache: Dict[str, torch.Tensor],
                 ctx: Optional[ShardingCtx] = None) -> None:
    """Copy a prefill cache into the max_len decode buffers, in place and
    in each buffer's dtype. KV caches are shorter on their sequence axis
    and land at its start; SSM states match their buffers and are copied
    whole (``splice`` in repro/launch/serve.py). Under ``ctx``'s mesh both
    are this rank's blocks: the prompt's KV blocks are gathered over
    "model" and the rank keeps the part that falls in its block of the
    buffer (JAX's reshard of the prefill cache into the decode layout).
    The span ``serve.splice``."""
    sp = seq_shards(ctx)
    with span("serve.splice"):
        for name, buf in cache.items():
            part = pcache[name]
            if sp is not None and name.endswith(("k", "v")):
                ax = buf.dim() - 3                          # [..., b, S, kvh, d]
                whole = gather_seq(part.contiguous(), ax, sp)
                first, S = sp.rank * buf.shape[ax], buf.shape[ax]
                n = max(0, min(whole.shape[ax] - first, S))
                buf.narrow(ax, 0, n).copy_(whole.narrow(ax, min(first, whole.shape[ax]), n))
                continue
            buf[tuple(slice(0, n) for n in part.shape)].copy_(part)


def run_serving(arch: str, batch: int = 4, prompt_len: int = 16,
                gen: int = 16, smoke: bool = True, seed: int = 0,
                device: Union[str, torch.device] = "cuda") -> dict:
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the LM head is an fp32 product, as in JAX: keep TF32 out of it
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    model = make_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(seed))
    return serve_model(model, batch, prompt_len, gen, seed)


def serve_model(model: Model, batch: int, prompt_len: int, gen: int, seed: int = 0) -> dict:
    """Prefill a random prompt of ``batch`` x ``prompt_len`` tokens (drawn
    from ``seed``) into max_len decode buffers, then ``gen - 1`` greedy
    decode steps; the body of ``run_serving``, on a model built by the
    caller. A stub frontend's model takes embeddings in place of tokens:
    a ``standard_normal`` prompt [batch, prompt_len, d_model], then one
    [batch, 1, d_model] draw per decode step, from the same generator in
    JAX's order (drawn before the clock starts), and the argmax tokens are
    recorded but not fed back. Returns the tokens [batch, gen], the
    prefill and decode times (host clock, synchronized) and whether every
    logit was finite."""
    cfg, dev = model.cfg, model.device
    max_len = prompt_len + gen
    shape = ShapeConfig("serve", max_len, batch, "decode")
    rng = np.random.default_rng(seed)
    stub = cfg.frontend != "token"
    cache = model.init_cache(shape)
    if stub:
        prompt = {"embeds": torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model)).astype(np.float32)).to(dev)}
        steps = torch.from_numpy(np.stack([
            rng.standard_normal((batch, 1, cfg.d_model)).astype(np.float32)
            for _ in range(gen - 1)])).to(dev) if gen > 1 else None
    else:
        prompt = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab, (batch, prompt_len)).astype(np.int64)).to(dev)}

    # ---- prefill into the max_len cache ----
    _sync(dev)
    t0 = time.perf_counter()
    logits, pcache = model.prefill_step(**prompt)
    splice_cache(cache, pcache)
    del pcache
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()

    # ---- greedy decode loop ----
    tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    out_tokens = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = model.serve_step(cache, None if stub else tok, prompt_len + i,
                                         embeds=steps[i] if stub else None)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out_tokens.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    toks = torch.cat(out_tokens, dim=1).cpu().numpy()
    tps = batch * (gen - 1) / max(decode_s, 1e-9)
    print(f"prefill({batch}x{prompt_len}) {prefill_s*1e3:.1f}ms; "
          f"decode {gen-1} steps {decode_s*1e3:.1f}ms "
          f"({tps:.0f} tok/s); sample row: {toks[0][:8]}", flush=True)
    return {"tokens": toks, "prefill_s": prefill_s, "decode_s": decode_s,
            "logits_finite": bool(finite)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def main() -> None:
    args = _parser().parse_args()
    run_serving(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, smoke=args.smoke, seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
