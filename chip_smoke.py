#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. env: the card, its power limit, and the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (nvcc, at first use).
2. kernels: each kernel against its plain PyTorch version on the card,
   at the serving shapes and a few more, with the kernel's, the plain
   version's and one library call's time beside the card's bound.
3. serve: ``run_serving("llama3.2-3b", batch=8, prompt_len=512, gen=32,
   smoke=False)`` at full width (28 layers, d_model 3072), with the
   kernels' launch counts read around exactly this run.
4. consistency: prefill of s tokens plus one decode step against a full
   forward over s+1 tokens, at full width in bf16.
5. profile: device time by kernel and the device's idle share for one
   prefill and a few decode steps at the serving shape.

Then the kernel table as one JSON line, the card's name and power limit
as ``nvidia-smi`` prints them, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without a card, or without the
repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # fp32 outside the tensor cores
# atol = rtol, as in tests/test_kernels.py:32: in bf16 the output itself is
# rounded to bf16 (8 bits of mantissa); in fp32 only the order of the sums
# differs between the kernel and the plain version
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
ARCH = "llama3.2-3b"
SERVE = dict(batch=8, prompt_len=512, gen=32)


def emit(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(out, ref, dtype: str) -> float:
    import torch
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bad = (diff > TOL[dtype] + TOL[dtype] * ref.float().abs()).sum().item()
    check(math.isfinite(err) and bad == 0,
          f"{bad} elements beyond atol=rtol={TOL[dtype]} (max |diff| {err})")
    return err


# ---------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------- #
def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_decode
    from repro_torch.kernels.ref import ref_attention, ref_decode

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            getattr(torch, dtype))

    # ---- flash_attention (prefill) ----
    cases = [  # name, b, h, kvh, sq, skv, d, window, dtype
        ("serve", 8, 24, 8, 512, 512, 128, 0, "bfloat16"),
        ("serve_fp32", 8, 24, 8, 512, 512, 128, 0, "float32"),
        ("window", 2, 24, 8, 512, 512, 128, 128, "bfloat16"),
        ("window_fp32", 2, 8, 2, 256, 256, 64, 32, "float32"),
        ("ragged", 2, 24, 8, 200, 200, 128, 0, "bfloat16"),
        ("ragged_fp32", 2, 24, 8, 200, 200, 128, 0, "float32"),
        ("offset_q", 2, 6, 2, 72, 200, 32, 0, "float32"),
        ("d16", 2, 4, 2, 256, 256, 16, 0, "float32"),
        ("d16_bf16", 2, 4, 2, 256, 256, 16, 0, "bfloat16"),
        ("d80", 2, 32, 32, 192, 192, 80, 0, "bfloat16"),
    ]
    fa = {}
    for name, b, h, kvh, sq, skv, d, window, dtype in cases:
        q = randn(b, h, sq, d, dtype=dtype)
        k = randn(b, kvh, skv, d, dtype=dtype)
        v = randn(b, kvh, skv, d, dtype=dtype)
        out = flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        ref = ref_attention(q, k, v, window=window)
        err = compare(out, ref, dtype)
        emit("kernels", kernel="flash_attention", case=name, shape=[b, h, kvh, sq, skv, d],
             window=window, dtype=dtype, max_abs_err=err, tol=TOL[dtype])
        if name == "serve":
            ms = time_ms(lambda: flash_attention(q, k, v))
            plain_ms = time_ms(lambda: ref_attention(q, k, v), iters=5)
            g = h // kvh
            ke, ve = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(q, ke, ve, is_causal=True))
            pairs = sq * (sq + 1) // 2                    # causal (q, k) pairs per head
            flops = 4.0 * d * pairs * b * h
            nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
            t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
            fa = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                      bound_ms=1e3 * max(t_ops, t_bytes),
                      bound_by="operations" if t_ops >= t_bytes else "bytes")
            emit("kernels", kernel="flash_attention", case=name, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=fa["bound_ms"], bound_by=fa["bound_by"],
                 tflops=flops / ms / 1e9)

    # ---- flash_decode, through the model's [b, S, kvh, d] cache layout ----
    fd = {}
    for dtype in ("bfloat16", "float32"):
        b, h, kvh, S, d = 8, 24, 8, 544, 128
        copies = 4      # rotate caches (4 x 18 MB > the 50 MB L2): each launch reads cold
        q = randn(b, 1, h, d, dtype=dtype).permute(0, 2, 1, 3)
        caches = [(randn(b, S, kvh, d, dtype=dtype), randn(b, S, kvh, d, dtype=dtype))
                  for _ in range(copies)]
        views = [(ck.permute(0, 2, 1, 3), cv.permute(0, 2, 1, 3)) for ck, cv in caches]
        lengths = torch.randint(S // 2, S + 1, (b,), generator=gen, device=dev,
                                dtype=torch.int32)
        lengths[0] = S
        lengths[1] = 1
        out = flash_decode(q, *views[0], lengths)
        torch.cuda.synchronize()
        ref = ref_decode(q, *views[0], lengths)
        err = compare(out, ref, dtype)
        emit("kernels", kernel="flash_decode", case="serve" if dtype == "bfloat16" else
             "serve_fp32", shape=[b, h, kvh, S, d], dtype=dtype,
             lengths=lengths.tolist(), max_abs_err=err, tol=TOL[dtype])
        if dtype != "bfloat16":
            continue
        it = iter(range(1 << 30))
        ms = time_ms(lambda: flash_decode(q, *views[next(it) % copies], lengths))
        plain_ms = time_ms(lambda: ref_decode(q, *views[next(it) % copies], lengths))
        g = h // kvh
        expanded = [(kv.repeat_interleave(g, dim=1), vv.repeat_interleave(g, dim=1))
                    for kv, vv in views]
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, *expanded[next(it) % copies], attn_mask=mask))
        ctx = int(lengths.sum().item())                   # keys actually attended
        nbytes = 2.0 * 2 * kvh * ctx * d + 2.0 * 2 * q.numel() + 4 * b
        flops = 4.0 * h * d * ctx
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        fd = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=1e3 * max(t_ops, t_bytes),
                  bound_by="operations" if t_ops >= t_bytes else "bytes")
        emit("kernels", kernel="flash_decode", case="serve", ms=ms, plain_ms=plain_ms,
             library_ms=lib_ms, bound_ms=fd["bound_ms"], bound_by=fd["bound_by"],
             gbps=nbytes / ms / 1e6)
    return {"flash_attention": fa, "flash_decode": fd}


# ---------------------------------------------------------------------- #
# phase 3: the main path
# ---------------------------------------------------------------------- #
def phase_serve(dev) -> dict:
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import run_serving

    # warm-up (cuBLAS handles and algorithms, the allocator): one short run
    run_serving(ARCH, batch=SERVE["batch"], prompt_len=SERVE["prompt_len"], gen=2,
                smoke=False, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = run_serving(ARCH, smoke=False, seed=0, device=dev, **SERVE)
    launches = dict(LAUNCHES)
    steps = SERVE["gen"] - 1
    emit("serve", arch=ARCH, **SERVE, prefill_ms=1e3 * r["prefill_s"],
         decode_ms_per_step=1e3 * r["decode_s"] / steps,
         decode_tokens_per_s=SERVE["batch"] * steps / r["decode_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, logits_finite=r["logits_finite"],
         sample_tokens=r["tokens"][0, :8].tolist())
    n_layers = 28
    check(launches["flash_attention"] == n_layers,
          f"flash_attention launches {launches['flash_attention']} != {n_layers}")
    check(launches["flash_decode"] == n_layers * steps,
          f"flash_decode launches {launches['flash_decode']} != {n_layers * steps}")
    check(r["logits_finite"], "non-finite logits")
    check(r["tokens"].shape == (SERVE["batch"], SERVE["gen"]), "token shape")
    return launches


# ---------------------------------------------------------------------- #
# phase 4: prefill + decode == forward, at full width
# ---------------------------------------------------------------------- #
def phase_consistency(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.model import make_model

    cfg = get_config(ARCH)
    check(cfg.n_layers == 28 and cfg.d_model == 3072, "full-width config")
    model = make_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(1))
    b, s = 2, 256
    toks = torch.randint(0, cfg.vocab, (b, s + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    full = model.forward_logits(toks)[:, -1].float()
    _, cache = model.prefill_step(toks[:, :s])
    cache = {k: F.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}   # one more slot
    logits, _ = model.serve_step(cache, toks[:, s:], s)
    diff = (logits[:, 0].float() - full).abs().max().item()
    scale = full.abs().max().item()
    # both paths attend the same bf16 k/v in fp32 and differ only in the
    # order of sums (kernels, matmul shapes): 2e-2 of the largest logit
    emit("consistency", batch=b, seq=s, max_abs_diff=diff, max_abs_logit=scale,
         rel=diff / scale, tol_rel=2e-2)
    check(math.isfinite(diff) and diff <= 2e-2 * scale,
          f"prefill+decode vs forward: {diff} > 2e-2 * {scale}")
    return model


# ---------------------------------------------------------------------- #
# phase 5: where the time of the serving shape goes (torch.profiler)
# ---------------------------------------------------------------------- #
def phase_profile(dev, model, steps: int = 4) -> None:
    """Device time by kernel and the device's idle share, for one prefill
    and a few decode steps at the serving shape (launch counts are read
    before this phase)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.config import ShapeConfig

    b, s = SERVE["batch"], SERVE["prompt_len"]
    toks = torch.randint(0, model.cfg.vocab, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    cache = model.init_cache(ShapeConfig("serve", s + steps, b, "decode"))

    def prefill():
        logits, pc = model.prefill_step(toks)
        for k, buf in cache.items():
            buf[:, :, :s].copy_(pc[k])
        return logits[:, -1].argmax(-1, keepdim=True)

    def decode(tok):
        for i in range(steps):
            logits, _ = model.serve_step(cache, tok, s + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return tok

    tok = prefill()
    torch.cuda.synchronize()
    for name, fn in (("prefill", prefill), ("decode", lambda: decode(tok))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = []
        for evt in prof.key_averages():
            if evt.device_type != DeviceType.CUDA:       # kernels and copies only
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = evt.self_cuda_time_total
            rows.append((dev_us / 1e3, evt.count, evt.key[:60]))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        emit("profile", part=name, batch=b, prompt_len=s,
             decode_steps=steps if name == "decode" else 0, wall_ms=wall_ms,
             device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
             top=[{"op": k, "ms": ms, "calls": n} for ms, n, k in rows[:12]])


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 products in full fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t0 = time.perf_counter()
    libs = build.build(["flash_attention"])
    build_s = time.perf_counter() - t0
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            print(log.read_text(), file=sys.stderr)
    emit("env", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()])

    timed = phase_kernels(dev)
    launches = phase_serve(dev)
    model = phase_consistency(dev)
    phase_profile(dev, model)
    del model

    source = "src/repro_torch/kernels/csrc/flash_attention.cu"
    replaces = {"flash_attention": "src/repro/kernels/flash_attention.py:87",
                "flash_decode": "src/repro/kernels/flash_attention.py:179"}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces[name],
         "launches": launches[name], **timed[name]} for name in replaces]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
