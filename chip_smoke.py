#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. env: the card, its power limit, and the build of every CUDA kernel
   from ``src/repro_torch/kernels/csrc`` (nvcc, all started together),
   with the registers and spills ptxas reports for each kernel; no
   instantiation of the decode, SSD or feasibility kernels may spill.
2. kernels: each attention kernel against its plain PyTorch version on
   the card, at the serving shapes and a few more: prefill in bf16 (the
   tensor-core kernel: the model's permuted [b, s, h, d] views, windows,
   a ragged length, skv > sq, GQA groups 1 to 4, head dims 16 to
   128) and in fp32 (the CUDA-core kernel); decode at the llama, zamba2
   and qwen3-moe serving shapes in bf16, and at the llama shape in fp32
   and in fp32 over the bf16 cache, ragged lengths from 1 to S. At the
   llama, zamba2 and qwen3-moe (GQA group 8) prefill and decode shapes
   (model layout): the kernel's device time (torch.profiler) and its time
   by CUDA events around a loop, the plain version's and one library
   call's time beside the card's bound.
3. serve: ``run_serving("llama3.2-3b", batch=8, prompt_len=512, gen=32,
   smoke=False)`` at full width (28 layers, d_model 3072), with the
   kernels' launch counts read around exactly this run.
4. consistency: prefill of s tokens plus one decode step against a full
   forward over s+1 tokens, at full width in bf16.
5. profile: device time by kernel and the device's idle share for one
   prefill and a few decode steps at the serving shape; the prefill
   runs the tensor-core kernel once per layer and the scalar one never.
6. ssm_kernels: the SSD chunk kernels (one wrapper call, two launches)
   against their plain version at atol = rtol = 1e-4 on all three
   outputs (the mamba2 and zamba2 serving shapes, chunk 128, the reduced
   shape, two groups, three chunks, strided views as the model's, state
   and head widths below one mma tile, a chunk of one); at the mamba2 and
   zamba2 shapes also against the formula evaluated in fp64, at the same
   tolerance, over 9 draws each; the full scan ``ssd_scan_op`` against
   the sequential recurrence with an initial state and a ragged length,
   and the kernels' and the plain version's device times beside the bound
   at the mamba2 and zamba2 shapes.
7. serve_ssm: ``run_serving`` for mamba2-2.7b (64 Mamba2 blocks, d_model
   2560, 80 SSD heads of 64, state 128) and zamba2-2.7b (54 blocks and 9
   applications of the shared attention + MLP block) at full width, each
   with its launch counts read around exactly that run; then their
   consistency checks and a profile of the mamba2 prefill (one launch of
   each SSD kernel per block) and decode.
8. schedule_kernels: the feasibility kernel against its plain version,
   bit-exact (the seeds of tests/test_kernels.py, mask bits above 31, a
   strided aggregate table, fewer vertices than a thread takes, ragged
   vertex counts, 33 and 65 request rows, 1 and 8 types, agg rows 5 and 9
   apart, columns that start one vertex into their storage, a cluster the
   size of LLNL's Quartz), and the per-level aggregate sweep on the card
   against the same call on the CPU, at Quartz size; the kernel's, the
   plain version's and the sweep's device times beside the kernel's
   bound, and the time per call as the host launches them (the kernel's
   variants and other launch plans are timed by
   tools/feasibility_variants.py).
9. schedule: the scheduler slice's main path at Quartz size (3,018
   nodes of 2 sockets x 18 cores, 117,703 vertices): 512 jobs of a
   4,096-deep backlog matched and allocated in order, a kick every 64
   jobs (release the oldest 32, one ``feasible_roots_batch`` over the
   rest of the window), a 64-node grow and its shrink midway, all
   replayed in lockstep on a twin graph on the CPU that must agree.
10. train_kernels: the attention backward kernel (three launches of one
   ``flash_attention_bwd`` call: the row sums, then dK/dV and dQ on the
   tensor cores in bf16, on the CUDA cores in fp32) against
   ``ref_attention_bwd`` on the forward kernel's o and logsumexp, fp32 at
   1e-4 and bf16 at 2e-2 of each gradient's largest |value| and, in each
   64-row tile, at 1e-5 and 1e-2 of the tile's own norm (the training
   shape, the model's permuted views, GQA groups 1, 3 and 8, window 32,
   sq 72 < skv 200, head dims 16 / 64 / 80 / 128, ragged lengths,
   zamba2's shared block and qwen3-moe's attention (GQA group 8) at their
   training shapes), the forward's o and
   logsumexp against the plain ones, the autograd path of ``attention_op``
   against autograd through the plain forward; the backward's registers
   and spills (none may spill); its device time by kernel, the plain
   version's and the backward half of ``scaled_dot_product_attention``
   beside the bound at the llama and qwen3-moe training shapes.
11. train_consistency: reduced llama3.2-3b in fp32, three ``train_step``s
   on the card against the same steps on the CPU.
12. train: ``run_training("llama3.2-3b", smoke=False)`` at full width and
   depth (28 layers, d_model 3072, vocab 128256, remat on) at batch 2 x
   1024: a MATCHALLOCATE through the copied control plane, a grow, a
   shrink and a node failure with replacement, six AdamW steps; finite
   losses (the first within 1.0 of ln 128256), the events, exactly 56
   forward and 28 backward attention launches a step, ms a step, tokens/s,
   peak memory; then one step under the profiler, which must show 28
   launches of each bf16 backward kernel and none of the fp32 ones.
13. ssm_train_kernels: the SSD chunk forward kernel's y, states and
   decay against ``ref_ssd_chunk`` on each case below (and against the
   formula in fp64 at the two training shapes), then the backward kernel
   (five launches of one ``ssd_chunk_bwd`` call) against
   ``ref_ssd_chunk_bwd`` on all five gradients (the mamba2 and zamba2
   training shapes, chunk 128, the
   reduced shape, two groups, the model's strided views, a state of 10, a
   chunk of one): finite, within 1e-4 of each gradient's largest |value|
   of the plain version and of the formula in fp64, each (batch, chunk,
   head) tile within ``SSD_BWD_TILE_TOL`` of its own norm; the autograd
   path of ``ssd_scan_op`` against autograd through the recurrence; the
   backward's registers and spills (none may spill); its device time by
   kernel, the plain version's and the bound at the two training shapes.
14. train_consistency for reduced mamba2 and zamba2, as phase 11.
15. train for mamba2-2.7b (64 Mamba2 blocks) and zamba2-2.7b (54 blocks,
   9 applications of the shared attention block) at full width and depth
   as phase 12: exactly 128 forward and 64 backward SSD chunk launches a
   step for mamba2, 108 and 54 (and 18 and 9 of attention) for zamba2;
   then one mamba2 step under the profiler.
16. serve_moe: qwen3-moe-30b-a3b at full width (d_model 2048, 32 / 4
   heads of 128, 128 experts top-8 of d_ff 768, vocab 151936) with its
   depth cut to 16 of 48 layers (the fp32 masters and the bf16 serving
   copy of 48 would take 182 GB), through ``launch.serve.serve_model``
   (the body of ``run_serving``) at batch 8 x 512 + 32: exactly 16
   prefill and 496 decode attention launches, finite logits, the share
   of (token, k) pairs the capacity drops in prefill and in decode (read
   on the warm-up run, the same prompt and weights); then a profile of
   one prefill and one decode step.
17. moe_consistency: that model at b 2, s 256: prefill plus one decode
   step against a forward over s + 1 tokens under the dense oracle
   (``moe_impl="dense"``: the dispatch's drops differ between s and s + 1
   tokens) within 2e-2 of the largest logit in bf16, and the dispatch
   forward at a capacity factor of E / k (nothing drops) against the dense
   forward at every position within 2e-3 in fp32 (in bf16 the two paths'
   roundings move near-tied tokens to other experts, as in the JAX
   reference; that reading is printed unchecked).
18. moe_card_vs_cpu: the reduced qwen3-moe and llama4-maverick (an
   interleaved dense and MoE layer a group, a shared expert) in fp32 with
   the capacity dispatch (pairs drop at these sizes): a forward, a
   prefill and three decode steps on the card and on the CPU; every MoE
   call keeps the same pairs, and the logits agree within 2e-3 of the
   largest.
19. moe_train_consistency: those two configs trained on the card and on
   the CPU from the same weights and batches, every MoE call of a checked
   step keeping the same pairs on both: qwen3-moe three AdamW steps, losses
   and parameters within 1e-4; llama4-maverick one Adafactor step, the
   loss and every parameter but its top-1 router within 1e-4, the router's
   gradient rounding noise (below 1e-6 of the largest) on both, two more
   steps' losses printed unchecked (the noise moves the router).
20. train_moe: ``run_training("qwen3-moe-30b-a3b", smoke=False,
   n_layers=5)`` at full width (as phase 16) with its depth cut to 5 of 48
   layers (the fp32 masters, gradients and AdamW moments of more do not
   fit the card), remat on, at batch 2 x 1024, through the same events as
   phase 12: exactly 10 forward and 5 backward attention launches a step,
   finite losses (the first within 1.0 of ln 151936), peak memory; then,
   unchecked, ms a step, tokens/s, the share of (token, k) pairs the
   capacity drops in one step's forward, and whether one step's gradients
   computed twice are bit-identical (checked: remat's recomputed forward
   keeps the forward's pairs); then one step under the profiler.

Then the kernel table as one JSON line, the card's name and power limit
as ``nvidia-smi`` prints them, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. Without a card, or without the
repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
FP32_FLOPS = 67e12               # fp32 outside the tensor cores
TF32_FLOPS = 495e12              # dense TF32 tensor-core peak; fp32-accurate 3xTF32 takes 3 passes
# atol = rtol, as in tests/test_kernels.py:32: in bf16 the output itself is
# rounded to bf16 (8 bits of mantissa); in fp32 only the order of the sums
# differs between the kernel and the plain version
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the SSD scan's tolerance, tests/test_kernels.py:79-81: fp32 on both sides,
# which differ in the order of the sums of the three products; the same
# tolerance against the formula evaluated in fp64 at the serving shapes
SSD_TOL = 1e-4
ARCH = "llama3.2-3b"
# flash_decode cases: name, (b, h, kvh, S, d), q dtype, cache dtype, timed. The
# serving shapes of llama3.2-3b, zamba2-2.7b and qwen3-moe-30b-a3b at batch 8
# (S: 512 + 32 and 512 + 8 cache slots, neither a multiple of the 64-key
# tile); fp32 over fp32,
# and fp32 q over the bf16 cache as the fp32 configs decode
DECODE_CASES = [
    ("serve", (8, 24, 8, 544, 128), "bfloat16", "bfloat16", True),
    ("serve_fp32", (8, 24, 8, 544, 128), "float32", "float32", False),
    ("serve_fp32_bf16_cache", (8, 24, 8, 544, 128), "float32", "bfloat16", False),
    ("zamba2", (8, 32, 32, 520, 80), "bfloat16", "bfloat16", True),
    ("qwen3", (8, 32, 4, 544, 128), "bfloat16", "bfloat16", True),     # GQA group 8
]
# the decode kernel's instantiations: 3 dtype pairs x 5 head dims x G 1, 2, 3, 4, 8
DECODE_INSTANTIATIONS = 75
# flash_attention cases timed: the llama3.2-3b, zamba2-2.7b and qwen3-moe prefill shapes
FA_TIMED = ("serve", "zamba2", "qwen3")
FEASIBILITY_INSTANTIATIONS = 1     # feasible_kernel
SERVE = dict(batch=8, prompt_len=512, gen=32)
# full-width depths, checked against each config before its run
DEPTH = {"llama3.2-3b": (28, 3072), "mamba2-2.7b": (64, 2560), "zamba2-2.7b": (54, 2560),
         "qwen3-moe-30b-a3b": (48, 2048)}
SSM_GEN = {"mamba2-2.7b": 32, "zamba2-2.7b": 8}
# LLNL Quartz, a production system that Fluxion schedules: 3,018 nodes of
# two 18-core Xeon E5-2695 v4 sockets
QUARTZ = dict(nodes=3018, sockets_per_node=2, cores_per_socket=18)
QUARTZ_VERTICES = 117_703      # 1 + 3018 * (1 + 2 * (1 + 18)): cluster, nodes, sockets, cores
BACKLOG, JOBS, KICK, RELEASE = 4096, 512, 64, 32     # window depth, jobs run, per kick
GROW_AT, SHRINK_AT, GROW_NODES = 256, 320, 64
# distinct compiled request shapes in that backlog: the two-node job
# compiles to the per-node shape of the one-node 2-socket x 16-core job
BACKLOG_SHAPES = 6


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


def device_ms(fn, iters: int = 100) -> float:
    """Device time per call of ``fn``: the self device time of every kernel
    and copy it launches under torch.profiler over ``iters`` calls, each
    kernel's mean duration times its launches per call. For a call of a
    few microseconds, CUDA events around a loop (``time_ms``) time the
    host's launch rate instead: the device waits between launches while
    the wrapper checks its arguments. The profiler now and then drops a
    record: a kernel's launches per call are its record count over
    ``iters`` rounded to a whole number (the fraction where that rounds
    to 0, a kernel launched on some calls only), so a dropped record does
    not cut the sum."""
    import torch
    fn()
    torch.cuda.synchronize()
    _, rows, _ = profiled(lambda: [fn() for _ in range(iters)])
    return sum(ms / n * (round(n / iters) or n / iters) for ms, n, _ in rows)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list:
    """Registers, stack frame and spill bytes of each kernel in an ``nvcc
    -Xptxas -v`` log, by its mangled name (which holds its template
    arguments)."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and cur is not None:
            cur["stack"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def decode_ptxas(rows: list) -> list:
    """The ptxas rows of ``flash_decode_kernel<TQ, TKV, D, G>``, each with
    its template arguments read from the mangled name."""
    types = {"ff": "fp32/fp32", "f13__nv_bfloat16": "fp32/bf16",
             "13__nv_bfloat16S1_": "bf16/bf16"}
    out = []
    for r in rows:
        m = re.search(r"flash_decode_kernelI(\w+?)Li(\d+)ELi(\d+)E", r["kernel"])
        if m:
            out.append({"dtypes": types.get(m.group(1), m.group(1)), "d": int(m.group(2)),
                        "G": int(m.group(3)), "registers": r.get("registers"),
                        "spill_stores": r.get("spill_stores", 0),
                        "spill_loads": r.get("spill_loads", 0)})
    return out


def compare(out, ref, dtype: str, tol: float = None) -> float:
    tol = TOL[dtype] if tol is None else tol
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bad = (diff > tol + tol * ref.float().abs()).sum().item()
    check(out.shape == ref.shape and math.isfinite(err) and bad == 0,
          f"{bad} elements beyond atol=rtol={tol} (max |diff| {err})")
    return err


# ---------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------- #
def phase_kernels(dev) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import decode_plan, flash_attention, flash_decode
    from repro_torch.kernels.ref import ref_attention, ref_decode

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            getattr(torch, dtype))

    # ---- flash_attention (prefill): bf16 on the tensor cores, fp32 on the CUDA cores ----
    cases = [  # name, b, h, kvh, sq, skv, d, window, dtype, layout; timed: FA_TIMED
        # bshd: permuted [b, s, h, d] views, as models/layers.py::attention passes them
        ("serve", 8, 24, 8, 512, 512, 128, 0, "bfloat16", "bshd"),
        ("serve_bhsd", 8, 24, 8, 512, 512, 128, 0, "bfloat16", "bhsd"),
        ("zamba2", 8, 32, 32, 512, 512, 80, 0, "bfloat16", "bshd"),
        ("serve_fp32", 8, 24, 8, 512, 512, 128, 0, "float32", "bhsd"),
        ("window", 2, 24, 8, 512, 512, 128, 128, "bfloat16", "bhsd"),
        ("window32_bf16", 2, 8, 2, 256, 256, 64, 32, "bfloat16", "bshd"),
        ("window_fp32", 2, 8, 2, 256, 256, 64, 32, "float32", "bhsd"),
        ("ragged", 2, 24, 8, 200, 200, 128, 0, "bfloat16", "bhsd"),
        ("ragged_fp32", 2, 24, 8, 200, 200, 128, 0, "float32", "bhsd"),
        ("offset_q", 2, 6, 2, 72, 200, 32, 0, "float32", "bhsd"),
        ("offset_q_bf16", 2, 6, 2, 72, 200, 32, 0, "bfloat16", "bshd"),
        ("gqa3_d32_bf16", 2, 6, 2, 256, 256, 32, 0, "bfloat16", "bhsd"),
        ("d64_bf16", 2, 8, 2, 256, 256, 64, 0, "bfloat16", "bshd"),
        ("d16", 2, 4, 2, 256, 256, 16, 0, "float32", "bhsd"),
        ("d16_bf16", 2, 4, 2, 256, 256, 16, 0, "bfloat16", "bhsd"),
        ("d80", 2, 32, 32, 192, 192, 80, 0, "bfloat16", "bhsd"),
        ("d80_ragged_bf16", 2, 32, 32, 200, 200, 80, 0, "bfloat16", "bshd"),
        ("qwen3", 8, 32, 4, 512, 512, 128, 0, "bfloat16", "bshd"),      # GQA group 8
    ]
    fa = {}
    for name, b, h, kvh, sq, skv, d, window, dtype, layout in cases:
        if layout == "bshd":
            q = randn(b, sq, h, d, dtype=dtype).permute(0, 2, 1, 3)
            k = randn(b, skv, kvh, d, dtype=dtype).permute(0, 2, 1, 3)
            v = randn(b, skv, kvh, d, dtype=dtype).permute(0, 2, 1, 3)
        else:
            q = randn(b, h, sq, d, dtype=dtype)
            k = randn(b, kvh, skv, d, dtype=dtype)
            v = randn(b, kvh, skv, d, dtype=dtype)
        out = flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        ref = ref_attention(q, k, v, window=window)
        err = compare(out, ref, dtype)
        emit("kernels", kernel="flash_attention", case=name, shape=[b, h, kvh, sq, skv, d],
             window=window, dtype=dtype, layout=layout, max_abs_err=err, tol=TOL[dtype])
        if name in FA_TIMED:
            ms = device_ms(lambda: flash_attention(q, k, v), iters=20)
            event_ms = time_ms(lambda: flash_attention(q, k, v))
            plain_ms = device_ms(lambda: ref_attention(q, k, v), iters=5)
            g = h // kvh
            ke, ve = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
            lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
                q, ke, ve, is_causal=True), iters=20)
            pairs = sq * (sq + 1) // 2                    # causal (q, k) pairs per head
            flops = 4.0 * d * pairs * b * h
            nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
            t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
            timed = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=1e3 * max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         event_ms=event_ms)
            if name == "serve":
                fa = timed
            else:
                fa[name] = timed
            emit("kernels", kernel="flash_attention", case=name, ms=ms, event_ms=event_ms,
                 plain_ms=plain_ms, library_ms=lib_ms, bound_ms=timed["bound_ms"],
                 bound_by=timed["bound_by"], tflops=flops / ms / 1e9)
        del q, k, v, out, ref

    # ---- flash_decode, through the model's [b, S, kvh, d] cache layout ----
    fd = {}
    for name, (b, h, kvh, S, d), dtype, cache_dtype, timed in DECODE_CASES:
        copies = 4 if timed else 1  # rotate caches larger than the 50 MB L2: each launch reads cold
        q = randn(b, 1, h, d, dtype=dtype).permute(0, 2, 1, 3)
        caches = [(randn(b, S, kvh, d, dtype=cache_dtype), randn(b, S, kvh, d, dtype=cache_dtype))
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
        plan = decode_plan(b, kvh, S, torch.cuda.get_device_properties(dev).multi_processor_count)
        emit("kernels", kernel="flash_decode", case=name, shape=[b, h, kvh, S, d], dtype=dtype,
             cache_dtype=cache_dtype, split_plan=plan, lengths=lengths.tolist(),
             max_abs_err=err, tol=TOL[dtype])
        if not timed:
            continue
        it = iter(range(1 << 30))
        ms = device_ms(lambda: flash_decode(q, *views[next(it) % copies], lengths))
        event_ms = time_ms(lambda: flash_decode(q, *views[next(it) % copies], lengths))
        plain_ms = device_ms(lambda: ref_decode(q, *views[next(it) % copies], lengths), iters=20)
        g = h // kvh
        expanded = [(kv.repeat_interleave(g, dim=1), vv.repeat_interleave(g, dim=1))
                    for kv, vv in views]
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None])[:, None, None, :]
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, *expanded[next(it) % copies], attn_mask=mask))
        ctx = int(lengths.sum().item())                   # keys actually attended
        nbytes = 2.0 * 2 * kvh * ctx * d + 2.0 * 2 * q.numel() + 4 * b
        flops = 4.0 * h * d * ctx
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bound_ms=1e3 * max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes", event_ms=event_ms)
        emit("kernels", kernel="flash_decode", case=name, ms=ms, event_ms=event_ms,
             plain_ms=plain_ms, library_ms=lib_ms, bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], gbps=nbytes / ms / 1e6)
        if name == "serve":
            fd = row
        else:
            fd[name] = row
        del expanded
    return {"flash_attention": fa, "flash_decode": fd}


# ---------------------------------------------------------------------- #
# phases 3 and 7: the serving paths
# ---------------------------------------------------------------------- #
def expected_launches(cfg, gen: int) -> dict:
    """Launches of one serving run: prefill attention per attention block
    (every layer of a dense or MoE model, each application of a hybrid's
    shared block), decode attention per attention block and step, one SSD chunk
    launch per Mamba2 block."""
    attn = {"dense": cfg.n_layers, "moe": cfg.n_layers, "ssm": 0,
            "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1)}[cfg.family]
    ssd = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    return {"flash_attention": attn, "flash_decode": attn * (gen - 1), "ssd_chunk": ssd}


def phase_serve(dev, arch: str, batch: int, prompt_len: int, gen: int,
                phase: str = "serve") -> dict:
    """One ``run_serving`` at full width after a short warm-up, with the
    launch counts read around exactly this run: each kernel launches
    exactly as often as ``expected_launches`` says (the scheduler's
    kernel not at all)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import run_serving

    cfg = get_config(arch)
    check((cfg.n_layers, cfg.d_model) == DEPTH[arch], f"{arch}: full-width config")
    expect = expected_launches(cfg, gen)
    # warm-up (cuBLAS handles and algorithms, the allocator): one short run
    run_serving(arch, batch=batch, prompt_len=prompt_len, gen=2, smoke=False, seed=0, device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = run_serving(arch, batch=batch, prompt_len=prompt_len, gen=gen, smoke=False, seed=0,
                    device=dev)
    launches = dict(LAUNCHES)
    steps = gen - 1
    emit(phase, arch=arch, batch=batch, prompt_len=prompt_len, gen=gen,
         n_layers=cfg.n_layers, d_model=cfg.d_model, n_params=cfg.n_params(),
         prefill_ms=1e3 * r["prefill_s"], decode_ms_per_step=1e3 * r["decode_s"] / steps,
         decode_tokens_per_s=batch * steps / r["decode_s"],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, expected_launches=expect, logits_finite=r["logits_finite"],
         sample_tokens=r["tokens"][0, :8].tolist())
    for name, n in launches.items():
        check(n == expect.get(name, 0), f"{arch}: {name} launches {n} != {expect.get(name, 0)}")
    check(r["logits_finite"], f"{arch}: non-finite logits")
    check(r["tokens"].shape == (batch, gen), f"{arch}: token shape")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------- #
# phase 4: prefill + decode == forward, at full width
# ---------------------------------------------------------------------- #
def consistency_tol(cfg) -> float:
    """Of the largest logit. In bf16 the two paths see the same weights and
    inputs and differ in the order of sums (kernels, matmul shapes) and in
    where bf16 rounds: 2e-2. A model with Mamba2 blocks also rounds its
    causal conv differently on the two paths, as the JAX model does (the
    prefill adds the four taps in bf16, the decode sums them in one
    einsum; tests/test_torch_mamba.py shows the gap closes without that),
    and the gap grows with depth: 5e-2. In fp32 only the order of sums
    differs (the chunked scan against the recurrence): 2e-3, the fp32
    test's tolerance (tests/test_models_smoke.py:53-88)."""
    if cfg.dtype == "float32":
        return 2e-3
    return 5e-2 if cfg.family in ("ssm", "hybrid") else 2e-2


def phase_consistency(dev, arch: str, dtype: str = "bfloat16"):
    import dataclasses

    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.model import make_model

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    check((cfg.n_layers, cfg.d_model) == DEPTH[arch], f"{arch}: full-width config")
    model = make_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(1))
    b, s = 2, 256
    toks = torch.randint(0, cfg.vocab, (b, s + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    full = model.forward_logits(toks)[:, -1].float()
    _, cache = model.prefill_step(toks[:, :s])
    # one more slot on the KV caches' sequence axis; SSM states keep their shapes
    cache = {k: F.pad(v, (0, 0, 0, 0, 0, 1)) if k in ("k", "v", "shared_k", "shared_v")
             else v for k, v in cache.items()}
    logits, _ = model.serve_step(cache, toks[:, s:], s)
    diff = (logits[:, 0].float() - full).abs().max().item()
    scale = full.abs().max().item()
    tol = consistency_tol(cfg)
    emit("consistency", arch=arch, dtype=dtype, batch=b, seq=s, max_abs_diff=diff,
         max_abs_logit=scale, rel=diff / scale, tol_rel=tol)
    check(math.isfinite(diff) and diff <= tol * scale,
          f"{arch} {dtype}: prefill+decode vs forward: {diff} > {tol} * {scale}")
    return model


# ---------------------------------------------------------------------- #
# phase 5: where the time of the serving shape goes (torch.profiler)
# ---------------------------------------------------------------------- #
def profiled(fn):
    """Run ``fn`` once under torch.profiler. Returns the host wall ms (to a
    synchronize) and the device rows and host rows as (ms, calls, name),
    largest first: kernels and copies by self device time, host ops by
    self CPU time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev_rows, host_rows = [], []
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = evt.self_cuda_time_total
            dev_rows.append((dev_us / 1e3, evt.count, evt.key[:60]))
        else:
            host_rows.append((evt.self_cpu_time_total / 1e3, evt.count, evt.key[:60]))
    return wall_ms, sorted(dev_rows, reverse=True), sorted(host_rows, reverse=True)


def phase_profile(dev, model, steps: int = 4) -> None:
    """Device time by kernel and the device's idle share, for one prefill
    and a few decode steps at the serving shape (launch counts are read
    before this phase)."""
    import torch

    from repro_torch.launch.serve import splice_cache
    from repro_torch.models.config import ShapeConfig

    b, s = SERVE["batch"], SERVE["prompt_len"]
    toks = torch.randint(0, model.cfg.vocab, (b, s), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(3))
    cache = model.init_cache(ShapeConfig("serve", s + steps, b, "decode"))

    def prefill():
        logits, pc = model.prefill_step(toks)
        splice_cache(cache, pc)
        return logits[:, -1].argmax(-1, keepdim=True)

    def decode(tok):
        for i in range(steps):
            logits, _ = model.serve_step(cache, tok, s + i)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return tok

    tok = prefill()
    torch.cuda.synchronize()
    attn = expected_launches(model.cfg, 1)["flash_attention"]
    for name, fn in (("prefill", prefill), ("decode", lambda: decode(tok))):
        wall_ms, rows, _ = profiled(fn)
        busy_ms = sum(r[0] for r in rows)
        if name == "prefill" and model.cfg.family == "ssm":
            # one ssd_chunk call per Mamba2 block: one launch of each SSD kernel
            n = {k: sum(c for _, c, key in rows if k in key) for k in SSD_KERNELS}
            check(all(c == model.cfg.n_layers for c in n.values()),
                  f"{model.cfg.name} prefill profile: {n} for {model.cfg.n_layers} blocks")
        if name == "prefill" and attn and model.cfg.dtype == "bfloat16":
            # bf16 prefill attention runs on the tensor cores, never the scalar kernel
            mma = sum(n for _, n, k in rows if "flash_fwd_mma_kernel" in k)
            scalar = sum(n for _, n, k in rows if "flash_fwd_kernel" in k)
            check(mma == attn and scalar == 0, f"{model.cfg.name} prefill profile: "
                  f"{mma} flash_fwd_mma_kernel, {scalar} flash_fwd_kernel for {attn} blocks")
        emit("profile", arch=model.cfg.name, n_layers=model.cfg.n_layers, part=name, batch=b,
             prompt_len=s, decode_steps=steps if name == "decode" else 0, wall_ms=wall_ms,
             device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
             by_class=kernel_classes(rows),
             top=[{"op": k, "ms": ms, "calls": n} for ms, n, k in rows[:12]])


# ---------------------------------------------------------------------- #
# phase 6: the SSD chunk kernel against its plain version
# ---------------------------------------------------------------------- #
SSD_SERVE = (8, 512, 80, 64, 1, 128, 256)       # mamba2-2.7b at batch 8 x 512: b, s, H, P, G, N, Q
SSD_CASES = [  # name, (b, s, H, P, G, N, chunk), strided; timed at the serving shapes
    ("mamba2", SSD_SERVE, False),
    ("zamba2", (8, 512, 80, 64, 1, 64, 256), False),
    ("chunk128", (8, 512, 80, 64, 1, 128, 128), False),   # the configs' perf patch
    ("reduced", (2, 32, 8, 16, 1, 16, 8), False),
    ("groups2", (2, 128, 4, 32, 2, 16, 32), False),
    ("chunks3", (2, 768, 80, 64, 1, 128, 256), False),    # not a power of two
    ("strided", SSD_SERVE, True),
    ("narrow", (2, 128, 8, 12, 2, 12, 32), True),          # N, P below one mma tile
    ("state10", (1, 64, 4, 8, 1, 10, 16), True),           # 4-byte copies of B and C
    ("chunk1", (1, 16, 4, 16, 1, 8, 1), False),
]
SSD_TIMED = ("mamba2", "zamba2")
SSD_SEEDS = range(100, 108)   # further draws at the timed shapes, for the margin
SSD_KERNELS = ("ssd_scores_kernel", "ssd_chunk_kernel")   # the launches of one call
SSD_SCAN = (2, 200, 16, 64, 1, 128, 64)         # ragged: 200 = 3 chunks of 64 + 8


def ssd_inputs(gen, dev, b, s, H, P, G, N):
    """x, dt, A, B, C as ``_ssd_inputs`` of tests/test_kernels.py draws
    them: dt = softplus(normal), A = -exp(0.3 normal)."""
    import torch
    import torch.nn.functional as F

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return (randn(b, s, H, P), F.softplus(randn(b, s, H)), -torch.exp(0.3 * randn(H)),
            randn(b, s, G, N), randn(b, s, G, N))


def model_views(x, dt, B, C):
    """x, dt, B and C as strided views, as the model passes them: x, B and
    C into one [b, s, H*P + 2*G*N] projection (its conv output), dt into a
    wider one."""
    import torch
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    wide = torch.cat([x.reshape(b, s, -1), B.reshape(b, s, -1), C.reshape(b, s, -1)], -1)
    views = (wide[..., :H * P].reshape(b, s, H, P), torch.cat([dt, dt], -1)[..., :H],
             wide[..., H * P:H * P + G * N].reshape(b, s, G, N),
             wide[..., H * P + G * N:].reshape(b, s, G, N))
    check(not any(t.is_contiguous() for t in views[:3]), "views")
    return views


def tol_share(out, ref) -> float:
    """The largest |out - ref| / (atol + rtol |ref|) at ``SSD_TOL``, in
    fp64: the share of the tolerance used, at most 1 inside it."""
    r = ref.double()
    return ((out.double() - r).abs() / (SSD_TOL + SSD_TOL * r.abs())).max().item()


def ssd_exact_shares(out, x, dt, A, B, C, Q) -> list:
    """The kernels' share of the tolerance on y, states and decay against
    the formula evaluated in fp64 (``ref_ssd_chunk(exact=True)``); fails
    beyond it."""
    from repro_torch.kernels.ref import ref_ssd_chunk

    exact = ref_ssd_chunk(x, dt, A, B, C, Q, exact=True)
    share = [tol_share(o, r) for o, r in zip(out, exact)]
    check(all(math.isfinite(v) and v <= 1.0 for v in share),
          f"ssd_chunk against fp64: shares {share} of atol=rtol={SSD_TOL}")
    return share


def phase_ssm_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels.ops import ssd_scan_op
    from repro_torch.kernels.ref import ref_ssd, ref_ssd_chunk
    from repro_torch.kernels.ssd_scan import ssd_chunk

    gen = torch.Generator(device=dev).manual_seed(4)
    timed = {}
    for name, (b, s, H, P, G, N, Q), strided in SSD_CASES:
        x, dt, A, B, C = ssd_inputs(gen, dev, b, s, H, P, G, N)
        if strided:
            x, dt, B, C = model_views(x, dt, B, C)
        out = ssd_chunk(x, dt, A, B, C, Q)
        torch.cuda.synchronize()
        ref = ref_ssd_chunk(x, dt, A, B, C, Q)
        errs = [compare(o, r, "float32", SSD_TOL) for o, r in zip(out, ref)]
        share = [tol_share(o, r) for o, r in zip(out, ref)]
        exact = {}
        if name in SSD_TIMED:
            exact = ssd_exact_shares(out, x, dt, A, B, C, Q)
            exact = {"exact_tol_share": dict(zip(("y", "states", "decay"), exact))}
        emit("ssm_kernels", kernel="ssd_chunk", case=name, shape=[b, s, H, P, G, N, Q],
             strided=strided, max_abs_err={"y": errs[0], "states": errs[1], "decay": errs[2]},
             tol_share={"y": share[0], "states": share[1], "decay": share[2]}, **exact,
             max_abs_ref=[r.abs().max().item() for r in ref], tol=SSD_TOL)
        del out, ref
        if name in SSD_TIMED:
            row, counts = ssd_timing(x, dt, A, B, C, Q)
            emit("ssm_kernels", kernel="ssd_chunk", case=name, **row, **counts)
            timed[name] = dict(max_abs_err=max(errs), **row)
        del x, dt, A, B, C

    # the serving shapes' margin over fresh inputs: the share of the
    # tolerance each seed's y and states use, against the plain version and
    # against the formula in fp64
    for name, (b, s, H, P, G, N, Q), _ in SSD_CASES:
        if name not in SSD_TIMED:
            continue
        shares, exact = [], []
        for seed in SSD_SEEDS:
            inputs = ssd_inputs(torch.Generator(device=dev).manual_seed(seed), dev,
                                b, s, H, P, G, N)
            out = ssd_chunk(*inputs, Q)
            torch.cuda.synchronize()
            ref = ref_ssd_chunk(*inputs, Q)
            for o, r in zip(out, ref):
                compare(o, r, "float32", SSD_TOL)
            shares.append([tol_share(o, r) for o, r in zip(out[:2], ref[:2])])
            exact.append(ssd_exact_shares(out, *inputs, Q)[:2])
            del inputs, out, ref
        emit("ssm_kernels", kernel="ssd_chunk", case=f"{name}_seeds", seeds=list(SSD_SEEDS),
             tol_share={"y": [v[0] for v in shares], "states": [v[1] for v in shares]},
             max_tol_share={"y": max(v[0] for v in shares),
                            "states": max(v[1] for v in shares)},
             exact_tol_share={"y": [v[0] for v in exact], "states": [v[1] for v in exact]},
             max_exact_tol_share={"y": max(v[0] for v in exact),
                                  "states": max(v[1] for v in exact)}, tol=SSD_TOL)

    # the whole scan (kernel + inter-chunk carry) against the recurrence,
    # from an initial state, over a length that is not a chunk multiple
    b, s, H, P, G, N, Q = SSD_SCAN
    x, dt, A, B, C = ssd_inputs(gen, dev, b, s, H, P, G, N)
    h0 = torch.randn((b, H, P, N), generator=gen, device=dev)
    y, h = ssd_scan_op(x, dt, A, B, C, Q, initial_state=h0, return_state=True)
    torch.cuda.synchronize()
    ry, rh = ref_ssd(x, dt, A, B, C, initial_state=h0, return_state=True)
    emit("ssm_kernels", kernel="ssd_scan_op", case="ragged_init", shape=[b, s, H, P, G, N, Q],
         max_abs_err={"y": compare(y, ry, "float32", SSD_TOL),
                      "final_state": compare(h, rh, "float32", SSD_TOL)}, tol=SSD_TOL)
    # the table's row is the mamba2 shape's, with zamba2's beside it
    return dict(timed["mamba2"], zamba2=timed["zamba2"])


def ssd_bytes(b, s, H, P, G, N, Q) -> float:
    """Bytes of ``ssd_chunk``'s inputs and outputs, each counted once."""
    return 4.0 * (2 * b * s * H * P + b * s * H + H + 2 * b * s * G * N
                  + b * (s // Q) * H * (N * P + 1))


def ssd_bound(b, s, H, P, G, N, Q):
    """(ms, by, gflop, mbytes) of the least time for ``ssd_chunk``'s work:
    C B^T once per (batch, chunk, group) and the two products per head,
    causal half only, at the fastest fp32-accurate rate (3xTF32: three TF32
    passes), against each input read once and each output written once."""
    nc = s // Q
    tri = Q * (Q + 1) / 2
    flops = b * nc * (G * tri * N * 2.0 + H * (tri * P * 2.0 + Q * N * P * 2.0))
    nbytes = ssd_bytes(b, s, H, P, G, N, Q)
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops / 1e9, nbytes / 1e6)


def ssd_bound_pr13(b, s, H, P, G, N, Q):
    """The bound as first counted for the port's kernel (``bound_ms_pr13``):
    every head computing its own C B^T, on the fp32 CUDA cores."""
    flops = b * (s // Q) * H * (2.0 * Q * (Q + 1) / 2 * (N + P) + 2.0 * Q * N * P)
    return 1e3 * max(flops / FP32_FLOPS, ssd_bytes(b, s, H, P, G, N, Q) / HBM_BYTES_PER_S)


def ssd_timing(x, dt, A, B, C, Q):
    """(row, counts): the device time of one ``ssd_chunk`` call (both
    launches, and each kernel's), the CUDA-event time of the call and the
    plain version's device time, beside the bound; then what is counted
    and not measured (the work, ``bound_ms_pr13``) and the rate."""
    from repro_torch.kernels.ref import ref_ssd_chunk
    from repro_torch.kernels.ssd_scan import ssd_chunk

    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    _, rows, _ = profiled(lambda: [ssd_chunk(x, dt, A, B, C, Q) for _ in range(20)])
    per_kernel = {k: sum(ms for ms, _, key in rows if k in key) / 20 for k in SSD_KERNELS}
    ms = device_ms(lambda: ssd_chunk(x, dt, A, B, C, Q), iters=20)
    bound, by, gflop, mbytes = ssd_bound(b, s, H, P, G, N, Q)
    row = dict(ms=ms, kernel_ms=per_kernel, event_ms=time_ms(lambda: ssd_chunk(x, dt, A, B, C, Q)),
               plain_ms=device_ms(lambda: ref_ssd_chunk(x, dt, A, B, C, Q), iters=5),
               library_ms=None, bound_ms=bound, bound_by=by)
    return row, dict(bound_ms_pr13=ssd_bound_pr13(b, s, H, P, G, N, Q), gflop=gflop,
                     mbytes=mbytes, tflops=gflop / ms)


# ---------------------------------------------------------------------- #
# phase 8: the scheduler slice's kernel and sweep against their plain versions
# ---------------------------------------------------------------------- #
def feasibility_args(dev, seed, n_req, n_vert, n_types, bits=(), width=None, offset=0):
    """``feasibility_case`` as tensors on ``dev``: agg as the [:, :T] view
    of a table ``width`` columns wide, and with ``offset`` 1 every vertex
    column and agg the [1:] view of one vertex more."""
    import torch
    args = [torch.from_numpy(a).to(dev)
            for a in feasibility_case(seed, n_req, n_vert + offset, n_types, bits)]
    if width and width != n_types:
        wide = torch.zeros((n_vert + offset, width), dtype=torch.int32, device=dev)
        wide[:, :n_types] = args[4]
        args[4] = wide[:, :n_types]
    args[:5] = [t[offset:] for t in args[:5]]
    return args


def feasibility_case(seed, n_req, n_vert, n_types=5, extra_bits=()):
    """Random request/vertex tables in the draw order of the
    ``_feasibility_case`` of tests/test_kernels.py (every clause: type
    mismatch, busy vertices, size floors, property bits on both sides of
    bit 31, per-type aggregates), plus a random bit at each of
    ``extra_bits`` in both property masks."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vtype = rng.integers(0, n_types, n_vert, dtype=np.int32)
    vok = rng.integers(0, 2, n_vert, dtype=np.int32).astype(np.uint8)
    vsize = rng.integers(1, 64, n_vert, dtype=np.int32)
    vmask = (rng.integers(0, 2, n_vert, dtype=np.int64) << 40
             | rng.integers(0, 8, n_vert, dtype=np.int64))
    agg = rng.integers(0, 16, (n_vert, n_types), dtype=np.int32)
    tid = rng.integers(0, n_types, n_req, dtype=np.int32)
    msize = rng.integers(1, 48, n_req, dtype=np.int32)
    rmask = (rng.integers(0, 2, n_req, dtype=np.int64) << 40
             | rng.integers(0, 4, n_req, dtype=np.int64))
    need = rng.integers(0, 12, (n_req, n_types), dtype=np.int32)
    for bit in extra_bits:
        vmask |= rng.integers(0, 2, n_vert, dtype=np.int64) << bit
        rmask |= rng.integers(0, 2, n_req, dtype=np.int64) << bit
    return [vtype, vok, vsize, vmask, agg, tid, msize, rmask, need]


def quartz_tree():
    """Parent column, levels and type ids of ``build_cluster(**QUARTZ)``,
    in its vertex order, made with numpy (no dict graph)."""
    import numpy as np
    nodes, spn, cps = QUARTZ["nodes"], QUARTZ["sockets_per_node"], QUARTZ["cores_per_socket"]
    per_node = 1 + spn * (1 + cps)
    node = 1 + per_node * np.arange(nodes)
    sock = (node[:, None] + 1 + (1 + cps) * np.arange(spn)[None, :]).ravel()
    core = (sock[:, None] + 1 + np.arange(cps)[None, :]).ravel()
    parent = np.full(QUARTZ_VERTICES, -1, np.int32)
    parent[node] = 0
    parent[sock] = np.repeat(node, spn)
    parent[core] = np.repeat(sock, cps)
    type_id = np.zeros(QUARTZ_VERTICES, np.int32)
    type_id[node], type_id[sock], type_id[core] = 1, 2, 3
    levels = [np.zeros(1, np.int64), node, sock, core]
    return parent, levels, type_id


def phase_schedule_kernels(dev) -> dict:
    """The feasibility kernel against ``ref_feasible`` (bit-exact) and the
    aggregate sweep on the card against the CPU, then their times at
    Quartz size."""
    import numpy as np
    import torch
    from repro_torch.core.flatgraph import aggregate_sweep
    from repro_torch.kernels.feasibility import feasible_mask
    from repro_torch.kernels.ref import ref_feasible

    cases = [  # name, seed, n_req, n_vert, n_types, extra mask bits, agg row width, offset
        ("seed0", 0, 11, 300, 5, (), 5, 0), ("seed1", 1, 8, 256, 5, (), 5, 0),
        ("seed2", 2, 1, 33, 5, (), 5, 0), ("seed3", 3, 40, 1024, 5, (), 5, 0),
        ("seed4", 4, 13, 97, 5, (), 5, 0), ("bit61", 5, 9, 200, 5, (61,), 5, 0),
        ("strided", 6, 7, 4096, 5, (), 9, 0),
        # the launch plan's edges: fewer vertices than one thread's VPT, a
        # ragged tail (and rows that start inside a 16-byte piece), a second
        # and third block of request rows, one and eight types (per-element
        # agg loads), agg rows 5 and 9 apart, and columns that start one
        # vertex into their storage ([1:] views: per-element loads)
        ("v3", 35, 6, 3, 4, (), 4, 0), ("v1025", 10, 6, 1025, 4, (), 4, 0),
        ("u33", 11, 33, 1025, 4, (), 4, 0), ("u65", 12, 65, 517, 4, (), 4, 0),
        ("t1", 12, 6, 1025, 1, (), 1, 0), ("t8", 11, 9, 1025, 8, (), 8, 0),
        ("stride5", 10, 6, 1025, 4, (), 5, 0), ("offset", 10, 33, 1025, 4, (), 4, 1),
        ("offset_t5", 15, 9, 300, 5, (), 9, 1),
        # the main path's shape: the backlog's distinct request shapes
        # against 4 resource types (cluster, node, socket, core)
        ("quartz", 7, BACKLOG_SHAPES, QUARTZ_VERTICES, 4, (), 4, 0),
    ]
    for name, seed, n_req, n_vert, n_types, bits, width, offset in cases:
        args = feasibility_args(dev, seed, n_req, n_vert, n_types, bits, width, offset)
        out = feasible_mask(*args)
        torch.cuda.synchronize()
        ref = ref_feasible(*args)
        mismatches = int((out != ref).sum().item())
        emit("schedule_kernels", kernel="feasibility", case=name, shape=[n_req, n_vert, n_types],
             agg_row_stride=args[4].stride(0), offset=offset,
             feasible=int(ref.sum().item()), mismatches=mismatches, tol=0)
        check(mismatches == 0 and out.shape == ref.shape,
              f"feasibility {name}: {mismatches} elements differ from ref_feasible")

    # times at Quartz size; 16 copies of the inputs (16 x 4.6 MB > the
    # 50 MB L2), rotated, so that each launch reads from device memory
    # as a launch after a fresh host-to-device copy of the columns would
    U, V, T = BACKLOG_SHAPES, QUARTZ_VERTICES, 4
    copies = [[torch.from_numpy(a).to(dev) for a in feasibility_case(8 + i, U, V, T)]
              for i in range(16)]
    it = iter(range(1 << 30))
    ms = device_ms(lambda: feasible_mask(*copies[next(it) % 16]), iters=160)
    plain_ms = device_ms(lambda: ref_feasible(*copies[next(it) % 16]), iters=32)
    call_ms = time_ms(lambda: feasible_mask(*copies[next(it) % 16]), iters=160, warmup=16)
    nbytes = V * (4 + 1 + 4 + 8 + 4 * T) + U * (4 + 4 + 8 + 4 * T) + U * V
    ops = U * V * (5 + T)           # integer compares and ands per (row, vertex)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    feas = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")
    emit("schedule_kernels", kernel="feasibility", case="quartz", shape=[U, V, T], ms=ms,
         plain_ms=plain_ms, library_ms=None, bound_ms=feas["bound_ms"],
         bound_by=feas["bound_by"], gbps=nbytes / ms / 1e6, bytes=nbytes,
         call_ms=call_ms)

    # the per-level sweep: the Quartz tree with a random free set
    parent, levels, type_id = quartz_tree()
    free = np.random.default_rng(9).random(V) < 0.7
    own = np.zeros((V, T), np.int32)
    own[np.nonzero(free)[0], type_id[free]] = 1
    on_card = aggregate_sweep(own, parent, levels, dev).cpu().numpy()
    on_host = aggregate_sweep(own, parent, levels, "cpu").numpy()
    check(np.array_equal(on_card, on_host), "aggregate_sweep: card and CPU differ")
    check(np.array_equal(on_host[0], own.sum(0)), "aggregate_sweep: root != column sums")
    own_d = torch.from_numpy(own).to(dev)
    parent_d = torch.from_numpy(parent).to(dev)
    levels_d = [torch.from_numpy(lv).to(dev) for lv in levels]
    sweep_ms = device_ms(lambda: aggregate_sweep(own_d, parent_d, levels_d, dev))
    sweep_call_ms = time_ms(lambda: aggregate_sweep(own_d, parent_d, levels_d, dev), iters=100)
    emit("schedule_kernels", kernel="aggregate_sweep", case="quartz", shape=[V, T],
         levels=len(levels), exact=True, ms=sweep_ms, call_ms=sweep_call_ms)
    return {"feasibility": feas, "sweep_ms": sweep_ms}


# ---------------------------------------------------------------------- #
# phase 9: the scheduler slice's main path at Quartz size
# ---------------------------------------------------------------------- #
def make_backlog(n: int, seed: int = 0) -> list:
    """The backlog of ``benchmarks/batch_prefilter.py::make_requests``
    (same draws): 15% two-node jobs, the rest one node of 1 or 2 sockets
    with 4, 8 or 16 cores each; a fresh Jobspec per job."""
    from repro_torch.core import Jobspec
    rng = random.Random(seed)
    jobs = []
    for _ in range(n):
        if rng.random() < 0.15:
            jobs.append(Jobspec.hpc(nodes=2, sockets=4, cores=64))
        else:
            sockets = rng.choice([1, 2])
            jobs.append(Jobspec.hpc(nodes=1, sockets=sockets,
                                    cores=sockets * rng.choice([4, 8, 16])))
    return jobs


def host_ms_by_function(fn, names: dict) -> dict:
    """One call of ``fn`` under cProfile: for each function name, its
    own time ("own") or its time with its callees ("cum"), in ms."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    out = {}
    for (_, _, func), (_, _, own, cum, _) in pstats.Stats(prof).stats.items():
        if func in names:
            out[func] = out.get(func, 0.0) + 1e3 * (own if names[func] == "own" else cum)
    return out


class ScheduleRun:
    """One graph at Quartz size and the scheduler's operations on it,
    timed on the host clock (each ends in a copy to the host)."""

    def __init__(self, device):
        from repro_torch.core import Matcher, build_cluster
        t0 = time.perf_counter()
        self.g = build_cluster(**QUARTZ, device=device)
        self.flat = self.g.flat()
        self.build_s = time.perf_counter() - t0
        self.matcher = Matcher(self.g, use_flat=True)
        self.running = deque()
        self.match_ms, self.frb_ms = [], []

    def match(self, js, jobid):
        t0 = time.perf_counter()
        paths = self.matcher.match(js)
        self.match_ms.append(1e3 * (time.perf_counter() - t0))
        if paths is not None:
            self.g.set_allocated(paths, jobid)
            self.running.append((jobid, paths))
        return paths

    def kick(self, window):
        for _ in range(RELEASE):
            jobid, paths = self.running.popleft()
            self.g.set_free(paths, jobid)
        t0 = time.perf_counter()
        mask = self.flat.feasible_roots_batch(window)
        self.frb_ms.append(1e3 * (time.perf_counter() - t0))
        return mask

    def grow(self):
        """Splice GROW_NODES nodes under /cluster0, allocated to the
        growing job (MATCHGROW), and settle the mirror (a device sweep)."""
        from repro_torch.core import add_subgraph, build_cluster, update_metadata
        ext = build_cluster(**{**QUARTZ, "nodes": GROW_NODES}, node_prefix="grow",
                            rank_offset=QUARTZ["nodes"], device=self.g.device)
        sub = ext.extract([p for p in ext.paths() if "/grow" in p])
        t0 = time.perf_counter()
        self.grown = add_subgraph(self.g, sub)
        update_metadata(self.g, self.grown, jobid="grow")
        self.flat.sync()
        return 1e3 * (time.perf_counter() - t0)

    def shrink(self):
        from repro_torch.core import remove_subgraph
        t0 = time.perf_counter()
        removed = remove_subgraph(self.g, self.grown.new_paths, jobid="grow")
        self.flat.sync()
        ms = 1e3 * (time.perf_counter() - t0)
        check(removed.removed_vertices == len(self.grown.new_paths), "shrink count")
        return ms


def phase_schedule(dev, sweep_ms: float) -> int:
    """Returns the feasibility kernel's launches in the main path."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches

    backlog = make_backlog(BACKLOG, seed=0)
    reqs = [r for js in backlog for r in js.resources]
    card, host = ScheduleRun(dev), ScheduleRun("cpu")
    sides = (card, host)
    for s in sides:
        check(len(s.g) == QUARTZ_VERTICES and s.flat.n == QUARTZ_VERTICES,
              f"{len(s.g)} vertices, expected {QUARTZ_VERTICES}")
    torch.cuda.synchronize()
    reset_launches()
    calls, grow_ms, shrink_ms, windows = 0, [], [], []
    for k, js in enumerate(backlog[:JOBS]):
        if k == GROW_AT:
            grow_ms = [s.grow() for s in sides]
            check(all(s.flat.verify_against(s.g) for s in sides), "mirror after the grow")
        if k == SHRINK_AT:
            shrink_ms = [s.shrink() for s in sides]
            check(all(s.flat.verify_against(s.g) for s in sides), "mirror after the shrink")
        got = [s.match(js, f"job{k}") for s in sides]
        check(got[0] is not None, f"job {k} did not match")
        check(got[0] == got[1], f"job {k}: the card's match differs from the CPU twin's")
        if (k + 1) % KICK == 0:
            window = reqs[k + 1:]
            masks = [s.kick(window) for s in sides]
            calls += 1
            windows.append(len(window))
            check(np.array_equal(masks[0], masks[1]), f"kick {calls}: masks differ")
    torch.cuda.synchronize()
    launches = LAUNCHES["feasibility"]
    for s in sides:
        check(s.flat.verify_against(s.g), "mirror at the end")
    check(card.g.validate_tree(), "tree invariant at the end")
    n, T = card.flat.n, len(card.flat.types)
    check(n == host.flat.n and np.array_equal(card.flat.agg[:n, :T], host.flat.agg[:n, :T]),
          "final aggregate tables differ")
    check(card.flat.n_agg_sweeps == host.flat.n_agg_sweeps == 3,
          f"{card.flat.n_agg_sweeps} sweeps: expected build, grow and shrink")
    check(launches == calls, f"feasibility launches {launches} != {calls} calls")
    unique = len({(c.tid, c.min_size, c.req_mask, tuple(c.agg_need))
                  for c in map(card.flat.compiled, reqs[JOBS:])})
    check(unique == BACKLOG_SHAPES, f"{unique} distinct request shapes in the window")

    # where the time of one feasible_roots_batch and one match goes
    window = reqs[JOBS:]
    frb_wall, frb_dev, frb_host = profiled(lambda: card.flat.feasible_roots_batch(window))
    match_wall, match_dev, _ = profiled(lambda: card.matcher.match(backlog[JOBS]))
    kernel_ms = sum(ms for ms, _, k in frb_dev if "feasible" in k)
    copy_ms = sum(ms for ms, _, k in frb_dev if "Memcpy" in k or "memcpy" in k)
    host_split = host_ms_by_function(
        lambda: card.flat.feasible_roots_batch(window),
        {"feasible_roots_batch": "own", "compiled": "cum", "col": "cum",
         "batched_feasible_op": "cum"})

    def p99(xs):
        return sorted(xs)[min(len(xs) - 1, int(0.99 * len(xs)))]

    emit("schedule", vertices=len(card.g), jobs=JOBS,
         backlog=BACKLOG, kicks=calls, window_rows=windows, unique_shapes=unique,
         build_s=card.build_s, build_s_cpu_twin=host.build_s,
         match_ms_median=statistics.median(card.match_ms), match_ms_p99=p99(card.match_ms),
         match_ms_median_cpu_twin=statistics.median(host.match_ms),
         feasible_roots_batch_ms=card.frb_ms,
         feasible_roots_batch_ms_median=statistics.median(card.frb_ms),
         feasibility_kernel_ms=kernel_ms,
         feasible_roots_batch_ms_median_cpu_twin=statistics.median(host.frb_ms),
         sweep_ms=sweep_ms, grow_ms=grow_ms[0], shrink_ms=shrink_ms[0],
         grow_ms_cpu_twin=grow_ms[1], shrink_ms_cpu_twin=shrink_ms[1],
         launches={"feasibility": launches}, twin_identical=True, verify_against=True)
    emit("profile", part="feasible_roots_batch", window_rows=len(window), wall_ms=frb_wall,
         kernel_ms=kernel_ms, copy_ms=copy_ms, host_ms_by_function=host_split,
         device_busy_ms=sum(r[0] for r in frb_dev),
         idle_share=max(0.0, 1 - sum(r[0] for r in frb_dev) / frb_wall),
         top=[{"op": k, "ms": ms, "calls": c} for ms, c, k in frb_dev[:6]],
         host_top=[{"op": k, "ms": ms, "calls": c} for ms, c, k in frb_host[:6]])
    emit("profile", part="match", wall_ms=match_wall,
         device_busy_ms=sum(r[0] for r in match_dev),
         idle_share=max(0.0, 1 - sum(r[0] for r in match_dev) / match_wall),
         top=[{"op": k, "ms": ms, "calls": c} for ms, c, k in match_dev[:6]])
    return launches


# ---------------------------------------------------------------------- #
# phases 10-12: the training slice
# ---------------------------------------------------------------------- #
# flash_attention_bwd cases: name, (b, h, kvh, sq, skv, d), window, dtype,
# layout. The training shape (llama3.2-3b at batch 2 x 1024, the model's
# permuted views) in both dtypes, GQA groups 1, 3 and 8, window 32, sq 72 <
# skv 200, head dims 16 / 64 / 80 / 128, ragged lengths
BWD_SHAPE = (2, 24, 8, 1024, 1024, 128)
BWD_CASES = [
    ("train", BWD_SHAPE, 0, "bfloat16", "bshd"),
    ("train_fp32", BWD_SHAPE, 0, "float32", "bshd"),
    ("gqa3_d64", (2, 6, 2, 256, 256, 64), 0, "bfloat16", "bhsd"),
    ("gqa3_d64_fp32", (2, 6, 2, 256, 256, 64), 0, "float32", "bhsd"),
    ("gqa8", (2, 16, 2, 256, 256, 128), 0, "bfloat16", "bshd"),
    ("gqa8_fp32", (2, 16, 2, 256, 256, 128), 0, "float32", "bshd"),
    ("window32", (2, 8, 2, 256, 256, 64), 32, "bfloat16", "bshd"),
    ("window32_fp32", (2, 8, 2, 256, 256, 64), 32, "float32", "bhsd"),
    ("offset_q", (2, 6, 2, 72, 200, 64), 0, "bfloat16", "bshd"),
    ("offset_q_fp32", (2, 6, 2, 72, 200, 64), 0, "float32", "bhsd"),
    ("d80", (2, 8, 8, 192, 192, 80), 0, "bfloat16", "bshd"),
    ("d80_fp32", (2, 8, 8, 192, 192, 80), 0, "float32", "bhsd"),
    ("ragged", (2, 24, 8, 200, 200, 128), 0, "bfloat16", "bshd"),
    ("d16", (2, 4, 2, 100, 100, 16), 0, "bfloat16", "bshd"),
    # zamba2-2.7b's shared attention block as its training run calls it
    ("zamba2_train", (2, 32, 32, 1024, 1024, 80), 0, "bfloat16", "bshd"),
    # qwen3-moe-30b-a3b's attention (GQA group 8) as its training run calls it
    ("qwen3_train", (2, 32, 4, 1024, 1024, 128), 0, "bfloat16", "bshd"),
]
# the cases timed beside their bounds (bwd_timing): llama's row goes into the
# kernel table, qwen3's is printed beside it
BWD_TIMED = ("train", "qwen3_train")
# of the largest |grad| of each output: in bf16 dq, dk and dv are rounded to
# bf16 (as are o and dO, which both sides read); in fp32 only the order of
# the sums differs (the plain version's einsums against the kernel's tiles)
BWD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# of each 64-row tile of each (batch, head) of a gradient, ||g - r|| / ||r||
# (``tile_rel_err``): a wrong tile of small gradients shows, where the max
# check above weighs it against the tensor's largest |grad|. The bf16 limit
# lies between the sound kernels' readings and those of faults planted in
# them (tools/attention_bwd_faults.py)
BWD_TILE_TOL = {"bfloat16": 1e-2, "float32": 1e-5}
# the backward's kernels and their instantiations: the row sums in both
# dtypes, the tensor-core kernels in bf16, the CUDA-core ones in fp32; at
# each of the 5 head dims
BWD_INSTANTIATIONS = {"flash_bwd_delta_kernel": 10, "flash_bwd_dkdv_mma_kernel": 5,
                      "flash_bwd_dq_mma_kernel": 5, "flash_bwd_dkdv_kernel": 5,
                      "flash_bwd_dq_kernel": 5}
BWD_KERNELS = tuple(BWD_INSTANTIATIONS)
# what one flash_attention_bwd call launches in each dtype
BWD_BF16 = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel")
BWD_FP32 = ("flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")
# the full-width training run: llama3.2-3b, 28 layers, d_model 3072, vocab
# 128256, remat on; JAX's train_4k cell (256 x 4096) cut to 2 x 1024 so
# that the fp32 masters, gradients and AdamW moments fit one card
TRAIN = dict(steps=6, grow_at=2, shrink_at=3, fail_at=4, start_chips=2)
TRAIN_SHAPE = (1024, 2)                # seq_len, batch
TRAIN_CONSISTENCY_STEPS = 3
TRAIN_TOL = 1e-4                       # losses relative; params of their largest |value|


def bwd_ptxas(rows: list) -> list:
    """The ptxas rows of the backward's kernels; fails on a spill or on an
    instantiation count other than ``BWD_INSTANTIATIONS``'s."""
    out = [r for r in rows if any(k in r["kernel"] for k in BWD_KERNELS)]
    counts = {k: sum(k in r["kernel"] for r in out) for k in BWD_KERNELS}
    check(counts == BWD_INSTANTIATIONS, f"ptxas reports backward instantiations {counts}")
    spilled = [r for r in out if r.get("spill_stores") or r.get("spill_loads")]
    check(not spilled, f"backward kernels spill: {spilled}")
    return out


def norm_rel_err(g, r) -> float:
    """||g - r||_2 / ||r||_2 over the whole tensor."""
    return ((g.float() - r.float()).norm() / r.float().norm()).item()


def bwd_inputs(gen, dev, b, h, kvh, sq, skv, d, dtype, layout):
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(
            getattr(torch, dtype))
    if layout == "bshd":
        return (randn(b, sq, h, d).permute(0, 2, 1, 3), randn(b, skv, kvh, d).permute(0, 2, 1, 3),
                randn(b, skv, kvh, d).permute(0, 2, 1, 3), randn(b, sq, h, d).permute(0, 2, 1, 3))
    return randn(b, h, sq, d), randn(b, kvh, skv, d), randn(b, kvh, skv, d), randn(b, h, sq, d)


def bwd_bound(b, h, kvh, sq, skv, d, itemsize):
    """(ms, by, gflop, mbytes): the backward's five products (S, dP, dV, dK,
    dQ: 2 d operations each per attended (query, key) pair of each head, the
    causal half) at the bf16 tensor-core peak, against q, k, v, o, dO and
    lse read once and dq, dk, dv written once."""
    off = skv - sq
    pairs = sum(min(skv, i + off + 1) for i in range(sq))
    flops = 5 * 2.0 * d * pairs * b * h
    nbytes = itemsize * (4 * b * h * sq * d + 4 * b * kvh * skv * d) + 4.0 * b * h * sq
    t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops / 1e9, nbytes / 1e6)


def phase_train_kernels(dev, ptxas: list) -> dict:
    """The attention backward kernel against ``ref_attention_bwd`` on the
    card, each fed the kernel forward's o and logsumexp; the logsumexp
    against the plain version's; the whole autograd path (``attention_op``
    on inputs that want a gradient) against autograd through the plain
    forward; then the times at the training shape."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.ops import attention_op
    from repro_torch.kernels.ref import ref_attention, ref_attention_bwd, tile_rel_err

    bwd_rows = bwd_ptxas(ptxas)
    emit("train_kernels", ptxas=bwd_rows)
    gen = torch.Generator(device=dev).manual_seed(5)
    timed = {}
    for name, (b, h, kvh, sq, skv, d), window, dtype, layout in BWD_CASES:
        q, k, v, dO = bwd_inputs(gen, dev, b, h, kvh, sq, skv, d, dtype, layout)
        o, lse = flash_attention(q, k, v, window=window, return_lse=True)
        grads = flash_attention_bwd(q, k, v, o, lse, dO, window=window)
        torch.cuda.synchronize()
        ref_o, ref_lse = ref_attention(q, k, v, window=window, return_lse=True)
        o_err = compare(o, ref_o, dtype)
        lse_err = compare(lse, ref_lse, "float32", TOL["float32"])
        del ref_o
        refs = ref_attention_bwd(q, k, v, o, lse, dO, window=window)
        tol, tile_tol = BWD_TOL[dtype], BWD_TILE_TOL[dtype]
        errs, scales, tiles, norms = [], [], [], []
        for g, r, gname in zip(grads, refs, ("dq", "dk", "dv")):
            scale = r.float().abs().max().item()
            err = (g.float() - r.float()).abs().max().item()
            check(g.shape == r.shape and math.isfinite(err) and err <= tol * scale,
                  f"flash_attention_bwd {name} {gname}: {err} > {tol} * {scale}")
            tile = tile_rel_err(g, r)
            check(tile <= tile_tol,
                  f"flash_attention_bwd {name} {gname}: a 64-row tile off by {tile} > {tile_tol}")
            errs.append(err)
            scales.append(scale)
            tiles.append(tile)
            norms.append(norm_rel_err(g, r))
        emit("train_kernels", kernel="flash_attention_bwd", case=name,
             shape=[b, h, kvh, sq, skv, d], window=window, dtype=dtype, layout=layout,
             max_abs_err=dict(zip(("dq", "dk", "dv"), errs)),
             max_abs_ref=dict(zip(("dq", "dk", "dv"), scales)), tol_of_largest=tol,
             tile_rel_err=dict(zip(("dq", "dk", "dv"), tiles)), tile_tol=tile_tol,
             norm_rel_err=dict(zip(("dq", "dk", "dv"), norms)), o_max_abs_err=o_err,
             lse_max_abs_err=lse_err)
        if name in ("train", "train_fp32", "qwen3_train"):
            # the kernels a call launches, profiled over ten calls (the
            # window of one call can come back empty)
            want = BWD_BF16 if dtype == "bfloat16" else BWD_FP32
            _, rows, _ = profiled(lambda: [flash_attention_bwd(q, k, v, o, lse, dO, window=window)
                                           for _ in range(10)])
            got = [kn for kn in BWD_KERNELS if any(kn in key for _, _, key in rows)]
            check(sorted(got) == sorted(want), f"flash_attention_bwd {name} launched {got}")
        if name in BWD_TIMED:
            row = bwd_timing(q, k, v, o, lse, dO, max(e / s for e, s in zip(errs, scales)),
                             case=name)
            row["max_abs_err"] = max(errs)
            emit("train_kernels", kernel="flash_attention_bwd", case=name,
                 registers={r["kernel"]: r.get("registers") for r in bwd_rows
                            if f"Li{d}E" in r["kernel"] and "mma" in r["kernel"]})
            if name == "train":
                timed = row
        del q, k, v, dO, o, lse, grads, refs

    # the autograd path: attention_op on leaves that want a gradient runs
    # FlashAttention (forward with the logsumexp, then the backward kernel)
    from repro_torch.kernels import LAUNCHES
    b, h, kvh, sq, skv, d = 2, 8, 2, 256, 256, 128
    q, k, v, dO = bwd_inputs(gen, dev, b, h, kvh, sq, skv, d, "bfloat16", "bshd")
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = dict(LAUNCHES)
    got = torch.autograd.grad(attention_op(*leaves), leaves, dO)
    check(LAUNCHES["flash_attention"] == before["flash_attention"] + 1
          and LAUNCHES["flash_attention_bwd"] == before["flash_attention_bwd"] + 1,
          "attention_op under grad: one forward and one backward launch")
    plain = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref_attention(*plain), plain, dO.float())
    errs = []
    for g, w in zip(got, want):
        err = (g.float() - w).abs().max().item()
        check(err <= BWD_TOL["bfloat16"] * w.abs().max().item(),
              f"attention_op autograd vs plain autograd: {err}")
        errs.append(err)
    emit("train_kernels", kernel="attention_op", case="autograd_bf16_vs_plain_fp32",
         shape=[b, h, kvh, sq, skv, d], max_abs_err=errs, tol_of_largest=BWD_TOL["bfloat16"])
    return timed


def bwd_timing(q, k, v, o, lse, dO, err_share: float, case: str = "train") -> dict:
    """Device ms of one ``flash_attention_bwd`` call (its three launches),
    of the plain version, and of the backward half of
    ``scaled_dot_product_attention`` through autograd (the library's
    yardstick; GQA as expanded k and v), beside the bound."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ref import ref_attention_bwd

    b, h, sq, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    _, rows, _ = profiled(lambda: [flash_attention_bwd(q, k, v, o, lse, dO) for _ in range(10)])
    kernel_ms = {kn: sum(ms for ms, _, key in rows if kn in key) / 10 for kn in BWD_KERNELS}
    kernel_ms = {kn: t for kn, t in kernel_ms.items() if t}     # those this dtype launches
    ms = device_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dO), iters=10)
    event_ms = time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, dO), iters=10)
    plain_ms = device_ms(lambda: ref_attention_bwd(q, k, v, o, lse, dO), iters=3)
    g = h // kvh
    lq = q.detach().requires_grad_()
    lk = k.repeat_interleave(g, dim=1).detach().requires_grad_()
    lv = v.repeat_interleave(g, dim=1).detach().requires_grad_()
    lo = torch.nn.functional.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lib_ms = device_ms(lambda: torch.autograd.grad(lo, (lq, lk, lv), dO, retain_graph=True),
                       iters=10)
    bound_ms, by, gflop, mbytes = bwd_bound(b, h, kvh, sq, skv, d, q.element_size())
    row = dict(ms=ms, event_ms=event_ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
               library_ms=lib_ms, bound_ms=bound_ms, bound_by=by)
    emit("train_kernels", kernel="flash_attention_bwd", case=case,
         shape=[b, h, kvh, sq, skv, d], **row, gflop=gflop,
         mbytes=mbytes, tflops=gflop / ms, max_err_share_of_largest=err_share)
    return row


def per_step_launches(cfg) -> dict:
    """Kernel launches of one training step: each forward kernel once a
    block and once more under remat, each backward kernel once a block
    (attention per attention block, the SSD chunk per Mamba2 block)."""
    blocks = expected_launches(cfg, 1)
    fwd = 2 if cfg.remat else 1
    return {"flash_attention": fwd * blocks["flash_attention"],
            "flash_attention_bwd": blocks["flash_attention"],
            "ssd_chunk": fwd * blocks["ssd_chunk"], "ssd_chunk_bwd": blocks["ssd_chunk"]}


def phase_train_consistency(dev, arch: str = ARCH) -> None:
    """Reduced ``arch`` in fp32: three ``train_step``s on the card against
    the same steps on the CPU from the same weights and batches. Losses
    within ``TRAIN_TOL`` relative; every parameter within ``TRAIN_TOL`` of
    the largest |value| of all parameters (AdamW moves an element whose
    gradient is near zero by up to lr whatever that gradient's size, so a
    leaf's own largest |value| is no scale for its smallest leaves). Each
    step launches each forward and backward kernel once a block (remat is
    off in the reduced config)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model
    from repro_torch.optim.adamw import OptConfig

    cfg = get_config(arch).reduced()
    opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
    host = make_model(cfg, device="cpu", opt=opt)
    host.init_params(torch.Generator().manual_seed(6))
    card = make_model(cfg, device=dev, opt=opt)
    card.load_params(host.state_dict())
    pipe = SyntheticTokenPipeline(cfg, ShapeConfig("smoke_train", 32, 8, "train"), DataConfig())
    states = [host.init_opt(), card.init_opt()]
    reset_launches()
    rows = []
    for step in range(TRAIN_CONSISTENCY_STEPS):
        batch = pipe.batch_at(step)
        losses = []
        for i, model in enumerate((host, card)):
            tb = {n: torch.from_numpy(a).to(model.device, torch.long) for n, a in batch.items()}
            states[i], m = model.train_step(states[i], tb)
            losses.append(m["loss"].item())
        rel = abs(losses[1] - losses[0]) / abs(losses[0])
        check(math.isfinite(losses[1]) and rel <= TRAIN_TOL,
              f"{arch} train step {step}: card loss {losses[1]} vs CPU {losses[0]}")
        rows.append({"step": step, "loss_cpu": losses[0], "loss_card": losses[1], "rel": rel})
    launches = dict(LAUNCHES)
    expect = {k: TRAIN_CONSISTENCY_STEPS * n for k, n in per_step_launches(cfg).items()}
    check(all(launches[k] == expect.get(k, 0) for k in launches),
          f"{arch} train consistency launches {launches}, expected {expect}")
    hp, cp = host.masters(), card.masters()
    scale = max(t.abs().max().item() for t in hp.values())
    diff = {name: (cp[name].cpu() - t).abs().max().item() for name, t in hp.items()}
    worst = max(diff, key=diff.get)
    check(diff[worst] <= TRAIN_TOL * scale,
          f"{arch} params after {TRAIN_CONSISTENCY_STEPS} steps: {worst} {diff[worst]} > "
          f"{TRAIN_TOL} * {scale}")
    emit("train_consistency", arch=cfg.name, dtype=cfg.dtype, steps=rows,
         max_param_diff=diff[worst], worst_param=worst, max_abs_param=scale,
         tol=TRAIN_TOL, launches=launches)


def phase_train(dev, arch: str = ARCH, profile: bool = True, n_layers: int = None,
                readings=None, phase: str = "train") -> dict:
    """``run_training`` at full width and depth on the card (the cell of
    ``TRAIN_SHAPE``; with ``n_layers``, the depth cut to that many layers):
    a MATCHALLOCATE through the copied control plane, a grow, a shrink and
    a node failure with replacement, AdamW steps whose forward kernels run
    twice a block (once more under remat) and backward kernels once
    (``per_step_launches``). Launch counts are read around exactly this
    run; then ``readings(dev, cfg, res)``, if given, and with ``profile``
    one more step under the profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import cut_depth, run_training
    from repro_torch.models.config import ShapeConfig

    cfg = get_config(arch)
    check((cfg.n_layers, cfg.d_model) == DEPTH[arch] and cfg.remat, f"{arch}: full-width config")
    if n_layers is not None:
        cfg = cut_depth(cfg, n_layers)
    seq, batch = TRAIN_SHAPE
    steps = TRAIN["steps"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_training(arch, smoke=False, shape=ShapeConfig("train_h100", seq, batch, "train"),
                       n_layers=n_layers, device=dev, **TRAIN)
    wall_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = {k: n for k, n in per_step_launches(cfg).items() if n}
    expect = {name: n * steps for name, n in per_step.items()}
    losses, kinds = res["losses"], [e.kind for e in res["events"]]
    step_ms = [1e3 * s for s in res["step_s"]]
    steady = step_ms[1:]                 # the first step also warms up cuBLAS and the allocator
    emit(phase, arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model, vocab=cfg.vocab,
         reduced=res["reduced"],
         n_params=cfg.n_params(), seq_len=seq, batch=batch, steps=steps, remat=cfg.remat,
         losses=losses, events=kinds, step_ms=step_ms,
         step_ms_median=statistics.median(steady),
         tokens_per_s=seq * batch / (statistics.median(steady) / 1e3), wall_s=wall_s,
         peak_mem_gb=peak_gb, launches=launches, expected_launches=expect,
         launches_per_step=per_step)
    check(all(math.isfinite(x) for x in losses), f"{arch}: non-finite losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab)) <= 1.0,
          f"{arch}: first loss {losses[0]} is not within 1.0 of ln {cfg.vocab}")
    check(kinds == ["rebind", "grow", "rebind", "shrink", "rebind", "eject", "rebind"],
          f"{arch}: events {kinds}")
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"train {arch}: {name} launches {n} != {expect.get(name, 0)}")
    check(peak_gb < 80.0, f"{arch}: peak memory {peak_gb} GB")
    if readings is not None:
        readings(dev, cfg, res)
    if profile:
        profile_train_step(dev, cfg, res)
    del res
    torch.cuda.empty_cache()
    return launches


def profile_train_step(dev, cfg, res) -> None:
    """Where the time of one more step goes: its gradients (forward, loss,
    backward with the remat recompute), then the optimizer. The gradients
    part must show each kernel a block's launches: in bf16 the tensor-core
    attention kernels (none of the CUDA-core backward pair), and the SSD
    chunk's (``ssd_scores_kernel`` in both directions)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.optim.adamw import apply_updates
    seq, batch = TRAIN_SHAPE
    rt = res["runtime"]
    model = rt.model
    batch_np = SyntheticTokenPipeline(rt.cfg, rt.shape, DataConfig()).batch_at(TRAIN["steps"])
    tb = {n: torch.from_numpy(a).to(dev, torch.long) for n, a in batch_np.items()}
    held = {}
    parts = [("train_grads", lambda: held.update(vg=model.value_and_grad(tb))),
             ("train_optimizer",
              lambda: apply_updates(model.masters(), held["vg"][1], rt.opt_state, model.opt))]
    per = per_step_launches(cfg)
    want = {"flash_fwd_mma_kernel": per["flash_attention"],
            **{k: per["flash_attention_bwd"] if k in BWD_BF16 else 0 for k in BWD_KERNELS},
            "ssd_chunk_kernel": per["ssd_chunk"],
            "ssd_scores_kernel": per["ssd_chunk"] + per["ssd_chunk_bwd"],
            **{k: per["ssd_chunk_bwd"] for k in SSD_BWD_KERNELS[1:]}}
    total_wall = total_busy = 0.0
    for part, fn in parts:
        wall_ms, rows, _ = profiled(fn)
        busy_ms = sum(r[0] for r in rows)
        total_wall += wall_ms
        total_busy += busy_ms
        emit("profile", arch=cfg.name, part=part, seq_len=seq, batch=batch, wall_ms=wall_ms,
             device_busy_ms=busy_ms, idle_share=max(0.0, 1 - busy_ms / wall_ms),
             by_class=kernel_classes(rows),
             top=[{"op": k, "ms": ms, "calls": n} for ms, n, k in rows[:15]])
        if part == "train_grads":
            got = {k: sum(n for _, n, key in rows if k in key) for k in want}
            check(got == want, f"{cfg.name} profiled step: launches {got}, expected {want}")
    emit("profile", arch=cfg.name, part="train_step", wall_ms=total_wall,
         device_busy_ms=total_busy, idle_share=max(0.0, 1 - total_busy / total_wall))


# ---------------------------------------------------------------------- #
# phases 13-15: SSM and hybrid training
# ---------------------------------------------------------------------- #
# ssd_chunk_bwd cases: name, (b, s, H, P, G, N, chunk), strided. The mamba2
# and zamba2 training shapes (TRAIN_SHAPE: batch 2 x 1024), the configs'
# perf-patch chunk of 128, and SSD_CASES' edges: the reduced shape, two
# groups, the model's strided views, 4-byte copies of B and C, a chunk of one
SSD_BWD_TRAIN = (2, 1024, 80, 64, 1, 128, 256)
SSD_BWD_CASES = [
    ("mamba2", SSD_BWD_TRAIN, False),
    ("zamba2", (2, 1024, 80, 64, 1, 64, 256), False),
    ("chunk128", (2, 1024, 80, 64, 1, 128, 128), False),
    ("reduced", (2, 32, 8, 16, 1, 16, 8), False),
    ("groups2", (2, 128, 4, 32, 2, 16, 32), False),
    ("strided", SSD_BWD_TRAIN, True),
    ("state10", (1, 64, 4, 8, 1, 10, 16), True),
    ("chunk1", (1, 16, 4, 16, 1, 8, 1), False),
]
SSD_BWD_TIMED = ("mamba2", "zamba2")
# what one ssd_chunk_bwd call launches
SSD_BWD_KERNELS = ("ssd_scores_kernel", "ssd_bwd_head_kernel", "ssd_bwd_head_sum_kernel",
                   "ssd_bwd_group_kernel", "ssd_bwd_gA_kernel")
SSD_BWD_GRADS = ("gx", "gdt", "gA", "gB", "gC")
# of each (batch, chunk, head) tile of gx and gdt and (batch, chunk, group)
# tile of gB and gC, ||g - r|| / ||r|| (``tile_rel_err``; gA, a sum over
# batch and chunk, as one tile): set between the sound kernel's readings
# and those of the faults planted by tools/ssd_bwd_faults.py
SSD_BWD_TILE_TOL = 1e-4
SSM_TRAIN_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")


def ssd_bwd_bound(b, s, H, P, G, N, Q):
    """(ms, by, gflop, mbytes) of the least time for ``ssd_chunk_bwd``'s
    work, in ``ssd_bound``'s conventions (causal half, 3xTF32 at 495
    TFLOP/s): per head gM = gy u^T and M^T gy over the causal pairs, B
    gstate and (w o u) gstate^T; per group S = C B^T again, G_S B and
    G_S^T C. Bytes: x, dt, A, B, C, gy, gstates and gdecay read once, the
    five gradients written once."""
    nc = s // Q
    tri = Q * (Q + 1) / 2
    flops = b * nc * (H * (4.0 * tri * P + 4.0 * Q * N * P) + G * 6.0 * tri * N)
    nbytes = 4.0 * (3 * b * s * H * P + 2 * b * s * H + 2 * H + 4 * b * s * G * N
                    + b * nc * H * (N * P + 1))
    t_ops, t_bytes = 3 * flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops / 1e9, nbytes / 1e6)


def ssd_bwd_inputs(gen, dev, b, s, H, P, G, N, Q, strided):
    """``ssd_inputs`` (as strided views into one projection, as the model
    passes them, when ``strided``) and gradients of the three outputs."""
    import torch
    x, dt, A, B, C = ssd_inputs(gen, dev, b, s, H, P, G, N)
    if strided:
        x, dt, B, C = model_views(x, dt, B, C)
    nc = s // Q

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
    return (x, dt, A, B, C), (randn(b, s, H, P), randn(b, nc, H, N, P), randn(b, nc, H))


def ssd_bwd_tiles(grads, refs, Q: int) -> dict:
    """``tile_rel_err`` of each gradient: gx and gdt per (batch, chunk,
    head), gB and gC per (batch, chunk, group), gA (summed over batch and
    chunk; a head's value may be near 0) as one tile."""
    from repro_torch.kernels.ref import tile_rel_err

    def tiles(t):
        if t.dim() == 1:                                  # gA: [1, H, 1]
            return t[None, :, None]
        t = t if t.dim() == 4 else t[..., None]           # gdt: one column
        return t.transpose(1, 2)                          # [b, heads or groups, s, cols]
    return {n: tile_rel_err(tiles(g), tiles(r), rows=Q if g.dim() > 1 else g.numel())
            for n, g, r in zip(SSD_BWD_GRADS, grads, refs)}


def ssd_bwd_ptxas(rows: list) -> list:
    """The ptxas rows of the backward's own kernels (one instantiation
    each); fails on a spill."""
    out = [r for r in rows if any(k in r["kernel"] for k in SSD_BWD_KERNELS[1:])]
    check(len(out) == len(SSD_BWD_KERNELS) - 1, f"ptxas reports {len(out)} SSD backward kernels")
    spilled = [r for r in out if r.get("spill_stores") or r.get("spill_loads")]
    check(not spilled, f"SSD backward kernels spill: {spilled}")
    return out


def phase_ssm_train_kernels(dev, ptxas: list) -> dict:
    """The SSD chunk kernels on the card at the training grids: the
    forward's y, states and decay against ``ref_ssd_chunk`` (and, at the
    timed shapes, the formula in fp64); the backward against
    ``ref_ssd_chunk_bwd``: every gradient finite, within ``SSD_TOL`` of its
    largest |value| of the plain version and of the formula in fp64, and
    each tile within ``SSD_BWD_TILE_TOL`` of the plain version's; ``ssd_scan_op``'s autograd
    path against the sequential recurrence's; then the times at the mamba2
    and zamba2 training shapes."""
    import torch
    from repro_torch.kernels.ref import ref_ssd_chunk, ref_ssd_chunk_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_bwd

    rows = ssd_bwd_ptxas(ptxas)
    emit("ssm_train_kernels", ptxas=rows)
    gen = torch.Generator(device=dev).manual_seed(7)
    timed = {}
    for name, (b, s, H, P, G, N, Q), strided in SSD_BWD_CASES:
        inputs, outs = ssd_bwd_inputs(gen, dev, b, s, H, P, G, N, Q, strided)
        fwd = ssd_chunk(*inputs, Q)
        torch.cuda.synchronize()
        fwd_ref = ref_ssd_chunk(*inputs, Q)
        fwd_exact = {}
        if name in SSD_BWD_TIMED:
            fwd_exact = {"exact_tol_share": dict(zip(
                ("y", "states", "decay"), ssd_exact_shares(fwd, *inputs, Q)))}
        emit("ssm_train_kernels", kernel="ssd_chunk", case=name, shape=[b, s, H, P, G, N, Q],
             strided=strided, max_abs_err=dict(zip(("y", "states", "decay"), (
                 compare(o, r, "float32", SSD_TOL) for o, r in zip(fwd, fwd_ref)))),
             tol_share=dict(zip(("y", "states", "decay"),
                                (tol_share(o, r) for o, r in zip(fwd, fwd_ref)))),
             **fwd_exact, tol=SSD_TOL)
        del fwd, fwd_ref
        grads = ssd_chunk_bwd(*inputs, Q, *outs)
        torch.cuda.synchronize()
        refs = ref_ssd_chunk_bwd(*inputs, Q, *outs)
        exact = ref_ssd_chunk_bwd(*inputs, Q, *outs, exact=True)
        share, exact_share, scales = {}, {}, {}
        for gname, g, r, e in zip(SSD_BWD_GRADS, grads, refs, exact):
            check(g.shape == r.shape and bool(torch.isfinite(g).all()),
                  f"ssd_chunk_bwd {name} {gname}: shape {tuple(g.shape)} or not finite")
            scales[gname] = r.abs().max().item()
            share[gname] = (g - r).abs().max().item() / (SSD_TOL * scales[gname])
            exact_share[gname] = ((g.double() - e).abs().max() / (SSD_TOL * e.abs().max())).item()
        tiles = ssd_bwd_tiles(grads, refs, Q)
        emit("ssm_train_kernels", kernel="ssd_chunk_bwd", case=name,
             shape=[b, s, H, P, G, N, Q], strided=strided, tol_share=share,
             exact_tol_share=exact_share, max_abs_ref=scales, tile_rel_err=tiles,
             tol=SSD_TOL, tile_tol=SSD_BWD_TILE_TOL)
        for gname in SSD_BWD_GRADS:
            check(share[gname] <= 1.0, f"ssd_chunk_bwd {name} {gname}: {share[gname]} of "
                  f"{SSD_TOL} of its largest |value| from ref_ssd_chunk_bwd")
            check(exact_share[gname] <= 1.0, f"ssd_chunk_bwd {name} {gname}: "
                  f"{exact_share[gname]} of {SSD_TOL} of its largest |value| from fp64")
            check(tiles[gname] <= SSD_BWD_TILE_TOL,
                  f"ssd_chunk_bwd {name} {gname}: a tile off by {tiles[gname]}")
        del grads, refs, exact
        if name in SSD_BWD_TIMED:
            timed[name] = dict(max_abs_err=max(share[g] * SSD_TOL * scales[g] for g in share),
                               **ssd_bwd_timing(inputs, outs, Q))
        del inputs, outs

    # the autograd path: ssd_scan_op on leaves that want a gradient (a
    # ragged length, an initial state) runs ssd_chunk then ssd_chunk_bwd,
    # against autograd through the sequential recurrence
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ops import ssd_scan_op
    from repro_torch.kernels.ref import ref_ssd
    b, s, H, P, G, N, Q = SSD_SCAN
    x, dt, A, B, C = ssd_inputs(gen, dev, b, s, H, P, G, N)
    h0 = torch.randn((b, H, P, N), generator=gen, device=dev)
    gy = torch.randn((b, s, H, P), generator=gen, device=dev)
    gh = torch.randn((b, H, P, N), generator=gen, device=dev)
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, B, C, h0)]
    before = dict(LAUNCHES)
    y, h = ssd_scan_op(*leaves[:5], Q, initial_state=leaves[5], return_state=True)
    got = torch.autograd.grad((y, h), leaves, (gy, gh))
    check(LAUNCHES["ssd_chunk"] == before["ssd_chunk"] + 1
          and LAUNCHES["ssd_chunk_bwd"] == before["ssd_chunk_bwd"] + 1,
          "ssd_scan_op under grad: one forward and one backward launch")
    plain = [t.detach().requires_grad_() for t in (x, dt, A, B, C, h0)]
    ry, rh = ref_ssd(*plain[:5], initial_state=plain[5], return_state=True)
    want = torch.autograd.grad((ry, rh), plain, (gy, gh))
    errs = {}
    for gname, g, w in zip(("gx", "gdt", "gA", "gB", "gC", "gh0"), got, want):
        errs[gname] = (g - w).abs().max().item() / w.abs().max().item()
        check(errs[gname] <= SSD_TOL, f"ssd_scan_op autograd {gname}: {errs[gname]} of its "
              f"largest |value| from the recurrence's")
    emit("ssm_train_kernels", kernel="ssd_scan_op", case="autograd_vs_recurrence",
         shape=[b, s, H, P, G, N, Q], err_of_largest=errs, tol_of_largest=SSD_TOL)
    # the table's row is the mamba2 training shape's, with zamba2's beside it
    return dict(timed["mamba2"], zamba2=timed["zamba2"])


def ssd_bwd_timing(inputs, outs, Q) -> dict:
    """Device ms of one ``ssd_chunk_bwd`` call (its five launches, and each
    kernel's), its CUDA-event ms and the plain version's device ms beside
    the bound."""
    from repro_torch.kernels.ref import ref_ssd_chunk_bwd
    from repro_torch.kernels.ssd_scan import ssd_chunk_bwd

    x, B = inputs[0], inputs[3]
    b, s, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    _, rows, _ = profiled(lambda: [ssd_chunk_bwd(*inputs, Q, *outs) for _ in range(10)])
    kernel_ms = {k: sum(ms for ms, _, key in rows if k in key) / 10 for k in SSD_BWD_KERNELS}
    check(all(kernel_ms.values()), f"ssd_chunk_bwd launched {kernel_ms}")
    ms = device_ms(lambda: ssd_chunk_bwd(*inputs, Q, *outs), iters=10)
    bound, by, gflop, mbytes = ssd_bwd_bound(b, s, H, P, G, N, Q)
    row = dict(ms=ms, kernel_ms=kernel_ms,
               event_ms=time_ms(lambda: ssd_chunk_bwd(*inputs, Q, *outs), iters=10),
               plain_ms=device_ms(lambda: ref_ssd_chunk_bwd(*inputs, Q, *outs), iters=3),
               library_ms=None, bound_ms=bound, bound_by=by)
    emit("ssm_train_kernels", kernel="ssd_chunk_bwd", shape=[b, s, H, P, G, N, Q], **row,
         gflop=gflop, mbytes=mbytes, tflops=gflop / ms)
    return row


# ---------------------------------------------------------------------- #
# phases 16-18: the MoE slice
# ---------------------------------------------------------------------- #
MOE_ARCH = "qwen3-moe-30b-a3b"
# the depth cut of the full-width serving run: a layer holds 623 M
# parameters, 3.74 GB as fp32 masters and the bf16 serving copy; 48 layers
# and the fp32 embedding and head (2.49 GB) would take 182 GB, 16 take 62.3
MOE_DEPTH = 16
MOE_WIDTH = dict(d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128, n_experts=128,
                 top_k=8, moe_d_ff=768, vocab=151936)
MOE_CONSISTENCY = (2, 256)                 # b, s, as phase_consistency
MOE_REDUCED = ("qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b")
MOE_DECODE_STEPS = 3
MOE_CPU_TOL = 2e-3                         # of the largest logit: fp32, sums in other orders


class MoeRecorder:
    """While active, every MoE layer's call also records its dispatch plan:
    the tokens it saw and its keep mask [T*k] (as ``moe_dispatch`` computes
    it from the same input). Patches ``models.transformer.moe``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import transformer
        from repro_torch.models.layers import rmsnorm

        self._mod, self._orig = transformer, transformer.moe

        def recording(x, p, cfg):
            T = x.shape[0] * x.shape[1]
            xn = rmsnorm(x, p["norm"], cfg.norm_eps).reshape(T, -1)
            plan = moe_mod.dispatch_plan(moe_mod._route(xn, p, cfg)[1], cfg)
            self.calls.append((T, plan.capacity, plan.keep))
            return self._orig(x, p, cfg)
        transformer.moe = recording
        return self

    def __exit__(self, *exc):
        self._mod.moe = self._orig
        return False

    def dropped(self, pred) -> dict:
        """Pairs and the share dropped over the calls whose T passes ``pred``."""
        keep = [k for T, _, k in self.calls if pred(T)]
        pairs = sum(k.numel() for k in keep)
        dropped = sum(int((~k).sum().item()) for k in keep)
        return {"calls": len(keep), "pairs": pairs, "dropped": dropped,
                "share": dropped / max(pairs, 1),
                "capacity": sorted({C for T, C, _ in self.calls if pred(T)}),
                "share_by_call": [float((~k).float().mean()) for k in keep[:MOE_DEPTH]]}


def moe_serving_model(dev):
    """qwen3-moe-30b-a3b at full width, depth cut to ``MOE_DEPTH``, weights
    from seed 0 on the card."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import make_model

    full = get_config(MOE_ARCH)
    check((full.n_layers, full.d_model) == DEPTH[MOE_ARCH]
          and all(getattr(full, k) == v for k, v in MOE_WIDTH.items())
          and full.family == "moe" and full.moe_every == 1 and full.moe_impl == "dispatch",
          f"{MOE_ARCH}: full-width config")
    cfg = dataclasses.replace(full, n_layers=MOE_DEPTH)
    model = make_model(cfg, device=dev)
    model.init_params(torch.Generator(device=dev).manual_seed(0))
    return model


def phase_serve_moe(dev, model) -> dict:
    """``serve_model`` on the cut qwen3-moe model: a warm-up run under the
    MoE recorder (its drop shares are this prompt's and these weights'),
    then the run whose launches and times are read."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import serve_model

    cfg = model.cfg
    b, s, gen = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    expect = expected_launches(cfg, gen)
    with MoeRecorder() as rec:
        warm = serve_model(model, b, s, gen, seed=0)
    torch.cuda.synchronize()
    drops = {"prefill": rec.dropped(lambda T: T == b * s), "decode": rec.dropped(lambda T: T == b)}
    del rec
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = serve_model(model, b, s, gen, seed=0)
    launches = dict(LAUNCHES)
    steps = gen - 1
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    emit("serve_moe", arch=MOE_ARCH, batch=b, prompt_len=s, gen=gen, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_experts=cfg.n_experts, top_k=cfg.top_k,
         expert_d_ff=cfg.expert_ff, vocab=cfg.vocab, capacity_factor=cfg.capacity_factor,
         reduced={"n_layers": f"{cfg.n_layers} of {DEPTH[MOE_ARCH][0]}"},
         n_params=cfg.n_params(), prefill_ms=1e3 * r["prefill_s"],
         decode_ms_per_step=1e3 * r["decode_s"] / steps,
         decode_tokens_per_s=b * steps / r["decode_s"], peak_mem_gb=peak_gb,
         launches=launches, expected_launches=expect, logits_finite=r["logits_finite"],
         dropped=drops, warmup_prefill_ms=1e3 * warm["prefill_s"],
         same_tokens_as_warmup=bool((warm["tokens"] == r["tokens"]).all()),
         sample_tokens=r["tokens"][0, :8].tolist())
    for name, n in launches.items():
        check(n == expect.get(name, 0),
              f"{MOE_ARCH}: {name} launches {n} != {expect.get(name, 0)}")
    check(r["logits_finite"] and warm["logits_finite"], f"{MOE_ARCH}: non-finite logits")
    check(r["tokens"].shape == (b, gen), f"{MOE_ARCH}: token shape")
    check(drops["prefill"]["calls"] == cfg.n_layers
          and drops["decode"]["calls"] == cfg.n_layers * steps,
          f"{MOE_ARCH}: recorded MoE calls {drops}")
    check(peak_gb < 80.0, f"{MOE_ARCH}: peak memory {peak_gb} GB")
    torch.cuda.empty_cache()
    return launches


def phase_moe_consistency(dev, model) -> None:
    """On the cut model at b 2, s 256: prefill + one decode step against a
    forward over s + 1 tokens under the dense oracle, in bf16, within
    ``consistency_tol`` of the largest logit; then the dispatch forward at
    capacity factor E / k (C = T: nothing can drop) against the dense
    forward over every position, in fp32 (the masters themselves, the bf16
    serving copy released) within the fp32 limit. In bf16 the two MoE paths
    round differently, and a rounding moves a token whose k-th and
    (k+1)-th router probabilities are near equal to another expert, which
    grows with depth: the JAX reference's own two paths differ by 0.13 of
    the largest logit at 16 layers in bf16 and agree to 1e-6 in fp32
    (tests/test_torch_model.py::test_moe_bf16_paths_diverge_as_in_the_reference).
    The bf16 reading is printed beside, unchecked."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    cfg = model.cfg
    b, s = MOE_CONSISTENCY
    toks = torch.randint(0, cfg.vocab, (b, s + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    cap = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    dense_cfg = dataclasses.replace(cfg, moe_impl="dense")
    rows = {}
    try:
        model.cfg = dense_cfg
        dense = model.forward_logits(toks)
        _, cache = model.prefill_step(toks[:, :s])
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
        logits, _ = model.serve_step(cache, toks[:, s:], s)
        del cache
        scale = dense[:, -1].abs().max().item()
        diff = (logits[:, 0] - dense[:, -1]).abs().max().item()
        rows["decode_vs_forward"] = {"dtype": cfg.dtype, "max_abs_diff": diff,
                                     "max_abs_logit": scale, "rel": diff / scale,
                                     "tol_rel": consistency_tol(cfg)}
        for dtype in (cfg.dtype, "float32"):
            model._compute = None                # the serving copy, in this dtype (none in fp32)
            model.cfg = dataclasses.replace(dense_cfg, dtype=dtype)
            dense = model.forward_logits(toks)
            model.cfg = dataclasses.replace(cap, dtype=dtype)
            with MoeRecorder() as rec:
                full_cap = model.forward_logits(toks)
            drops = rec.dropped(lambda T: True)
            scale_all = dense.abs().max().item()
            diff_all = (full_cap - dense).abs().max().item()
            rows[f"dispatch_vs_dense_{dtype}"] = {
                "capacity_factor": cap.capacity_factor, "capacity": drops["capacity"],
                "dropped": drops["dropped"], "max_abs_diff": diff_all,
                "max_abs_logit": scale_all, "rel": diff_all / scale_all,
                "tol_rel": consistency_tol(model.cfg) if dtype == "float32" else None}
            del dense, full_cap
            check(drops["dropped"] == 0, f"{MOE_ARCH}: pairs dropped at capacity E/k: {drops}")
    finally:
        model.cfg = cfg
        model._compute = None
    emit("moe_consistency", arch=MOE_ARCH, n_layers=cfg.n_layers, batch=b, seq=s, **rows)
    tol = consistency_tol(cfg)
    check(math.isfinite(diff) and diff <= tol * scale,
          f"{MOE_ARCH}: prefill+decode vs forward (dense): {diff} > {tol} * {scale}")
    r = rows["dispatch_vs_dense_float32"]
    check(math.isfinite(r["rel"]) and r["rel"] <= r["tol_rel"],
          f"{MOE_ARCH}: fp32 dispatch at E/k vs dense: {r}")


def phase_moe_card_vs_cpu(dev) -> None:
    """The reduced MoE configs in fp32 with the capacity dispatch: a forward,
    a prefill and ``MOE_DECODE_STEPS`` decode steps on the card and on the
    CPU from the same weights and tokens. Every MoE call keeps the same
    (token, k) pairs on both; some drop; the logits agree within
    ``MOE_CPU_TOL`` of the largest."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import splice_cache
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model

    for arch in MOE_REDUCED:
        cfg = get_config(arch).reduced()
        check(cfg.dtype == "float32" and cfg.moe_impl == "dispatch", f"{arch}: reduced config")
        host = make_model(cfg, device="cpu")
        host.init_params(torch.Generator().manual_seed(7))
        card = make_model(cfg, device=dev)
        card.load_params(host.state_dict())
        b, s = 2, 16
        toks = torch.randint(0, cfg.vocab, (b, s + MOE_DECODE_STEPS),
                             generator=torch.Generator().manual_seed(8))
        outs, recs = [], []
        for model in (host, card):
            t = toks.to(model.device)
            with MoeRecorder() as rec:
                logits = [model.forward_logits(t[:, :s])]
                last, pc = model.prefill_step(t[:, :s])
                logits.append(last)
                cache = model.init_cache(ShapeConfig("serve", s + MOE_DECODE_STEPS, b, "decode"))
                splice_cache(cache, pc)
                for i in range(MOE_DECODE_STEPS):
                    logits.append(model.serve_step(cache, t[:, s + i:s + i + 1], s + i)[0])
            outs.append([x.cpu() for x in logits])
            recs.append(rec)
        same = same_pairs(*recs)
        dropped = recs[0].dropped(lambda T: True)
        scale = max(x.abs().max().item() for x in outs[0])
        diff = max((a - c).abs().max().item() for a, c in zip(*outs))
        emit("moe_card_vs_cpu", arch=cfg.name, moe_every=cfg.moe_every,
             moe_shared=cfg.moe_shared, n_experts=cfg.n_experts, top_k=cfg.top_k,
             batch=b, seq=s, decode_steps=MOE_DECODE_STEPS, moe_calls=len(recs[1].calls),
             pairs=dropped["pairs"], dropped=dropped["dropped"],
             capacity=dropped["capacity"], same_keep_masks=same, max_abs_diff=diff,
             max_abs_logit=scale, tol_rel=MOE_CPU_TOL)
        check(same, f"{arch}: the card and the CPU keep different pairs")
        check(dropped["dropped"] > 0, f"{arch}: no pair dropped: {dropped}")
        check(math.isfinite(diff) and diff <= MOE_CPU_TOL * scale,
              f"{arch}: card vs CPU logits {diff} > {MOE_CPU_TOL} * {scale}")


# ---------------------------------------------------------------------- #
# phases 19-20: MoE training
# ---------------------------------------------------------------------- #
# the depth cut of the full-width training run: a layer holds 623 M
# parameters and every parameter takes 16 bytes on the card (fp32 master,
# gradient and both AdamW moments); 5 layers and the embedding and head
# hold 3.738 G (llama3.2-3b's 3.607 G peak at 63.77 GB), 6 would hold 4.361 G
MOE_TRAIN_DEPTH = 5
# steps held card against CPU: qwen3-moe's three AdamW steps; llama4's one
# Adafactor step, then two more whose losses are printed unchecked
MOE_TRAIN_CHECKED = {"qwen3-moe-30b-a3b": 3, "llama4-maverick-400b-a17b": 1}
MOE_TRAIN_UNCHECKED = {"qwen3-moe-30b-a3b": 0, "llama4-maverick-400b-a17b": 2}
TOP1_ROUTER = "blocks.moe.ffn.router"      # llama4's router: top_k 1
ROUTER_NOISE = 1e-6                        # of the largest |grad| of the model
# name parts of the kernels PyTorch launches for indexing, sorting, top-k,
# gathers and scatters (index_add, index and its accumulating backward,
# argsort, searchsorted, topk, scatter_add, embedding)
MOE_DISPATCH_KERNELS = ("index", "sort", "gather", "scatter", "topk", "searchsorted",
                        "embedding", "cub::", "radix")


def same_pairs(rec_a, rec_b) -> bool:
    """Whether two recorders saw the same MoE calls keep the same pairs."""
    import torch
    return len(rec_a.calls) == len(rec_b.calls) and all(
        (T0, C0) == (T1, C1) and torch.equal(k0.cpu(), k1.cpu())
        for (T0, C0, k0), (T1, C1, k1) in zip(rec_a.calls, rec_b.calls))


def phase_moe_train_consistency(dev) -> None:
    """The reduced MoE configs in fp32 with the capacity dispatch, card
    against CPU from the same weights and batches, each step as
    ``train_step`` runs it (``value_and_grad``, then ``apply_updates``)
    under ``MoeRecorder``: every MoE call of the checked steps keeps the
    same (token, k) pairs on both devices, and each step launches each
    attention kernel once a layer (remat is off in the reduced configs).

    qwen3-moe (AdamW): three steps held as ``phase_train_consistency``
    holds llama. llama4-maverick (Adafactor, a dense and a MoE layer a
    group, a shared expert, top-1): one step held at ``TRAIN_TOL`` on the
    loss and every parameter but the router. At top-1 the gate
    renormalised over the top-k is g / g = 1, so the router's gradient is
    zero in exact arithmetic and each device returns its own rounding
    noise, below ``ROUTER_NOISE`` of the largest gradient on both;
    Adafactor divides that noise by the root of its factored second
    moment and moves the router by a step of lr's order in a direction
    the noise picks (the JAX reference does the same: ROADMAP.md, Known
    differences). The two devices' routers part there, and with them the
    losses of the next steps, which are printed unchecked beside."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.model import make_model
    from repro_torch.optim.adamw import OptConfig, apply_updates

    for arch in MOE_REDUCED:
        cfg = get_config(arch).reduced()
        check(cfg.dtype == "float32" and cfg.moe_impl == "dispatch" and not cfg.remat,
              f"{arch}: reduced config")
        router = TOP1_ROUTER if cfg.top_k == 1 else None
        opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
        host = make_model(cfg, device="cpu", opt=opt)
        host.init_params(torch.Generator().manual_seed(6))
        card = make_model(cfg, device=dev, opt=opt)
        card.load_params(host.state_dict())
        pipe = SyntheticTokenPipeline(cfg, ShapeConfig("smoke_train", 32, 8, "train"),
                                      DataConfig())
        states = [host.init_opt(), card.init_opt()]
        checked = MOE_TRAIN_CHECKED[arch]
        steps = checked + MOE_TRAIN_UNCHECKED[arch]
        reset_launches()
        rows, unchecked = [], []
        for step in range(steps):
            batch = pipe.batch_at(step)
            losses, recs, noise = [], [], []
            for i, model in enumerate((host, card)):
                tb = {n: torch.from_numpy(a).to(model.device, torch.long)
                      for n, a in batch.items()}
                with MoeRecorder() as rec:
                    loss, grads = model.value_and_grad(tb)
                if router:
                    largest = max(g.abs().max().item() for g in grads.values())
                    noise.append(grads[router].abs().max().item() / largest)
                states[i] = apply_updates(model.masters(), grads, states[i], model.opt)
                losses.append(loss.item())
                recs.append(rec)
            rel = abs(losses[1] - losses[0]) / abs(losses[0])
            dropped = recs[0].dropped(lambda T: True)
            row = {"step": step, "loss_cpu": losses[0], "loss_card": losses[1], "rel": rel,
                   "same_keep_masks": same_pairs(*recs), "moe_calls": len(recs[1].calls),
                   "dropped": dropped["dropped"], "pairs": dropped["pairs"]}
            if router:
                row["router_grad_share_cpu"], row["router_grad_share_card"] = noise
            if step >= checked:
                unchecked.append(row)
                continue
            rows.append(row)
            check(math.isfinite(losses[1]) and rel <= TRAIN_TOL,
                  f"{arch} train step {step}: card loss {losses[1]} vs CPU {losses[0]}")
            check(row["same_keep_masks"] and row["moe_calls"] == cfg.n_layers // cfg.moe_every,
                  f"{arch} train step {step}: the card and the CPU keep different pairs")
            check(not router or max(noise) < ROUTER_NOISE,
                  f"{arch} train step {step}: router gradient shares {noise}")
            if step == checked - 1:
                hp, cp = host.masters(), card.masters()
                scale = max(t.abs().max().item() for t in hp.values())
                diff = {name: (cp[name].cpu() - t).abs().max().item()
                        for name, t in hp.items()}
                held = {name: d for name, d in diff.items() if name != router}
                worst = max(held, key=held.get)
                check(held[worst] <= TRAIN_TOL * scale,
                      f"{arch} params after {checked} steps: {worst} {held[worst]} > "
                      f"{TRAIN_TOL} * {scale}")
                param_row = {"max_param_diff": held[worst], "worst_param": worst,
                             "max_abs_param": scale,
                             "router_param_diff": diff[router] if router else None}
        launches = dict(LAUNCHES)
        expect = {k: steps * n for k, n in per_step_launches(cfg).items()}
        check(all(launches[k] == expect.get(k, 0) for k in launches),
              f"{arch} MoE train consistency launches {launches}, expected {expect}")
        emit("moe_train_consistency", arch=cfg.name, dtype=cfg.dtype, optimizer=cfg.optimizer,
             top_k=cfg.top_k, moe_every=cfg.moe_every, moe_shared=cfg.moe_shared,
             steps=rows, unchecked_steps=unchecked, **param_row, tol=TRAIN_TOL,
             router_noise_tol=ROUTER_NOISE if router else None, launches=launches)


def moe_train_readings(dev, cfg, res) -> None:
    """Unchecked readings of the full-width MoE training run, on one more
    step's batch from the trained state: the gradients computed twice,
    whether the two are bit-identical (the backward of ``xn[tok]`` and of
    the gather back add up rows of repeated indices) and their largest
    difference; under ``MoeRecorder`` on the first of the two, the
    share of (token, k) pairs the capacity drops in the forward, and
    whether remat's recomputed forward chose the same pairs as the forward
    (checked: the backward is taken through the recompute)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline

    rt = res["runtime"]
    model = rt.model
    batch_np = SyntheticTokenPipeline(rt.cfg, rt.shape, DataConfig()).batch_at(TRAIN["steps"])
    tb = {n: torch.from_numpy(a).to(dev, torch.long) for n, a in batch_np.items()}
    with MoeRecorder() as rec:
        _, grads = model.value_and_grad(tb)
    first = {n: g.cpu() for n, g in grads.items()}
    del grads
    _, grads = model.value_and_grad(tb)
    torch.cuda.synchronize()
    diff, equal = {}, True
    for n, g in grads.items():
        ref = first.pop(n).to(dev)
        equal = equal and torch.equal(g, ref)
        diff[n] = (g - ref).abs().max().item()
        del ref
    del grads
    L = cfg.n_layers
    # the backward recomputes the layers last to first
    fwd, again = rec.calls[:L], rec.calls[L:][::-1]
    remat_same = len(again) == L and all(
        C0 == C1 and torch.equal(k0, k1) for (_, C0, k0), (_, C1, k1) in zip(fwd, again))
    T = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
    drops = rec.dropped(lambda n: n == T)
    kept = sum(int(k.sum().item()) for _, _, k in fwd)
    worst = max(diff, key=diff.get)
    emit("train_moe", arch=cfg.name, reading="one step's forward and gradients",
         moe_calls=len(rec.calls), forward_calls=len(fwd),
         dropped_share=(L * T * cfg.top_k - kept) / (L * T * cfg.top_k),
         capacity=drops["capacity"], share_by_layer=drops["share_by_call"][:L],
         remat_same_pairs=remat_same, grads_bit_identical=equal,
         max_grad_diff=diff[worst], worst_grad=worst)
    check(len(rec.calls) == 2 * L, f"{cfg.name}: {len(rec.calls)} MoE calls under remat")
    check(remat_same, f"{cfg.name}: remat's recomputed forward kept other pairs")


def phase_train_moe(dev) -> dict:
    """``run_training`` of qwen3-moe-30b-a3b at full width (checked against
    ``MOE_WIDTH`` first) with its depth cut to ``MOE_TRAIN_DEPTH`` of 48
    layers, as ``phase_train`` runs llama: the launch counts, the losses,
    the events and the peak; then ``moe_train_readings`` and a profiled
    step."""
    from repro_torch.configs import get_config

    full = get_config(MOE_ARCH)
    check(all(getattr(full, k) == v for k, v in MOE_WIDTH.items())
          and full.family == "moe" and full.moe_every == 1 and full.moe_impl == "dispatch",
          f"{MOE_ARCH}: full-width config")
    return phase_train(dev, MOE_ARCH, n_layers=MOE_TRAIN_DEPTH, readings=moe_train_readings,
                       phase="train_moe")


def kernel_classes(rows) -> dict:
    """Device ms of profiler rows by kind: the attention and SSD kernels,
    matrix products (cuBLAS and CUTLASS), the index, sort, gather and
    scatter kernels (``moe_dispatch``: the MoE dispatch's routing, ranks,
    scatter into the buffer, gathers and their backward; in any model also
    the embedding's lookup and the loss's gather, which are small),
    elementwise and reduction kernels, copies, the rest."""
    classes = {"attention_fwd": 0.0, "attention_bwd": 0.0, "ssd_fwd": 0.0, "ssd_bwd": 0.0,
               "ssd_scores": 0.0, "matmul": 0.0, "moe_dispatch": 0.0, "elementwise": 0.0,
               "reduction": 0.0, "copy": 0.0, "other": 0.0}
    for ms, _, key in rows:
        k = key.lower()
        if "flash_fwd" in k:
            cls = "attention_fwd"
        elif "flash_bwd" in k:
            cls = "attention_bwd"
        elif "ssd_chunk_kernel" in k:
            cls = "ssd_fwd"
        elif "ssd_bwd" in k:
            cls = "ssd_bwd"
        elif "ssd_scores_kernel" in k:     # C B^T and seg: in the forward and the backward
            cls = "ssd_scores"
        elif any(t in k for t in ("gemm", "nvjet", "xmma", "cutlass")):
            cls = "matmul"
        elif any(t in k for t in MOE_DISPATCH_KERNELS):
            cls = "moe_dispatch"
        elif "elementwise" in k:
            cls = "elementwise"
        elif "reduce" in k:
            cls = "reduction"
        elif "memcpy" in k or "memset" in k:
            cls = "copy"
        else:
            cls = "other"
        classes[cls] += ms
    return classes


def main() -> int:
    # the training phase holds about 64 of the card's 80 GB in tensors of up
    # to 2.8 GB: segments that grow in place keep the caching allocator from
    # splitting the card into pieces that no longer fit them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
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
    libs = build.build(["flash_attention", "feasibility", "ssd_chunk"])
    build_s = time.perf_counter() - t0
    ptxas = []
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            text = log.read_text()
            print(text, file=sys.stderr)
            ptxas += ptxas_report(text)
    decode = decode_ptxas(ptxas)
    emit("env", device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()], ptxas=ptxas,
         decode_ptxas=decode)
    check(len(decode) == DECODE_INSTANTIATIONS,
          f"ptxas reports {len(decode)} decode instantiations, not {DECODE_INSTANTIATIONS}")
    spilled = [r for r in decode if r["spill_stores"] or r["spill_loads"]]
    check(not spilled, f"decode instantiations spill: {spilled}")
    ssd = [r for r in ptxas if any(k in r["kernel"] for k in SSD_KERNELS)]
    check(len(ssd) == len(SSD_KERNELS), f"ptxas reports {len(ssd)} SSD kernels")
    spilled = [r for r in ssd if r.get("spill_stores") or r.get("spill_loads")]
    check(not spilled, f"SSD kernels spill: {spilled}")
    feas = [r for r in ptxas if "feasible_kernel" in r["kernel"]]
    emit("env", feasibility_ptxas=feas)
    check(len(feas) == FEASIBILITY_INSTANTIATIONS,
          f"ptxas reports {len(feas)} feasibility instantiations, not "
          f"{FEASIBILITY_INSTANTIATIONS}")
    spilled = [r for r in feas if r.get("spill_stores") or r.get("spill_loads")]
    check(not spilled, f"feasibility kernels spill: {spilled}")
    drive(dev, smi, ptxas)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def drive(dev, smi: str, ptxas: list) -> None:
    """Every phase after the build, then the kernel table and the card's
    name and power limit. Raises at the first failed check."""
    import torch

    # each main path's launch counts, read around exactly its run
    paths = {}
    timed = phase_kernels(dev)
    paths["serve llama3.2-3b"] = phase_serve(dev, ARCH, **SERVE)
    model = phase_consistency(dev, ARCH)
    phase_profile(dev, model)
    del model
    torch.cuda.empty_cache()

    timed["ssd_chunk"] = phase_ssm_kernels(dev)
    torch.cuda.empty_cache()
    for arch, gen in SSM_GEN.items():
        paths[f"serve {arch}"] = phase_serve(dev, arch, SERVE["batch"], SERVE["prompt_len"],
                                             gen, phase="serve_ssm")
    for arch, dtype in (("zamba2-2.7b", "float32"), ("zamba2-2.7b", "bfloat16"),
                        ("mamba2-2.7b", "float32")):
        model = phase_consistency(dev, arch, dtype)
        del model
        torch.cuda.empty_cache()
    model = phase_consistency(dev, "mamba2-2.7b")
    phase_profile(dev, model)
    del model
    torch.cuda.empty_cache()

    sched = phase_schedule_kernels(dev)
    timed["feasibility"] = sched["feasibility"]
    paths["schedule quartz"] = {"feasibility": phase_schedule(dev, sched["sweep_ms"])}
    torch.cuda.empty_cache()

    timed["flash_attention_bwd"] = phase_train_kernels(dev, ptxas)
    torch.cuda.empty_cache()
    phase_train_consistency(dev)
    paths[f"train {ARCH}"] = phase_train(dev)

    timed["ssd_chunk_bwd"] = phase_ssm_train_kernels(dev, ptxas)
    torch.cuda.empty_cache()
    for arch in SSM_TRAIN_ARCHS:
        phase_train_consistency(dev, arch)
    for arch in SSM_TRAIN_ARCHS:
        paths[f"train {arch}"] = phase_train(dev, arch, profile=arch == "mamba2-2.7b")
    torch.cuda.empty_cache()

    model = moe_serving_model(dev)
    paths[f"serve {MOE_ARCH}"] = phase_serve_moe(dev, model)
    phase_profile(dev, model, steps=1)
    phase_moe_consistency(dev, model)
    del model
    torch.cuda.empty_cache()
    phase_moe_card_vs_cpu(dev)
    phase_moe_train_consistency(dev)
    paths[f"train {MOE_ARCH}"] = phase_train_moe(dev)
    torch.cuda.empty_cache()

    csrc = "src/repro_torch/kernels/csrc/"
    rows = {"flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:87"),
            # no Pallas backward: JAX differentiates its einsum attention with XLA
            "flash_attention_bwd": ("flash_attention.cu", "src/repro/models/layers.py:210"),
            "flash_decode": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:179"),
            "feasibility": ("feasibility.cu", "src/repro/kernels/feasibility.py:93"),
            "ssd_chunk": ("ssd_chunk.cu", "src/repro/kernels/ssd_scan.py:71"),
            # no Pallas backward: JAX differentiates the jnp ssd_chunked with XLA
            "ssd_chunk_bwd": ("ssd_chunk.cu", "src/repro/models/mamba2.py:192")}
    table = []
    for name, (src, replaces) in rows.items():
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        check(by_path, f"{name}: launched on no main path")
        table.append({"name": name, "route": "cuda", "source": csrc + src, "replaces": replaces,
                      "launches": sum(by_path.values()), "launches_by_path": by_path,
                      **timed[name]})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    sys.exit(main())
