#!/usr/bin/env python3
"""Time variants of the SSD chunk kernels side by side on one NVIDIA card.

    python3 tools/ssd_chunk_variants.py

Each variant is ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` with one
change made by text substitution: the substitutions quote the source, so
an edit to a quoted line makes the script stop with the substitution
that no longer matches, and the quote is brought up to date with it. All
are built with ``nvcc`` for ``sm_90a`` into ``build/ssd_variants/``,
started together, and called through the port's own wrapper
(``repro_torch.kernels.ssd_scan.ssd_chunk``, its library swapped for the
variant's). They are timed in turns (every variant, then every variant
in reverse order) at the mamba2-2.7b and zamba2-2.7b serving shapes:
CUDA events around 30 calls of both launches, and the share of the fp32
tolerance (atol = rtol = 1e-4) each variant uses against
``ref_ssd_chunk``. Some variants are diagnostics that drop work and miss
the tolerance; they say what that work costs:

- ``base``: the kernels as they are;
- ``unroll2``: the k-step loop unrolled twice;
- ``chain``: the three products of every k-step summed into the running
  accumulators on the tensor cores (no fp32 adds between k-steps);
- ``one_pass`` (diagnostic): one TF32 product instead of three;
- ``no_state`` (diagnostic): no state fragments;
- ``no_sload`` (diagnostic): y's scores loaded for the first k-step only;
- ``seg_unroll32``: the seg loop unrolled 32 steps (dt read further ahead
  of the sum);
- ``seg_fp32`` (diagnostic): seg as one fp32 summed in sequence, its low
  part dropped in both kernels (the arithmetic before seg was kept as an
  exact pair), which says what the pair costs in time and in accuracy.

Prints one JSON line per variant and shape, then the card's name and
power limit as ``nvidia-smi`` prints them.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from _variants import build_variants  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_chunk.cu"
OUT = ROOT / "build" / "ssd_variants"
SHAPES = {"mamba2": (8, 512, 80, 64, 1, 128, 256), "zamba2": (8, 512, 80, 64, 1, 64, 256)}
ITERS = 30
TOL = 1e-4
THREE = ("  for (int n = 0; n < NF; ++n) mma_tf32_zero(d[n], al, bh[n][0], bh[n][1]);\n"
         "#pragma unroll\n"
         "  for (int n = 0; n < NF; ++n) mma_tf32(d[n], ah, bl[n][0], bl[n][1]);\n"
         "#pragma unroll\n"
         "  for (int n = 0; n < NF; ++n) mma_tf32(d[n], ah, bh[n][0], bh[n][1]);\n")
ADD = ("#pragma unroll\n"
       "  for (int n = 0; n < NF; ++n)\n"
       "#pragma unroll\n"
       "    for (int r = 0; r < 4; ++r) acc[n][r] += d[n][r];\n")
VARIANTS = {
    "base": [],
    "unroll2": [("#pragma unroll 1\n    for (int kk = 0;", "#pragma unroll 2\n    for (int kk = 0;")],
    "chain": [("  float d[NF][4];\n", ""),
              (THREE + ADD, THREE.replace("d[n]", "acc[n]").replace("mma_tf32_zero", "mma_tf32"))],
    "one_pass": [(THREE, "  for (int n = 0; n < NF; ++n) mma_tf32_zero(d[n], ah, bh[n][0], bh[n][1]);\n")],
    "no_state": [("const bool has_s = warp < rn;", "const bool has_s = false;")],
    "no_sload": [("next[q] = __ldcg(sf + (static_cast<long long>(ry[q]) * k8 + ks + 1) * 32);",
                  "next[q] = make_float4(sv.y, sv.z, sv.w, sv.x);")],
    "seg_unroll32": [("#pragma unroll 8\n      for (int i = 0; i < Q; ++i) {\n        acc +=",
                      "#pragma unroll 32\n      for (int i = 0; i < Q; ++i) {\n        acc +=")],
    "seg_fp32": [
        ("      double acc = 0.0;\n", ""),
        ("        acc += static_cast<double>(__fmul_rn(dp[i * st.ds], a));   // no FMA contraction\n"
         "        hi = __double2float_rn(acc);\n",
         "        hi = __fadd_rn(hi, __fmul_rn(dp[i * st.ds], a));\n"),
        ("        seg_lo[o + static_cast<long long>(i) * H] = __double2float_rn(acc - hi);\n", ""),
        # the forward's loads (the backward's own copies are followed by others)
        ("sSegLo[i] = i < Q ? seg_lo[so + static_cast<long long>(i) * H] : 0.f;\n"
         "    sDt[i] = i < Q ? dp[i * st.ds] : 0.f;\n  }",
         "sSegLo[i] = 0.f;\n    sDt[i] = i < Q ? dp[i * st.ds] : 0.f;\n  }"),
        ("sW[i] = i < Q ? expf((total - sSeg[i]) + (total_lo - sSegLo[i])) : 0.f;\n\n",
         "sW[i] = i < Q ? expf(total - sSeg[i]) : 0.f;\n\n"),
        ("exp_fast((segi[q][0] - sj0) + (segi_lo[q][0] - lj0))", "exp_fast(segi[q][0] - sj0)"),
        ("exp_fast((segi[q][1] - sj0) + (segi_lo[q][1] - lj0))", "exp_fast(segi[q][1] - sj0)"),
        ("exp_fast((segi[q][0] - sj1) + (segi_lo[q][0] - lj1))", "exp_fast(segi[q][0] - sj1)"),
        ("exp_fast((segi[q][1] - sj1) + (segi_lo[q][1] - lj1))", "exp_fast(segi[q][1] - sj1)")],
}


def build() -> dict:
    libs, logs = build_variants("ssd_chunk_variants", SOURCE, OUT, VARIANTS, ssd_scan.bind)
    for name, log in logs.items():
        print(json.dumps({"variant": name, "registers": re.findall(r"Used (\d+) registers", log),
                          "spill_stores": re.findall(r"(\d+) bytes spill stores", log)}),
              flush=True)
    return libs


def main() -> int:
    import numpy as np
    import torch
    from repro_torch.kernels.ref import ref_ssd_chunk

    if not torch.cuda.is_available():
        print("ssd_chunk_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = build()
    rng = np.random.default_rng(0)
    for shape_name, (b, s, H, P, G, N, Q) in SHAPES.items():
        arrays = [rng.standard_normal((b, s, H, P), np.float32),
                  np.logaddexp(rng.standard_normal((b, s, H)), 0).astype(np.float32),
                  -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32),
                  rng.standard_normal((b, s, G, N), np.float32),
                  rng.standard_normal((b, s, G, N), np.float32)]
        x, dt, A, B, C = (torch.from_numpy(a).to(dev) for a in arrays)
        ref = ref_ssd_chunk(x, dt, A, B, C, Q)

        def call(lib):
            with mock.patch.object(ssd_scan, "_lib", lambda: lib):
                return ssd_scan.ssd_chunk(x, dt, A, B, C, Q)

        times = {name: [] for name in libs}
        share = {}
        for name in list(libs) + list(libs)[::-1]:
            out = call(libs[name])
            torch.cuda.synchronize()
            share[name] = max(((o - r).abs() / (TOL + TOL * r.abs())).max().item()
                              for o, r in zip(out, ref))
            for _ in range(3):
                call(libs[name])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(ITERS):
                call(libs[name])
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / ITERS)
        for name in libs:
            print(json.dumps({"variant": name, "shape": shape_name, "event_ms": times[name],
                              "tol_share": share[name]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
