#!/usr/bin/env python3
"""Read the bf16 attention backward's checks against faults planted in its
kernels, on one NVIDIA card.

    python3 tools/attention_bwd_faults.py

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one change made by text substitution, as in ``tools/ssd_chunk_variants.py``:
an edit to a quoted line makes the script stop with the substitution that
no longer matches. All are built with ``nvcc`` for ``sm_90a`` into
``build/bwd_faults/``, started together, and called through the port's own
wrapper (``flash_attention_bwd``, its library swapped for the variant's):

- ``base``: the kernels as they are: the sound readings;
- ``dkdv_drop_{first,mid,last}``: the dK/dV kernel drops the last (query
  head, 64-row query tile) pair of its group in the first, the middle or
  the last key tile of every (batch, kv head): one tile's missing terms;
- ``dkdv_diag``: its straddle test takes a diagonal step whose first key
  is at or before its first query row as unmasked, so keys past a row
  leak into dK and dV;
- ``dq_drop_{mid,last}``: the dQ kernel drops the first key tile of the
  middle or the last query tile of every (batch, head);
- ``dq_diag``: the dQ kernel's straddle test off the same way.

Every variant runs the bf16 cases of ``chip_smoke.py``'s ``BWD_CASES``
(``base`` also the fp32 ones, which launch other kernels), on the inputs
that script draws, against ``ref_attention_bwd``. Per gradient it reports
the max check's share (max |g - r| / max |r|, limit ``BWD_TOL``), the
whole-tensor ||g - r|| / ||r|| and the largest over 64-row tiles
(``tile_rel_err``, limit ``BWD_TILE_TOL``). Prints one JSON line per
variant and case, a summary line, then the card's name and power limit as
``nvidia-smi`` prints them. Exits 1 if ``base`` fails a check or a fault
passes the tile check in every case.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.ref import tile_rel_err  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "bwd_faults"
DKDV_SKIP = "      if (qs0 >= sq || kw0 >= skv ||\n"
DQ_SKIP = "      if (!warp_rows || kb0 >= skv ||\n"


def dkdv_drop(tile: str):
    return [(DKDV_SKIP, DKDV_SKIP.replace(
        "kw0 >= skv ||", f"kw0 >= skv || (blockIdx.z == {tile} && i == n_tiles - 1) ||"))]


def dq_drop(tile: str):
    return [(DQ_SKIP, DQ_SKIP.replace(
        "kb0 >= skv ||", f"kb0 >= skv || (qt == {tile} && j == 0) ||"))]


VARIANTS = {
    "base": [],
    "dkdv_drop_first": dkdv_drop("0"),
    "dkdv_drop_mid": dkdv_drop("gridDim.z / 2"),
    "dkdv_drop_last": dkdv_drop("gridDim.z - 1"),
    "dkdv_diag": [("(causal && (kw0 + 15 > qp_lo ||", "(causal && (kw0 > qp_lo ||")],
    "dq_drop_mid": dq_drop("gridDim.z / 2"),
    "dq_drop_last": dq_drop("gridDim.z - 1"),
    "dq_diag": [("  // straddles an edge\n      const bool edge = kb0 + KH > skv ||\n"
                 "                        (causal && (kb0 + KH - 1 > wq_lo ||",
                 "  // straddles an edge\n      const bool edge = kb0 + KH > skv ||\n"
                 "                        (causal && (kb0 > wq_lo ||")],
}


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"attention_bwd_faults: substitution does not match: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name, subs in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(text, subs))
        procs[name] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"attention_bwd_faults: nvcc failed for {name}:\n{log}")
        libs[name] = fa.bind(ctypes.CDLL(str(OUT / f"lib{name}.so")))
    return libs


def readings(grads, refs, dtype: str) -> dict:
    out = {"max_rel": {}, "norm_rel": {}, "tile_rel": {}}
    for gname, g, r in zip(("dq", "dk", "dv"), grads, refs):
        out["max_rel"][gname] = ((g.float() - r.float()).abs().max()
                                 / r.float().abs().max()).item()
        out["norm_rel"][gname] = cs.norm_rel_err(g, r)
        out["tile_rel"][gname] = tile_rel_err(g, r)
    out["caught_by_max"] = not all(x <= cs.BWD_TOL[dtype] for x in out["max_rel"].values())
    out["caught_by_tile"] = not all(x <= cs.BWD_TILE_TOL[dtype]
                                    for x in out["tile_rel"].values())
    return out


def main() -> int:
    import torch
    from repro_torch.kernels.ref import ref_attention_bwd

    if not torch.cuda.is_available():
        print("attention_bwd_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs = build_variants()
    gen = torch.Generator(device=dev).manual_seed(5)       # chip_smoke's draws
    tops = {name: [] for name in libs}          # each case's largest tile reading
    caught = {name: {"max": 0, "tile": 0} for name in libs}
    for case, (b, h, kvh, sq, skv, d), window, dtype, layout in cs.BWD_CASES:
        q, k, v, dO = cs.bwd_inputs(gen, dev, b, h, kvh, sq, skv, d, dtype, layout)
        o, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
        refs = ref_attention_bwd(q, k, v, o, lse, dO, window=window)
        for name, lib in libs.items():
            if dtype != "bfloat16" and name != "base":
                continue
            with mock.patch.object(fa, "_lib", lambda: lib):
                grads = fa.flash_attention_bwd(q, k, v, o, lse, dO, window=window)
            torch.cuda.synchronize()
            row = readings(grads, refs, dtype)
            print(json.dumps({"variant": name, "case": case, "dtype": dtype, **row}), flush=True)
            tops[name].append(max(row["tile_rel"].values()))
            caught[name]["max"] += row["caught_by_max"]
            caught[name]["tile"] += row["caught_by_tile"]
    summary = {name: {"cases": len(tops[name]), "caught_by_max": caught[name]["max"],
                      "caught_by_tile": caught[name]["tile"], "tile_rel_least": min(tops[name]),
                      "tile_rel_most": max(tops[name])} for name in libs}
    print(json.dumps({"summary": summary, "tile_tol": cs.BWD_TILE_TOL, "tol": cs.BWD_TOL}),
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    base = summary["base"]
    escaped = [n for n, s in summary.items() if n != "base" and not s["caught_by_tile"]]
    if base["caught_by_max"] or base["caught_by_tile"] or escaped:
        print(f"attention_bwd_faults: base caught {base}, faults the tile check misses "
              f"{escaped}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
