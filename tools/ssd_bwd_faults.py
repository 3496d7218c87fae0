#!/usr/bin/env python3
"""Read the SSD chunk backward's checks against faults planted in its
kernels, on one NVIDIA card.

    python3 tools/ssd_bwd_faults.py

Each variant is ``src/repro_torch/kernels/csrc/ssd_chunk.cu`` with one
change made by text substitution, as in ``tools/attention_bwd_faults.py``:
an edit to a quoted line makes the script stop with the substitution that
no longer matches. All are built with ``nvcc`` for ``sm_90a`` into
``build/ssd_bwd_faults/``, started together, and called through the port's
own wrapper (``ssd_chunk_bwd``, its library swapped for the variant's):

- ``base``: the kernels as they are: the sound readings;
- ``head_dropped``: each group's fixed-order head sum leaves out its last
  head (the last slice of the pair and state kernels stops one head short),
  so gB and gC miss one head's share of G_S and of the state term;
- ``no_state_term``: gB without its state term sum_h w o (u gstate^T);
- ``gdA_off_by_one``: the head kernel's row sums of R take keys j <= i in
  place of j < i, while its column sums keep j < i; only a diagonal tile
  holds j = i, and g(dA_k) then takes R_ii of every row i < k;
- ``gM_tile_skipped``: gM of key tile 0 for row tile 1 is taken as 0 (in R
  in the head kernel, in G_S in the pair kernel), where the chunk holds two
  tiles or more.

Every variant runs ``chip_smoke.py``'s ``SSD_BWD_CASES`` on the inputs
that script draws, against ``ref_ssd_chunk_bwd``. Per gradient it reports
the max check's share (max |g - r| / max |r|, limit ``SSD_TOL``), the
whole-tensor ||g - r|| / ||r|| and the largest over (batch, chunk, head
or group) tiles (``ssd_bwd_tiles``, limit ``SSD_BWD_TILE_TOL``). Prints
one JSON line per variant and case, a summary line, then the card's name
and power limit as ``nvidia-smi`` prints them. Exits 1 if ``base`` fails
a check or a fault passes the tile check in every case.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from _variants import build_variants  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "ssd_chunk.cu"
OUT = ROOT / "build" / "ssd_bwd_faults"
H1 = "h1 = g * hpg + (sl + 1) * hpg / ns;"
H1_LESS = "h1 = g * hpg + (sl + 1) * hpg / ns - (sl + 1 == ns);"
GM_DONE = "      // S of these rows and keys in A-fragment order, from the scores\n"
VARIANTS = {
    "base": [],
    "head_dropped": [(H1 + "\n  int it = 0;", H1_LESS + "\n  int it = 0;"),
                     (H1 + "\n  const int J0", H1_LESS + "\n  const int J0")],
    "no_state_term": [("        v += a;\n", "")],
    "gdA_off_by_one": [("            rsum[hr] += rr;\n",
                        "            rsum[hr] += j == i ? gm[n][2 * hr + hc] * m : rr;\n")],
    "gM_tile_skipped": [(GM_DONE, "      if (it == 1 && jt == 0)\n"
                                  "        for (auto& f : gm) for (float& e : f) e = 0.f;\n"
                         + GM_DONE),
                        ("acc[e] += gm[e] * L[e];", "acc[e] += (p == 1 ? 0.f : gm[e]) * L[e];")],
}


def readings(grads, refs, Q: int) -> dict:
    import torch
    out = {"max_rel": {}, "norm_rel": {}, "tile_rel": cs.ssd_bwd_tiles(grads, refs, Q)}
    for gname, g, r in zip(cs.SSD_BWD_GRADS, grads, refs):
        out["max_rel"][gname] = ((g - r).abs().max() / r.abs().max()).item()
        out["norm_rel"][gname] = cs.norm_rel_err(g, r)
    out["finite"] = all(bool(torch.isfinite(g).all()) for g in grads)
    out["caught_by_max"] = not (out["finite"] and all(
        x <= cs.SSD_TOL for x in out["max_rel"].values()))
    out["caught_by_tile"] = not (out["finite"] and all(
        x <= cs.SSD_BWD_TILE_TOL for x in out["tile_rel"].values()))
    return out


def main() -> int:
    import torch
    from repro_torch.kernels.ref import ref_ssd_chunk_bwd

    if not torch.cuda.is_available():
        print("ssd_bwd_faults: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    libs, _ = build_variants("ssd_bwd_faults", SOURCE, OUT, VARIANTS, ssd_scan.bind)
    gen = torch.Generator(device=dev).manual_seed(7)       # chip_smoke's draws
    tops = {name: [] for name in libs}          # each case's largest tile reading
    caught = {name: {"max": 0, "tile": 0} for name in libs}
    for case, (b, s, H, P, G, N, Q), strided in cs.SSD_BWD_CASES:
        inputs, outs = cs.ssd_bwd_inputs(gen, dev, b, s, H, P, G, N, Q, strided)
        refs = ref_ssd_chunk_bwd(*inputs, Q, *outs)
        for name, lib in libs.items():
            with mock.patch.object(ssd_scan, "_lib", lambda: lib):
                grads = ssd_scan.ssd_chunk_bwd(*inputs, Q, *outs)
            torch.cuda.synchronize()
            row = readings(grads, refs, Q)
            print(json.dumps({"variant": name, "case": case, "shape": [b, s, H, P, G, N, Q],
                              **row}), flush=True)
            tops[name].append(max(row["tile_rel"].values()))
            caught[name]["max"] += row["caught_by_max"]
            caught[name]["tile"] += row["caught_by_tile"]
            del grads
        del inputs, outs, refs
    summary = {name: {"cases": len(tops[name]), "caught_by_max": caught[name]["max"],
                      "caught_by_tile": caught[name]["tile"], "tile_rel_least": min(tops[name]),
                      "tile_rel_most": max(tops[name])} for name in libs}
    print(json.dumps({"summary": summary, "tile_tol": cs.SSD_BWD_TILE_TOL, "tol": cs.SSD_TOL}),
          flush=True)
    print(cs.nvidia_smi(), flush=True)
    base = summary["base"]
    escaped = [n for n, s in summary.items() if n != "base" and not s["caught_by_tile"]]
    if base["caught_by_max"] or base["caught_by_tile"] or escaped:
        print(f"ssd_bwd_faults: base caught {base}, faults the tile check misses {escaped}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
