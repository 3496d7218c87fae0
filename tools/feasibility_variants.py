#!/usr/bin/env python3
"""Time the feasibility kernel beside variants of it, and beside another
checkout's, on one NVIDIA card.

    python3 tools/feasibility_variants.py [--parent DIR]

Each variant is ``src/repro_torch/kernels/csrc/feasibility.cu`` with one
change made by text substitution, as in ``tools/ssd_chunk_variants.py``:
an edit to a quoted line makes the script stop with the substitution that
no longer matches. All are built with ``nvcc`` for ``sm_90a`` into
``build/feasibility_variants/``, started together, and called through the
port's own wrapper (``repro_torch.kernels.feasibility.feasible_mask``, its
library swapped for the variant's, its ``VPT`` and ``THREADS`` set to the
variant's):

- ``base``: the kernel as it is (VPT 2, 256 threads; each thread stores
  its mask bytes where it computes them);
- ``vpt2_t128``, ``vpt4``, ``vpt4_t128``, ``vpt8``, ``vpt8_t128``: the
  other launch plans, VPT vertices a thread in blocks of 256 threads, or
  of 128 where named;
- ``staged``: the mask staged in shared memory as the block's [rows,
  VPT threads] tile (each row shifted by its start's offset within 16
  bytes) and, after a block barrier, written a warp a row with 16-byte
  stores over each row's aligned middle and single bytes at its ends;
- ``staged_warp``: the same tile, but each warp writes its own 32 VPT
  vertices of every row after a warp barrier only;
- ``loads`` (diagnostic): each thread issues its vertex loads, waits for
  them and returns: the launch, the ramp and one round trip to device
  memory;
- ``empty`` (diagnostic): every block returns at once: the launch and the
  ramp of this grid.

``--parent DIR`` adds ``parent``: the feasibility kernel of a checkout of
another commit at DIR, built from its own source and called through its C
entry point as it was before the launch plan existed (one vertex a
thread, 256 threads a block). All are timed in turns (each, then each in
reverse order) at LLNL Quartz's size (6 request shapes, 117,703 vertices,
4 types) over 16 copies of the inputs (74 MB, more than the 50 MB L2):
device time under torch.profiler and CUDA events around 160 calls, as
``chip_smoke.py`` times the kernel. Every variant but the diagnostics is
held bit-exact against ``ref_feasible`` first; one that differs is
reported, not timed, and the script then exits 1.

Prints one JSON line per variant, then the card's name and power limit
as ``nvidia-smi`` prints them.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402  (timers, the Quartz inputs)
from repro_torch.kernels import build as kbuild, feasibility  # noqa: E402

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "feasibility.cu"
OUT = ROOT / "build" / "feasibility_variants"
LOADS_END = "  // request row u0 + lane (the last row for lanes past it), need padded\n"
BODY = "  const int u0 = blockIdx.y * kRowsPerBlock;\n"
STORE = "      if (first + k < n) o[k] = f;\n"
LAUNCH = "kThreads, 0, static_cast<cudaStream_t>(stream)>>>("


def plan(vpt: int, threads: int) -> tuple:
    """The substitutions and the wrapper's constants of another plan."""
    subs = [("constexpr int kVpt = 2;", f"constexpr int kVpt = {vpt};"),
            ("constexpr int kThreads = 256;", f"constexpr int kThreads = {threads};")]
    return [s for s in subs if s[0] != s[1]], {"VPT": vpt, "THREADS": threads}


def staged(block: bool) -> tuple:
    """The mask tile staged in shared memory, then written out with 16-byte
    stores: by rows after a block barrier, or each warp its own vertices of
    every row after a warp barrier."""
    segment = ("const int j0 = 0, j1 = n;" if block else
               "const int j0 = warp * 32 * kVpt, j1 = min(n, j0 + 32 * kVpt);")
    rows = ("for (int r = warp; r < rows; r += kThreads / 32)" if block else
            "for (int r = 0; r < rows; ++r)")
    stores = f"""  {"__syncthreads()" if block else "__syncwarp()"};
  const int pitch = kVpt * kThreads + 16, warp = threadIdx.x / 32;
  {segment}
  if (j0 < j1)
    {rows} {{
      const long long base = static_cast<long long>(u0 + r) * V + v0;
      const long long g0 = base + j0, g1 = base + j1;
      const long long a0 = (g0 + 15) & ~15LL, a1 = g1 & ~15LL;
      const uint8_t* sr = smem + r * pitch + static_cast<int>(base & 15);   // sr[g - base]
      for (long long g = a0 + 16 * lane; g < a1; g += 16 * 32)
        *reinterpret_cast<uint4*>(out + g) =
            *reinterpret_cast<const uint4*>(sr + static_cast<int>(g - base));
      const int head = a0 < a1 ? static_cast<int>(a0 - g0) : j1 - j0;
      const long long g = lane < head ? g0 + lane : (a0 < a1 ? a1 : g1) + (lane - head);
      if (g < g1) out[g] = sr[static_cast<int>(g - base)];
    }}
}}
"""
    return [
        (BODY, "  extern __shared__ __align__(16) unsigned char smem[];\n" + BODY),
        ("    uint8_t* o = out + u * V + vt;\n",
         "    uint8_t* o = smem + r * (kVpt * kThreads + 16) + static_cast<int>((u * V + v0) & 15)"
         " + first;\n"),
        (STORE + "    }\n  }\n}\n", STORE + "    }\n  }\n" + stores),
        (LAUNCH, "kThreads, (U < 32 ? U : 32) * (kVpt * kThreads + 16), "
                 "static_cast<cudaStream_t>(stream)>>>(")], {}


VARIANTS = {
    "base": ([], {}),
    "vpt2_t128": plan(2, 128),
    "vpt4": plan(4, 256),
    "vpt4_t128": plan(4, 128),
    "vpt8": plan(8, 256),
    "vpt8_t128": plan(8, 128),
    "staged": staged(True),
    "staged_warp": staged(False),
    "loads": ([(LOADS_END,
                "  int x = 0;\n"
                "#pragma unroll\n"
                "  for (int k = 0; k < kVpt; ++k)\n"
                "    x ^= ty[k] ^ sz[k] ^ ok[k] ^ static_cast<int>(m[k]) ^ ag[k][0] ^ ag[k][1] ^\n"
                "         ag[k][2] ^ ag[k][3];\n"
                "  if (x == 0x7fffffff) out[0] = 1;\n"
                "  return;\n" + LOADS_END)], {}),
    "empty": ([(BODY, "  if (V >= 0) return;\n" + BODY)], {}),
}
DIAGNOSTIC = ("loads", "empty")
COPIES, ITERS = 16, 160


def variant_source(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"feasibility_variants: substitution does not match: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build(parent: Path | None) -> dict:
    """Build every variant (and the parent's source) together; returns
    each library, its argument types declared."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    sources = {}
    for name, (subs, _) in VARIANTS.items():
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(variant_source(text, subs))
    if parent is not None:
        sources["parent"] = parent / "src" / "repro_torch" / "kernels" / "csrc" / "feasibility.cu"
    procs = {name: subprocess.Popen(
        [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"feasibility_variants: nvcc failed for {name}:\n{log}")
        print(json.dumps({"variant": name, "registers": re.findall(r"Used (\d+) registers", log),
                          "spill_stores": re.findall(r"(\d+) bytes spill stores", log)}),
              flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        plan_arg = [] if name == "parent" else [P]
        lib.feasible_fwd.argtypes = [P, P, P, P, P, L, I, I, P, P, P, P, I, P, *plan_arg, P]
        lib.feasible_fwd.restype = I
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from repro_torch.kernels.ref import ref_feasible

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of another commit to time beside")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("feasibility_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    libs = build(opts.parent)
    U, V, T = chip_smoke.BACKLOG_SHAPES, chip_smoke.QUARTZ_VERTICES, 4
    copies = [chip_smoke.feasibility_args(dev, 8 + i, U, V, T) for i in range(COPIES)]
    want = ref_feasible(*copies[0])

    def call(name, args):
        lib = libs[name]
        if name != "parent":
            consts = {"VPT": feasibility.VPT, "THREADS": feasibility.THREADS,
                      **VARIANTS[name][1]}
            with mock.patch.object(feasibility, "_lib", lambda: lib), \
                    mock.patch.multiple(feasibility, **consts):
                return feasibility.feasible_mask(*args)
        out = torch.empty((U, V), dtype=torch.uint8, device=dev)
        rc = lib.feasible_fwd(*(t.data_ptr() for t in args[:5]), args[4].stride(0), V, T,
                              *(t.data_ptr() for t in args[5:]), U, out.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f"feasibility_variants: parent: CUDA error {rc}")
        return out

    wrong = [name for name in libs
             if name not in DIAGNOSTIC and not torch.equal(call(name, copies[0]), want)]
    timed = [name for name in libs if name not in wrong]
    it = iter(range(1 << 30))
    times = {name: {"ms": [], "event_ms": []} for name in timed}
    for name in timed + timed[::-1]:
        def one(name=name):
            return call(name, copies[next(it) % COPIES])
        times[name]["ms"].append(chip_smoke.device_ms(one, iters=ITERS))
        times[name]["event_ms"].append(chip_smoke.time_ms(one, iters=ITERS, warmup=16))
    for name in libs:
        print(json.dumps({"variant": name, "shape": [U, V, T],
                          "exact": None if name in DIAGNOSTIC else name not in wrong,
                          **times.get(name, {})}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
