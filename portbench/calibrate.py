"""The readings a cell's limits are set from, in one process on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds a,b,c] [--fault-seeds a,b,c] [--faults f,g]

For each seed: the program's sound run (set-up and, for a served mix,
as many batches as a run compares), the faults of ``faults.py`` planted
in it on the fault seeds, the reference in float32, and on the control
seeds the control (the reference in float8 where the program computes
in bfloat16) in the program's place. Each is compared with the float32
reference as a run compares, and printed as one JSON line. Not part of a
benchmark run.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def _leaves(prog: dict, ref: dict):
    """Training: each leaf's (reference norm, program norm) of the first
    gradient and of the change."""
    if "grad_norms" not in ref:
        return None
    return {k: [ref["grad_norms"][k], prog["grad_norms"][k], ref["change_norms"][k],
                prog["change_norms"][k]] for k in ref["grad_norms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", default=",".join(["unchanged", "half_batch", "altered"]),
                    help="the faults planted on the fault seeds")
    args = ap.parse_args(argv)

    import torch

    from portbench import cell as cell_mod, faults
    from portbench.spec import Bench

    bench = Bench(ROOT)
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    report = lambda **kv: print(json.dumps(kv), flush=True)   # noqa: E731
    for seed in args.seeds:
        planted = [f for f in args.faults.split(",") if f]
        variants = [None] + (planted if seed in args.fault_seeds else [])
        progs, driver = {}, None
        for fault in variants:
            t0 = time.perf_counter()
            cell = cell_mod.Cell(bench, args.workload, seed, dev, trace=False)
            driver = bench.driver(cell.mix).Driver(cell)
            kind = cell.mix["driver"]
            patch = faults.planted(kind, fault) if fault else None
            try:
                if patch is not None:
                    patch.__enter__()
                driver.setup()
                if kind == "prefill":
                    driver.window(count=math.ceil(cell.mix["checked_requests"] / driver.n))
                progs[fault or "sound"] = driver.readings()
            finally:
                if patch is not None:
                    patch.__exit__(None, None, None)
            driver.release()
            cell_mod.free()
            report(seed=seed, part="program", variant=fault or "sound",
                   seconds=time.perf_counter() - t0)
        t0 = time.perf_counter()
        ref = driver.reference(fp8=False)
        report(seed=seed, part="reference", seconds=time.perf_counter() - t0,
               losses=ref.get("losses"), quiet_leaves=ref.get("quiet_leaves"))
        for variant, prog in progs.items():
            report(seed=seed, variant=variant, numbers=driver.numbers(prog, ref),
                   losses=prog.get("losses"), leaves=_leaves(prog, ref))
        if seed in args.control_seeds:
            t0 = time.perf_counter()
            ctl = driver.reference(fp8=True)
            report(seed=seed, variant="control", numbers=driver.numbers(ctl, ref),
                   losses=ctl.get("losses"), leaves=_leaves(ctl, ref),
                   seconds=time.perf_counter() - t0)
        del ref, progs
        cell_mod.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
