"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout: the cell's configuration, traffic mix and
limits are found by name (``portbench/spec.py``); the program is the
PyTorch and CUDA port under ``src/repro_torch``. The last line of standard
output is the result as one JSON object; the numbers compared with the
plain reference, each beside its limit, are the last lines of standard
error. Exits 1, with no result, without enough CUDA cards, or if the
JAX package or JAX itself was loaded.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the CUDA kernels build into build/kernels; torch's own runtime-compiled
# kernels are cached beside them, at a fixed path inside the checkout
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / "build" / "torch_kernels"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    marks = [("interpreter and torch", time.perf_counter())]
    from portbench import cell
    from portbench.spec import Bench

    bench = Bench(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)       # the CUDA context, which the program would make
    marks.append(("CUDA context", time.perf_counter()))
    result = cell.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, STARTED, marks=marks)
    return finish(result)


def finish(result: dict) -> int:
    """Print a run's result, or nothing (and 1) where JAX or the JAX
    package was loaded in this process."""
    from portbench.cell import forbidden_modules

    found = forbidden_modules()
    if found:
        print(f"modules that must not load were loaded: {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
