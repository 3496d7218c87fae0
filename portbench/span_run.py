"""Run one cell traced, with the program's spans put down to the device's
work, and print its result with them.

    python3 portbench/span_run.py --workload <cell> --seed <n> --seconds <s>

From the root of a checkout, as ``run.py`` runs a cell with ``--trace 1``,
but through ``spans.SpanTracer``, which attaches a span collector to the
program for the window. The last line
of standard output is ``run.py``'s result with ``spans``, ``counts``,
``span_idle_gaps``, ``clock_offset_us``, ``clock_skew_us`` and
``span_readings`` (the four readings of ``spans.READINGS``) added; the
by-span table goes to standard error. ``run.py --trace 1`` on the same
seed is the same window with no collector, for the collector's cost.
Exits 1 without a CUDA card, or if the JAX package or JAX itself was
loaded.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH", str(ROOT / "build" / "torch_kernels"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def traced(bench, workload: str, seed: int, seconds: float, device, started: float,
           marks=(), **kw) -> dict:
    """``cell.run`` of a traced window under a ``SpanTracer``, its result
    with the spans' readings added (``kw``: ``cell.run``'s ``config`` and
    ``mix``)."""
    from portbench import cell, spans

    held = {}

    def use_tracer(driver):
        driver.cell.tracer = spans.SpanTracer(True, device)
        held["driver"], held["tracer"] = driver, driver.cell.tracer

    result = cell.run(bench, workload, seed, seconds, True, device, started,
                      patch=use_tracer, marks=marks, **kw)
    tracer, driver = held["tracer"], held["driver"]
    got = tracer.spans
    run = dict(driver.layer_context(), window_s=tracer.summary["window_s"],
               busy_s=tracer.summary["busy_s"], spans=got["spans"], counts=got["counts"])
    readings = {name: read(run) for name, read in spans.READINGS.items()}
    for line in spans.table_lines(run, run["units"]):
        print(line, file=sys.stderr)
    result.update(spans=got["spans"], counts=got["counts"], span_idle_gaps=got["idle_gaps"],
                  clock_offset_us=got["clock_offset_us"], clock_skew_us=got["clock_skew_us"],
                  span_readings={k: v for k, v in readings.items() if v is not None})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    marks = [("interpreter and torch", time.perf_counter())]
    from portbench.run import finish
    from portbench.spec import Bench

    bench = Bench(ROOT)
    if not torch.cuda.is_available():
        print("this command needs a CUDA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.empty(1, device=device)
    marks.append(("CUDA context", time.perf_counter()))
    result = traced(bench, args.workload, args.seed, args.seconds, device, STARTED,
                    marks=marks)
    return finish(result)


if __name__ == "__main__":
    sys.exit(main())
