"""One run of one cell: set-up, the measured window, the device's and the
host's readings, then the check against the plain reference. The result
is the line ``run.py`` prints.

Order matters for memory: the program's peak is read before its state is
freed, and the reference runs after, so that its own peak is never the
program's.
"""
from __future__ import annotations

import gc
import math
import shutil
import statistics
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import compare, weights
from .reference import sizes
from .spec import Bench
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SHOWN_STEPS = 64        # a window of more steps prints a summary and its slowest


class StepClock:
    """The window's step boundaries: the host clock at each, and on a card a
    CUDA event recorded behind the step's work (no synchronize), so that a
    slow run shows which steps were slow and on which side; and the time
    the window spent in Python's garbage collector."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.host: List[float] = []
        self.events: list = []
        self.gc = [[0, 0.0, 0.0] for _ in range(3)]   # a generation's count, seconds, longest
        self._gc_start = 0.0

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
            return
        took = time.perf_counter() - self._gc_start
        g = self.gc[info["generation"]]
        g[0] += 1
        g[1] += took
        g[2] = max(g[2], took)

    def tick(self) -> None:
        if not self.host:
            gc.callbacks.append(self._on_gc)
        self.host.append(time.perf_counter())
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.append(event)

    def stop(self) -> None:
        """At the window's close."""
        if self._on_gc in gc.callbacks:
            gc.callbacks.remove(self._on_gc)

    def lines(self) -> List[str]:
        """After the window's synchronize: the host's and the device's
        milliseconds a step, and the garbage collector's time."""
        host = [1e3 * (b - a) for a, b in zip(self.host, self.host[1:])]
        device = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        out = [_steps(f"window steps, {side} ms", ms)
               for side, ms in (("host", host), ("device", device)) if ms]
        out.append("window garbage collections (generation: count, s, longest ms): " + "; ".join(
            f"{i}: {n}, {sec:.3f}, {1e3 * top:.1f}" for i, (n, sec, top) in enumerate(self.gc)))
        return out


def _steps(what: str, ms: Sequence[float]) -> str:
    if len(ms) <= SHOWN_STEPS:
        return f"{what}: " + " ".join(f"{x:.1f}" for x in ms)
    q = statistics.quantiles(ms, n=20)
    slow = sorted(range(len(ms)), key=lambda i: -ms[i])[:8]
    return (f"{what}: {len(ms)} steps, min {min(ms):.1f} median {statistics.median(ms):.1f} "
            f"p95 {q[-1]:.1f} max {max(ms):.1f}; slowest (step: ms) "
            + " ".join(f"{i}: {ms[i]:.1f}" for i in sorted(slow)))


def card_state() -> str:
    """The card's clocks, power, temperature and active clock-event
    (throttle) reasons just after the window, and the processes on it, as
    ``nvidia-smi`` reads them."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "card: nvidia-smi not found"

    def query(*args: str) -> Tuple[int, str]:
        try:
            res = subprocess.run([smi, *args, "--format=csv,noheader"], capture_output=True,
                                 text=True, timeout=20)
        except (OSError, subprocess.SubprocessError) as e:
            return 1, f"failed: {e}"
        text = res.stdout if res.returncode == 0 else res.stderr
        return res.returncode, " | ".join(x.strip() for x in text.splitlines() if x.strip())

    fields = "clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    rc, gpu = query(f"--query-gpu={fields},clocks_event_reasons.active")
    if rc != 0:         # the field's older name
        rc, gpu = query(f"--query-gpu={fields},clocks_throttle_reasons.active")
    _, apps = query("--query-compute-apps=pid,used_memory")
    return (f"card after the window (SM MHz, max SM MHz, W, limit W, C, clock-event reasons): "
            f"{gpu}; processes on it (pid, memory): {apps or 'none listed'}")


class Cell:
    """What a driver is given: the configuration, the mix, the seed, the
    device, the weights' layout, the tracer, the window's step clock, and
    where to record memory."""

    def __init__(self, bench: Bench, workload: str, seed: int, device: torch.device,
                 trace: bool, config: Optional[dict] = None, mix: Optional[dict] = None,
                 marks: Sequence[Tuple[str, float]] = ()):
        self.bench, self.workload = bench, workload
        entry = bench.workload(workload)
        self.config = config if config is not None else bench.config(entry["config"])
        self.mix = mix if mix is not None else bench.mix(entry["traffic"])
        self.port = self.config["port"]
        self.sizes = sizes(self.config)
        self.seed = int(seed)
        self.device = device
        self.layout = weights.layout(self.sizes, self.config)
        self.tracer = Tracer(trace, device)
        self.clock = StepClock(device)
        self.setup_peak = 0
        self.marks = list(marks)

    def mark(self, what: str) -> None:
        """A point of set-up on the host clock (printed to standard error)."""
        self.marks.append((what, time.perf_counter()))

    def arch(self):
        """The port's ArchConfig, built from the configuration's sizes."""
        from repro_torch.models.config import ArchConfig
        return ArchConfig(**self.port)

    def vocab(self) -> int:
        """The ids traffic may draw: the published vocabulary (a padded
        table's extra rows are never looked up)."""
        return int(self.config.get("vocab_size") or self.port["vocab"])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda" else 0

    def mark_setup_peak(self) -> None:
        """The program's set-up peak so far; the peak counter restarts, so
        that the harness's own readings between here and the window do
        not count."""
        self.setup_peak = max(self.setup_peak, self.peak())

    def restart_peak(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(bench: Bench, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, started: float, config: Optional[dict] = None,
        mix: Optional[dict] = None, patch: Optional[Callable] = None,
        marks: Sequence[Tuple[str, float]] = ()) -> dict:
    """The result of one run (``run.py`` prints it). ``started`` is the
    host clock at the process's start and ``marks`` the points of set-up
    before this call; ``patch``, for tests, breaks the program under the
    driver. Set-up's phases and the window's step times go to standard
    error."""
    if device.type == "cuda":
        # the program's float32 LM head, as its entry points set it
        torch.backends.cuda.matmul.allow_tf32 = False
    cell = Cell(bench, workload, seed, device, trace, config, mix, marks)
    cell.mark("harness and configuration")
    driver = bench.driver(cell.mix).Driver(cell)
    if patch is not None:
        patch(driver)
    driver.setup()
    setup_s = time.perf_counter() - started
    cell.mark("to the window")
    last = started
    for what, t in cell.marks:
        print(f"set-up {what}: {t - last:.3f} s", file=sys.stderr)
        last = t
    driver.window(seconds=seconds)
    cell.clock.stop()
    memory_peak = max(cell.setup_peak, cell.peak())
    for line in cell.clock.lines():
        print(line, file=sys.stderr)
    if device.type == "cuda":
        print(card_state(), file=sys.stderr)
    attempted, failed = driver.counts()
    e2e = dict(driver.end_to_end(), setup_s=setup_s, peak_mem_gb=memory_peak / 1e9)
    prog = driver.readings()
    driver.release()
    free()
    ref = driver.reference(fp8=False)
    numbers = driver.numbers(prog, ref)
    limits = bench.limits(workload)
    correct, checks = compare.verdict(numbers, limits)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak}
    out: Dict = {"correct": bool(correct and failed == 0 and attempted > 0),
                 "attempted": attempted, "failed": failed}
    if trace:
        summary = cell.tracer.summary
        ctx = dict(driver.layer_context(), port=cell.sizes, mix=cell.mix,
                   window_s=summary["window_s"], busy_s=summary["busy_s"],
                   kernels=summary["kernels"])
        metrics = {}
        for m in bench.per_layer(workload):
            value = bench.reader(m["name"])(ctx)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        out["metrics"] = metrics
        out["device"] = device_info
        out["breakdown"] = summary["breakdown"]
    else:
        metrics = {}
        for m in bench.end_to_end(workload):
            if m["name"] not in e2e:
                raise KeyError(f"{workload} reports no {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
        out["metrics"] = metrics
        out["device"] = device_info
    out["checks"] = checks
    return out
