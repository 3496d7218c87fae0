"""Runs of every cell at a tiny size on the CPU: the result line, the
comparison with the plain reference, the planted faults, the import
check, and the command's refusals without a card."""
from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest
import torch

from portbench import cell, faults, run
from portbench.spec import Bench
from tiny import CPU, tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
SEED = 2 ** 31 + 12345          # larger than 32 signed bits hold
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(workload, trace=False, patch=None, dtype="bfloat16", seed=SEED):
    config, mix = tiny(BENCH, workload, dtype)
    return cell.run(BENCH, workload, seed, 0.3, trace, CPU, time.perf_counter(),
                    config=config, mix=mix, patch=patch)


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_prints_the_result_line(workload, trace, capsys):
    result = _run(workload, trace=bool(trace))
    err = capsys.readouterr().err
    assert "set-up harness and configuration: " in err and "window steps, host ms: " in err
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert run.finish(result) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    want = BENCH.per_layer(workload) if trace else BENCH.end_to_end(workload)
    if not trace:
        assert set(line["metrics"]) == {m["name"] for m in want}
    assert set(line["metrics"]) <= {m["name"] for m in want}
    for name, c in line["checks"].items():
        assert f"check {name} = " in err.getvalue()
    assert line["device"]["count"] == 1


def test_a_long_window_prints_its_slowest_steps():
    line = cell._steps("window steps, host ms", [10.0] * 100 + [55.0])
    assert line.startswith("window steps, host ms: 101 steps, min 10.0 median 10.0")
    assert "max 55.0" in line and "100: 55.0" in line


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_agrees_with_the_port_and_float8_does_not(workload):
    """In float32 the port and the reference agree to rounding (the decode
    buffers hold K and V in bfloat16 whatever the compute dtype, so the
    cache to that rounding); the control (the reference with float8
    products) reads at least ten times as far off on some number."""
    config, mix = tiny(BENCH, workload, "float32")
    c = cell.Cell(BENCH, workload, SEED, CPU, False, config, mix)
    d = BENCH.driver(mix).Driver(c)
    d.setup()
    if mix["driver"] == "prefill":
        d.window(count=3)
    prog = d.readings()
    d.release()
    ref = d.reference(fp8=False)
    sound = d.numbers(prog, ref)
    control = d.numbers(d.reference(fp8=True), ref)
    tol = {k: 4e-3 if k == "cache_err" else 2e-4 for k in sound}
    assert all(sound[k] < tol[k] for k in sound), sound
    assert any(control[k] > 10 * max(sound[k], 1e-6) for k in sound), (sound, control)


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    """The timed path broken under the driver, with the cell's own
    limits: ``correct`` comes out false."""
    kind = BENCH.mix(BENCH.workload(workload)["traffic"])["driver"]
    held = []

    def patch(driver):
        held.append(faults.planted(kind, fault))
        held[-1].__enter__()

    try:
        result = _run(workload, patch=patch)
    finally:
        for p in held:
            p.__exit__(None, None, None)
    assert result["correct"] is False, result["checks"]


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    """Top-level module names compared whole (the port's name begins with
    the JAX package's): after a tiny run of every kind, in a fresh process."""
    script = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'portbench' / 'tests')!r}]
import torch
from portbench import cell, calibrate, run
from portbench.spec import Bench
from tiny import tiny
bench = Bench({str(ROOT)!r})
for w in ("mamba2-train4k", "phi3-prefill2k"):
    config, mix = tiny(bench, w)
    cell.run(bench, w, 1, 0.2, True, torch.device("cpu"), time.perf_counter(), config=config, mix=mix)
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(" ".join(tops))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(res.stdout.split())
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    script = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}]
import portbench.reference.model, portbench.reference.dense, portbench.reference.mamba2
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert not set(res.stdout.split()) & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_the_command_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder gives no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_cell_on_the_card():
    """On a card: a short run of the first cell is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                          "7", "--seconds", "2", "--trace", "0"], capture_output=True,
                         text=True, cwd=ROOT, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] is True
