"""Shared helpers of the port's distributed tests (``test_torch_sharding``,
``test_torch_compress``, ``test_torch_a2a_shards``,
``test_torch_elastic_ranks``).

* ``run_world(fn, world, tmp_path)``: a gloo world of ``world`` CPU
  processes under ``torch.multiprocessing`` (spawn), initialised from a
  file under ``tmp_path`` (no port, so safe under xdist). Each rank calls
  ``fn(rank, world, *args)`` and its return value comes back in a list by
  rank. A rank that raises fails the test with its traceback; a world that
  does not finish within ``timeout`` seconds is killed and fails.
* ``run_jax_oracle(code, tmp_path)``: the JAX reference in a subprocess
  with four forced host devices, where ``auto_mesh(shape, names)`` builds
  a mesh with Auto axes (``jax.make_mesh`` defaults to Explicit axes, on
  which the reference's mesh paths raise). The code saves its results with
  ``save(**arrays)`` into an ``.npz`` that comes back as a dict.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]


def _rank_entry(fn, rank: int, world: int, init_file: str, out_dir: str, args) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                world_size=world, rank=rank)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_world(fn, world: int, tmp_path: Path, args: tuple = (), timeout: float = 240.0) -> list:
    """``fn(rank, world, *args)`` on every rank of a gloo world; the ranks'
    return values, by rank."""
    out_dir = Path(tmp_path) / f"world{time.monotonic_ns()}"
    out_dir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, str(out_dir / "init"), str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    for r in range(world):
        path = out_dir / f"rank{r}.pkl"
        if not path.exists():
            raise AssertionError(f"rank {r} of {world} left no result (hung ranks: {hung}, "
                                 f"exit codes {[p.exitcode for p in procs]})")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {r} of {world} raised:\n{value}")
        results.append(value)
    if hung:
        raise AssertionError(f"ranks {hung} of {world} did not finish in {timeout} s")
    return results


_ORACLE_PRELUDE = '''
import sys
import numpy as np
import jax
from jax.sharding import AxisType

def auto_mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))

_OUT = {}

def save(**arrays):
    _OUT.update({k: np.asarray(v) for k, v in arrays.items()})

'''


def run_jax_oracle(code: str, tmp_path: Path, devices: int = 4, timeout: float = 240.0) -> dict:
    """Run ``code`` under JAX with ``devices`` host devices; the arrays it
    passed to ``save`` as a dict."""
    out = Path(tmp_path) / f"oracle{time.monotonic_ns()}.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(ROOT / "src")
    script = _ORACLE_PRELUDE + code + f"\nnp.savez({str(out)!r}, **_OUT)\n"
    proc = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + "\n" + proc.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}
