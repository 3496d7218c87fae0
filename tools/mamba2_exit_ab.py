#!/usr/bin/env python3
"""Compare two checkouts of the repo on the baseline Mamba2 block's exit
(``ssm_seq_sharded`` off), on one NVIDIA card, in one process per arm and
the arms in the order parent, change, change, parent.

    python3 tools/mamba2_exit_ab.py PARENT_DIR CHANGE_DIR            # step times
    python3 tools/mamba2_exit_ab.py PARENT_DIR CHANGE_DIR --profile  # device time

Each directory is a checkout (``git archive`` of a commit, unpacked). An
arm builds that checkout's kernels and runs, with its own ``src`` first on
the path:

- by default, ``chip_smoke.py``'s ``model_axis_rank`` body for mamba2-2.7b
  alone (rank 1 of a (1, 2) mesh under the fake process group, 4 steps of
  2 x 1024) and then the dry-run cell mamba2-2.7b ``train_4k`` on 16x16
  (``launch/dryrun.py::run_cell``): the steps' ms (CUDA events around a
  host-held step) and the cell's step seconds, dot TFLOP, collective GB;
- with ``--profile``, the dry-run cell once to warm up and once under
  ``torch.profiler`` (CUDA activity): the device time of all its kernels
  (set-up and both steps) and of the GEMM kernels, ms.

Each arm prints one JSON line. Times on the host's clock spread between
runs of one tree; the device time does not see the host.
"""
import contextlib
import io
import json
import os
import subprocess
import sys

GEMM_KEYS = ("gemm", "sm90_xmma", "cutlass", "nvjet")


def arm(root: str, label: str, profile: bool) -> dict:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.dryrun import run_cell
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(["flash_attention", "feasibility", "ssd_chunk"])
    quiet = contextlib.redirect_stdout(io.StringIO())
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile
        with quiet:
            run_cell("mamba2-2.7b", "train_4k", tag="warm_" + label)
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                d = run_cell("mamba2-2.7b", "train_4k", tag="ab2_" + label)
        ka = prof.key_averages()
        top = sorted(((e.self_device_time_total / 1e3, e.key[:60]) for e in ka), reverse=True)
        return {"arm": label, "device_ms": sum(e.self_device_time_total for e in ka) / 1e3,
                "gemm_ms": sum(e.self_device_time_total for e in ka
                               if any(k in e.key.lower() for k in GEMM_KEYS)) / 1e3,
                "top": top[:6], "dry_step_s": d["step_s"],
                "dry_tflop": d["dot_flops_per_device"] / 1e12}
    import chip_smoke as cs
    cs.MODEL_AXIS.clear()
    cs.MODEL_AXIS["mamba2-2.7b"] = dict(world=2, model_axis=2, rank=1, seq=1024, batch=2,
                                        steps=4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cs.phase_model_axis_rank(torch.device("cuda"))
    rec = [json.loads(line) for line in buf.getvalue().splitlines()
           if line.startswith('{"phase": "model_axis_rank"')][0]
    with quiet:
        d = run_cell("mamba2-2.7b", "train_4k", tag="ab_" + label)
    return {"arm": label, "step_ms": rec["step_ms"], "peak_gb": rec["peak_mem_gb"],
            "dry_step_s": d["step_s"], "dry_tflop": d["dot_flops_per_device"] / 1e12,
            "dry_coll_gb": d["collective_bytes_total"] / 1e9,
            "dry_peak_gb": d["memory_analysis"]["peak_allocated_bytes"] / 1e9}


def main() -> int:
    args = [a for a in sys.argv[1:] if a != "--profile"]
    profile = "--profile" in sys.argv[1:]
    if args and args[0] == "--arm":
        print(json.dumps(arm(os.path.abspath(args[1]), args[2], profile)), flush=True)
        return 0
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = (os.path.abspath(a) for a in args)
    rc = 0
    for label, root in (("parent", parent), ("change", change), ("change", change),
                        ("parent", parent)):
        cmd = [sys.executable, os.path.abspath(__file__), "--arm", root, label]
        proc = subprocess.run(cmd + (["--profile"] if profile else []), capture_output=True,
                              text=True, timeout=400)
        print(proc.stdout.strip().splitlines()[-1] if proc.returncode == 0 else
              json.dumps({"arm": label, "rc": proc.returncode, "err": proc.stderr[-2000:]}),
              flush=True)
        rc |= proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
