"""End-to-end elastic training entry point (the port of
``repro/launch/train.py``).

Runs a (reduced or full) architecture under the hierarchical scheduler:
the job starts with a MATCHALLOCATE, trains with checkpointing, and
optionally exercises grow/shrink/failure events mid-run — the paper's
three capabilities driving a real training loop. On a card attention's
forward and backward run the CUDA kernels of ``kernels/flash_attention.py``,
the SSD scan's those of ``kernels/ssd_scan.py``; a MoE layer's dispatch and
experts are plain PyTorch (the JAX layer has no kernel of its own).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
      --smoke --steps 20 --grow-at 5 --shrink-at 12 --fail-at 16
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \\
      --full --seq-len 1024 --batch 2 --steps 6 --grow-at 2 --shrink-at 3 --fail-at 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \\
      --full --n-layers 5 --seq-len 1024 --batch 2 --steps 6 --grow-at 2 --shrink-at 3
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Union

import torch

from ..configs.registry import ARCH_IDS, get_config, perf_patch
from ..core.external import TPUSliceProvider
from ..core.graph import build_tpu_fleet
from ..core.scheduler import SchedulerInstance
from ..data.pipeline import DataConfig, SyntheticTokenPipeline
from ..device import resolve_device
from ..models.config import SHAPES, ArchConfig, ShapeConfig
from ..optim.adamw import OptConfig
from ..runtime.checkpoint import CheckpointManager
from ..runtime.elastic import ElasticRuntime
from ..runtime.fault import FaultPolicy, HeartbeatMonitor


def run_training(arch: str, steps: int = 20, smoke: bool = True,
                 grow_at: Optional[int] = None,
                 shrink_at: Optional[int] = None,
                 fail_at: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 10,
                 start_chips: int = 2,
                 log_every: int = 5,
                 perf: bool = False,
                 shape: Optional[ShapeConfig] = None,
                 n_layers: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda") -> dict:
    """As JAX's ``run_training``, with three more arguments: ``shape``
    overrides the cell (JAX's ``train_4k``, 256 x 4096, does not fit one
    card at full width), ``n_layers`` cuts the depth (``cut_depth``: a
    full-width MoE model's masters, gradients and optimizer state do not
    fit one card), and ``device`` ("cuda" by default; "cpu" only when
    asked). Every family the port models trains on either device: dense,
    moe, ssm and hybrid. Besides JAX's results it returns each step's
    seconds (batch upload to the loss on the host, the grow, shrink and
    failure before it excluded), the depth cut (``reduced``: None, or
    {"n_layers": "5 of 48"}) and the runtime, whose model and optimizer
    state are the trained ones."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        # the LM head is an fp32 product, as in JAX: keep TF32 out of it
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch)
    if perf:
        patch = {k: v for k, v in perf_patch(arch).items()
                 if k != "ssm_chunk"}  # reduced configs keep tiny chunks
        cfg = dataclasses.replace(cfg, **patch)
    if smoke:
        cfg = cfg.reduced()
        default_shape = ShapeConfig("smoke_train", 32, 8, "train")
    else:
        default_shape = SHAPES["train_4k"]
    shape = shape or default_shape
    reduced = None
    if n_layers is not None:
        reduced = {"n_layers": f"{n_layers} of {cfg.n_layers}"}
        cfg = cut_depth(cfg, n_layers)

    # control plane: a small TPU fleet + cloud-slice provider
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4,
                            chips_per_node=4, device=dev)
    sched = SchedulerInstance("top", fleet, external=TPUSliceProvider())
    rt = ElasticRuntime(sched, cfg, shape, chip_type="chip",
                        opt=OptConfig(kind=cfg.optimizer, warmup=5,
                                      total_steps=max(steps, 10)),
                        device=dev)
    if not rt.allocate(start_chips):
        raise RuntimeError("initial MATCHALLOCATE failed")
    rt.bind(torch.Generator(device=dev).manual_seed(0))

    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    pipe = SyntheticTokenPipeline(cfg, shape, DataConfig())
    fault = FaultPolicy(rt, HeartbeatMonitor(timeout_s=1e9))
    fault.watch_allocation()

    losses, step_s = [], []
    t0 = time.time()
    for step in range(steps):
        if grow_at is not None and step == grow_at:
            ok = rt.grow(4)
            print(f"[step {step}] grow +4 chips -> "
                  f"{rt.chips_allocated()} (ok={ok})", flush=True)
        if shrink_at is not None and step == shrink_at:
            ok = rt.shrink(2)
            print(f"[step {step}] shrink -2 chips -> "
                  f"{rt.chips_allocated()} (ok={ok})", flush=True)
        if fail_at is not None and step == fail_at:
            g = rt.scheduler.graph
            alloc = rt.scheduler.allocations[rt.jobid]
            chip = next(p for p in alloc.paths
                        if p in g and g.vertex(p).type == "chip")
            node = next(a for a in g.ancestors(chip)
                        if g.vertex(a).type == "node")
            ok = rt.eject_and_replace(node)
            print(f"[step {step}] node failure {node} -> replaced "
                  f"(ok={ok}, chips={rt.chips_allocated()})", flush=True)
        batch = pipe.batch_at(step)
        ts = time.perf_counter()
        metrics = rt.step(batch)
        loss = float(metrics["loss"])          # waits for the step
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        if ckpt and step and step % ckpt_every == 0:
            ckpt.save(step, {"params": rt.params,
                             "opt_state": rt.opt_state}, blocking=False)
        if step % log_every == 0:
            print(f"[step {step}] loss={loss:.4f} "
                  f"chips={rt.chips_allocated()} "
                  f"mesh={len(rt.mesh)}", flush=True)
    if ckpt:
        ckpt.save(steps, {"params": rt.params, "opt_state": rt.opt_state})
    wall = time.time() - t0
    cut = f"; layers {reduced['n_layers']}" if reduced else ""
    print(f"done: {steps} steps in {wall:.1f}s; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"events={[e.kind for e in rt.events]}{cut}", flush=True)
    return {"losses": losses, "events": rt.events, "wall_s": wall, "step_s": step_s,
            "reduced": reduced, "runtime": rt}


def cut_depth(cfg: ArchConfig, n_layers: int) -> ArchConfig:
    """``cfg`` with its first ``n_layers`` layers: a whole number of its
    groups (an interleaved MoE model's ``moe_every``, a hybrid's
    ``shared_attn_every``), at most as many as it has."""
    group = cfg.moe_every if cfg.is_moe else cfg.shared_attn_every or 1
    if not 1 <= n_layers <= cfg.n_layers or n_layers % group:
        raise ValueError(f"{cfg.name}: cannot cut {cfg.n_layers} layers to {n_layers} "
                         f"(a multiple of {group}, at most {cfg.n_layers})")
    return dataclasses.replace(cfg, n_layers=n_layers)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--grow-at", type=int, default=None)
    ap.add_argument("--shrink-at", type=int, default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--perf", action="store_true",
                    help="apply the per-arch §Perf optimization bundle")
    ap.add_argument("--seq-len", type=int, default=None,
                    help="with --batch: the training cell, in place of the default")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers (a whole number of groups)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    shape = None
    if args.seq_len or args.batch:
        if not (args.seq_len and args.batch):
            ap.error("--seq-len and --batch go together")
        shape = ShapeConfig("train", args.seq_len, args.batch, "train")
    run_training(args.arch, steps=args.steps, smoke=args.smoke,
                 grow_at=args.grow_at, shrink_at=args.shrink_at,
                 fail_at=args.fail_at, ckpt_dir=args.ckpt_dir,
                 perf=args.perf, shape=shape, n_layers=args.n_layers, device=args.device)


if __name__ == "__main__":
    main()
