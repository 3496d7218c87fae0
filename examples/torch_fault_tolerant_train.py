"""Fault tolerance on the PyTorch/CUDA port: checkpoint/restart +
node replacement + straggler ejection. The twin of
``fault_tolerant_train.py``.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_train.py
          [--device cpu] [--ckpt-dir DIR]
"""
import argparse
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.core.graph import build_tpu_fleet
from repro_torch.core.scheduler import SchedulerInstance
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import ElasticRuntime
from repro_torch.runtime.straggler import StragglerPolicy


def run(device: str, ckpt_dir: str) -> None:
    cfg = get_config("phi4-mini-3.8b").reduced()
    shape = ShapeConfig("smoke", 32, 8, "train")
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4,
                            chips_per_node=4, device=device)
    sched = SchedulerInstance("top", fleet)
    rt = ElasticRuntime(sched, cfg, shape, chip_type="chip", device=device)
    assert rt.allocate(8)
    rt.bind(torch.Generator(device=device).manual_seed(0))
    ckpt = CheckpointManager(ckpt_dir)
    pipe = SyntheticTokenPipeline(cfg, shape)
    straggler = StragglerPolicy(rt)

    g = sched.graph

    def alloc_nodes():
        return sorted({next(a for a in g.ancestors(p) if g.vertex(a).type == "node")
                       for p in sched.allocations[rt.jobid].paths
                       if p in g and g.vertex(p).type == "chip"})

    print("allocation backed by nodes:", alloc_nodes())
    for step in range(12):
        m = rt.step(pipe.batch_at(step))
        if step == 4:   # hard failure: eject + MATCHGROW replacement
            victim = alloc_nodes()[0]
            rt.eject_and_replace(victim)
            print(f"[{step}] node {victim} failed -> replaced; "
                  f"chips={rt.chips_allocated()}")
        if step == 6:   # persistent straggler: 5x slower than the fleet
            cur = alloc_nodes()
            for _ in range(3):
                straggler.record_and_act({cur[-1]: 5.0, **{n: 1.0 for n in cur[:-1]}})
            print(f"[{step}] straggler ejected: {straggler.ejected}")
            assert straggler.ejected == [cur[-1]]
        if step == 8:
            ckpt.save(step, rt.full_state(), blocking=False)
        if step % 4 == 0:
            print(f"[{step}] loss={float(m['loss']):.4f} devices={len(rt.mesh)}")

    # restart from the checkpoint into the live model (topology-independent)
    step, state = ckpt.restore(like={"params": rt.params, "opt_state": rt.opt_state},
                               shardings={"params": rt.model.param_shardings(),
                                          "opt_state": rt.model.opt_shardings()})
    rt.params, rt.opt_state = state["params"], state["opt_state"]
    m = rt.step(pipe.batch_at(step))
    print(f"restored at step {step}, next loss={float(m['loss']):.4f}")
    print("events:", [e.kind for e in rt.events])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="where checkpoints go (a temporary directory if not given)")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        run(args.device, args.ckpt_dir or tmp)


if __name__ == "__main__":
    main()
