"""The port's elastic training runtime: ``run_training`` on the CPU
through grow, shrink and a node failure (the twin of
tests/test_elastic.py's ``test_grow_shrink_fail_loop``, which runs JAX in
a subprocess and is marked slow; this one is not), the queue and
scheduler accounting under grow and shrink, and the device rules of the
entry point."""
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import EventType, Instance
from repro_torch.core.graph import build_tpu_fleet
from repro_torch.core.scheduler import SchedulerInstance
from repro_torch.data.pipeline import SyntheticTokenPipeline
from repro_torch.launch.train import run_training
from repro_torch.models.config import ShapeConfig
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import ElasticRuntime
from repro_torch.runtime.straggler import StragglerPolicy


def test_shrink_keeps_queue_and_scheduler_accounting_in_agreement():
    """The twin of the test of that name in tests/test_elastic.py: every
    grow and shrink flows through the queue, so the queue's job record,
    the scheduler allocation and the queue's utilization agree after each
    elasticity event."""

    class ControlPlaneOnly(ElasticRuntime):
        def bind(self, generator=None):       # data plane stubbed out
            pass

    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4,
                            chips_per_node=4, device="cpu")
    api = Instance(graph=fleet, name="top")
    rt = ControlPlaneOnly.__new__(ControlPlaneOnly)
    # constructor builds model configs we don't need; wire by hand
    rt.api = api
    rt.scheduler = api.scheduler
    rt.handle = None
    rt.jobid = "train-job"
    rt.chip_type = "chip"
    rt.model_axis = 1
    rt.events = []

    def agree():
        job = api.queue.get(rt.jobid)
        alloc = api.scheduler.allocations[rt.jobid]
        assert sorted(job.paths) == sorted(alloc.paths)
        busy = sum(len(j.paths) for j in api.queue.running)
        assert busy == len(job.paths)

    assert rt.allocate(4)
    agree()
    assert rt.grow(4)
    assert rt.chips_allocated() == 8
    agree()
    assert rt.shrink(2)
    assert rt.chips_allocated() == 6
    agree()
    # shrink below the model axis floor is refused, accounting intact
    assert not rt.shrink(6)
    assert rt.chips_allocated() == 6
    agree()
    kinds = [e.type for e in api.events.for_job(rt.jobid)]
    assert EventType.GROW in kinds and EventType.SHRINK in kinds


def test_grow_shrink_fail_loop(tmp_path):
    res = run_training("llama3.2-3b", steps=12, smoke=True, grow_at=3, shrink_at=6,
                       fail_at=9, ckpt_dir=str(tmp_path), ckpt_every=5, device="cpu")
    kinds = [e.kind for e in res["events"]]
    assert kinds == ["rebind", "grow", "rebind", "shrink", "rebind", "eject", "rebind"]
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 12
    # the first loss of random weights is about ln(vocab)
    assert abs(res["losses"][0] - math.log(256)) < 1.0
    rt = res["runtime"]
    assert rt.chips_allocated() == 4 and len(rt.mesh) == 1
    assert len(res["step_s"]) == 12
    # the last checkpoint is the trained state, and restores into it
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 12
    step, out = mgr.restore(like={"params": rt.params, "opt_state": rt.opt_state})
    assert step == 12 and out["opt_state"].step == 12
    for name, t in rt.params.items():
        torch.testing.assert_close(out["params"][name], t, rtol=0, atol=0)


def test_rebind_keeps_the_model_and_its_state(tmp_path):
    """A rebind on the same device neither rebuilds the model nor copies
    its state: at full width a second copy would not fit the card."""
    res = run_training("llama3.2-3b", steps=3, smoke=True, grow_at=1, shrink_at=2,
                       device="cpu")
    rt = res["runtime"]
    model, masters = rt.model, {n: t.data_ptr() for n, t in rt.params.items()}
    moments = {n: t.data_ptr() for n, t in rt.opt_state.mu.items()}
    assert rt.grow(4) and rt.shrink(2)
    assert rt.model is model
    assert {n: t.data_ptr() for n, t in rt.params.items()} == masters
    assert {n: t.data_ptr() for n, t in rt.opt_state.mu.items()} == moments
    assert [e.kind for e in rt.events][-4:] == ["grow", "rebind", "shrink", "rebind"]


def test_checkpoint_restart_resumes(tmp_path):
    """The twin of tests/test_elastic.py's ``test_checkpoint_restart_resumes``
    in process (the JAX one needs 8 and then 4 host devices in a subprocess
    and is marked slow): train with a checkpoint every 10 steps, restore into
    a fresh runtime at another allocation (4 chips of a one-node fleet), and
    take one finite step from the latest checkpoint (step 10 or later)."""
    run_training("llama3.2-3b", steps=11, smoke=True, ckpt_dir=str(tmp_path),
                 ckpt_every=10, device="cpu")
    cfg = get_config("llama3.2-3b").reduced()
    shape = ShapeConfig("smoke_train", 32, 8, "train")
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=1,
                            chips_per_node=4, device="cpu")
    rt = ElasticRuntime(SchedulerInstance("top", fleet), cfg, shape, chip_type="chip",
                        device="cpu")
    assert rt.allocate(4)
    rt.bind(torch.Generator().manual_seed(0))
    step, state = CheckpointManager(str(tmp_path)).restore(
        like={"params": rt.params, "opt_state": rt.opt_state})
    with torch.no_grad():
        for name, t in state["params"].items():
            rt.params[name].copy_(t)
    rt.opt_state = state["opt_state"]
    m = rt.step(SyntheticTokenPipeline(cfg, shape).batch_at(step))
    assert step >= 10 and rt.opt_state.step == step + 1
    assert np.isfinite(float(m["loss"]))


def test_straggler_ejection():
    """The twin of tests/test_elastic.py's ``test_straggler_ejection``, in
    process (the JAX one needs 8 host devices in a subprocess and is marked
    slow): a node 5x slower than its peer for three windows is ejected and
    replaced, and the allocation keeps its 8 chips."""
    cfg = get_config("llama3.2-3b").reduced()
    shape = ShapeConfig("s", 32, 8, "train")
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=4,
                            chips_per_node=4, device="cpu")
    sched = SchedulerInstance("top", fleet)
    rt = ElasticRuntime(sched, cfg, shape, chip_type="chip", device="cpu")
    assert rt.allocate(8)
    rt.bind(torch.Generator().manual_seed(0))
    pol = StragglerPolicy(rt)
    # the nodes actually backing the allocation
    g = sched.graph
    nodes = sorted({next(a for a in g.ancestors(p) if g.vertex(a).type == "node")
                    for p in sched.allocations[rt.jobid].paths
                    if g.vertex(p).type == "chip"})
    assert len(nodes) >= 2
    for _ in range(4):
        pol.record_and_act({nodes[0]: 1.0, nodes[1]: 5.0})
    assert nodes[1] in pol.ejected, pol.ejected
    assert rt.chips_allocated() == 8, rt.chips_allocated()
    assert [e.kind for e in rt.events][-2:] == ["eject", "rebind"]


def test_run_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("llama3.2-3b", steps=1)


ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("example,args,marker", [
    ("torch_burst_serve.py", [], "served 4 sequences x 16 tokens"),
    ("torch_elastic_train.py", ["--ckpt-dir", "ckpt"], "losses:"),
    ("torch_fault_tolerant_train.py", ["--ckpt-dir", "ckpt"], "restored at step 8"),
])
def test_example_twin_runs_on_cpu(example, args, marker, tmp_path):
    """Each example twin end to end with ``--device cpu`` at its smoke
    size, in a process of its own (as a user runs it)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), "--device", "cpu", *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-2000:]
    assert marker in out.stdout, out.stdout[-2000:]
