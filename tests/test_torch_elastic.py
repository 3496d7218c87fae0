"""The port's elastic training runtime: ``run_training`` on the CPU
through grow, shrink and a node failure (the twin of
tests/test_elastic.py's ``test_grow_shrink_fail_loop``, which runs JAX in
a subprocess and is marked slow; this one is not), the queue and
scheduler accounting under grow and shrink, and the device rules of the
entry point."""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import EventType, Instance
from repro_torch.core.graph import build_tpu_fleet
from repro_torch.launch.train import run_training
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.elastic import ElasticRuntime


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


def test_run_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("llama3.2-3b", steps=1)
