"""The data plane's spans and counters (``repro_torch.tally_hooks``): off
with no collector, their records' fields, Python's collections, remat's
recomputes, the sites of a training step and of a prefill batch, and
their clock against the profiler's."""
import dataclasses
import gc
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch import tally_hooks
from repro_torch.configs import get_config
from repro_torch.core.graph import build_tpu_fleet
from repro_torch.core.metrics import Drained, MetricsAggregator, SpanCollector
from repro_torch.core.scheduler import SchedulerInstance
from repro_torch.launch.serve import splice_cache
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import make_model
from repro_torch.runtime.elastic import ElasticRuntime
from repro_torch.tally_hooks import count, set_spans, span


@pytest.fixture
def collector():
    col = SpanCollector(maxlen=1 << 16)
    prev = set_spans(col)
    try:
        yield col
    finally:
        set_spans(prev)


def _names(spans):
    return [s["name"] for s in spans]


def test_detached_spans_are_the_shared_no_op_and_record_nothing():
    assert set_spans(None) is None
    col = SpanCollector()
    set_spans(col)
    set_spans(None)
    assert span("train.step") is tally_hooks.OFF
    assert span("model.layer", step=3, i=0) is tally_hooks.OFF
    with span("train.step", step=1) as s:
        assert s is tally_hooks.OFF
        count("remat.recomputes")
    assert set_spans(None) is None
    drained = col.drain()
    assert drained == [] and drained.counts == {} and col.recorded == 0


def test_attached_spans_nest_with_parent_tid_and_step(collector):
    seen = {}

    def other():
        seen["tid"] = threading.get_native_id()
        with span("other"):
            pass

    with span("outer", step=7, k=1):
        with span("inner"):
            count("c")
        t = threading.Thread(target=other)
        t.start()
        t.join()
    with span("after"):
        count("c", 2)
    spans = collector.drain()
    assert _names(spans) == ["inner", "other", "outer", "after"]
    by = {s["name"]: s for s in spans}
    outer, inner, oth, after = by["outer"], by["inner"], by["other"], by["after"]
    assert outer["parent"] is None and inner["parent"] == outer["id"]
    assert oth["parent"] is None and after["parent"] is None
    assert outer["step"] == inner["step"] == oth["step"] == 7 and after["step"] is None
    main = threading.get_native_id()
    assert outer["tid"] == inner["tid"] == after["tid"] == main
    assert oth["tid"] == seen["tid"] != main
    assert outer["k"] == 1 and "k" not in inner
    assert len({s["id"] for s in spans}) == 4
    end = lambda s: s["t0"] + s["dur"] * 1e9      # noqa: E731
    assert outer["t0"] <= inner["t0"] and end(inner) <= end(outer) + 1
    assert outer["t0"] <= oth["t0"] and end(oth) <= end(outer) + 1
    assert end(outer) <= after["t0"] + 1
    assert spans.counts == {"c": 3}
    again = collector.drain()
    assert again == [] and again.counts == {}


def test_a_collection_is_a_gc_span_and_detaching_unhooks_it():
    col = SpanCollector()
    prev = set_spans(col)
    try:
        assert tally_hooks._on_gc in gc.callbacks
        with span("train.step", step=2):
            gc.collect()
    finally:
        set_spans(prev)
    assert tally_hooks._on_gc not in gc.callbacks
    spans = col.drain()
    full = [s for s in spans if s["name"] == "gc.gen2"]
    assert full and full[0]["step"] == 2 and full[0]["dur"] >= 0
    step = next(s for s in spans if s["name"] == "train.step")
    assert full[0]["parent"] == step["id"]
    gc.collect()
    assert col.drain() == []


def test_counters_lose_no_add_across_threads_and_drains():
    col = SpanCollector()
    drained, per = [], 2000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(per):
                col.count("c")

        threads = [threading.Thread(target=add) for _ in range(8)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            drained.append(col.drain().counts.get("c", 0))
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert sum(drained) + col.drain().counts.get("c", 0) == 8 * per


def test_data_plane_spans_drain_into_the_dashboards_sketches(collector):
    for _ in range(3):
        with span("train.optimizer"):
            pass
    count("remat.recomputes", 2)
    agg = MetricsAggregator("spans")
    out = agg.consume_spans(collector)
    assert out["train.optimizer"]["n"] == 3
    assert isinstance(collector.drain(), Drained)


def _cfg(arch, **patch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **patch)


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, size=(b, s + 1))
    return {"tokens": torch.from_numpy(t[:, :-1]).long(),
            "labels": torch.from_numpy(t[:, 1:]).long()}


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_remat_layer_spans_are_the_recomputes(arch, remat, collector):
    cfg = _cfg(arch, remat=remat)
    model = make_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    opt = model.init_opt()
    collector.drain()
    model.train_step(opt, _batch(cfg))
    spans = collector.drain()
    names = _names(spans)
    n = cfg.n_layers
    layers = [s for s in spans if s["name"] == "model.layer"]
    recomputes = [s for s in spans if s["name"] == "remat.layer"]
    assert sorted(s["i"] for s in layers) == list(range(n))
    assert sorted(s["i"] for s in recomputes) == (list(range(n)) if remat else [])
    assert spans.counts.get("remat.recomputes", 0) == len(recomputes)
    for one in ("train.forward", "train.backward", "train.optimizer", "model.embed",
                "model.head", "model.loss"):
        assert names.count(one) == 1, one
    by_id = {s["id"]: s for s in spans}
    fwd = next(s for s in spans if s["name"] == "train.forward")
    bwd = next(s for s in spans if s["name"] == "train.backward")
    assert all(by_id[s["parent"]] is fwd for s in layers)
    # on the CPU autograd runs the recompute on the calling thread
    assert all(by_id[s["parent"]] is bwd for s in recomputes)
    inner = ("mamba2.in_proj", "mamba2.conv", "mamba2.scan", "mamba2.out") \
        if cfg.family == "ssm" else ("block.attention", "block.mlp")
    for name in inner:
        assert names.count(name) == n * (2 if remat else 1), name
        assert all(by_id[s["parent"]]["name"] in ("model.layer", "remat.layer")
                   for s in spans if s["name"] == name)


def test_a_training_step_and_a_prefill_batch_carry_their_step(collector):
    cfg = _cfg("mamba2-2.7b", remat=True)
    fleet = build_tpu_fleet(pods=1, racks_per_pod=1, nodes_per_rack=1, chips_per_node=2,
                            device="cpu")
    rt = ElasticRuntime(SchedulerInstance("top", fleet), cfg, ShapeConfig("train", 16, 2, "train"),
                        chip_type="chip", device="cpu")
    assert rt.allocate(1)
    rt.bind(torch.Generator().manual_seed(0))
    batch = {k: v.numpy() for k, v in _batch(cfg).items()}
    collector.drain()
    for _ in range(2):
        rt.step(batch)
    spans = collector.drain()
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["step"] for s in steps] == [1, 2]
    for s in spans:
        if s["name"] != "train.step" and not s["name"].startswith("gc."):
            owner = next(t for t in steps if t["t0"] <= s["t0"] <= t["t0"] + t["dur"] * 1e9)
            assert s["step"] == owner["step"], s["name"]
    uploads = [s for s in spans if s["name"] == "train.upload"]
    assert [u["parent"] for u in uploads] == [s["id"] for s in steps]

    model = rt.model
    first = model.prefills
    tokens = torch.from_numpy(batch["tokens"])
    _, pcache = model.prefill_step(tokens)
    cache = model.init_cache(ShapeConfig("serve", 24, 2, "decode"))
    splice_cache(cache, pcache)
    spans = collector.drain()
    prefill = next(s for s in spans if s["name"] == "serve.prefill")
    assert prefill["step"] == first + 1 == model.prefills
    assert _names(spans).count("model.layer") == cfg.n_layers
    assert all(s["step"] == prefill["step"] for s in spans if s["name"] == "model.head")
    assert _names(spans)[-1] == "serve.splice"


def test_a_span_holds_a_profiler_range_on_the_profilers_clock(collector):
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("outer"):
            with record_function("inner_range"):
                torch.ones(64, 64).sum()
    rec = next(s for s in collector.drain() if s["name"] == "outer")
    ev = next(e for e in prof.profiler.kineto_results.events() if e.name() == "inner_range")
    start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    ms = 1_000_000
    assert rec["t0"] - ms <= start and end <= rec["t0"] + rec["dur"] * 1e9 + ms
    assert abs(start - rec["t0"]) < 50 * ms
