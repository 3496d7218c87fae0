"""The program's spans in a traced window (``spans.py``): the attribution
of device time and idle gaps on a synthetic trace of two threads, the
readers' arithmetic, and tiny runs of every cell under ``SpanTracer``."""
from __future__ import annotations

import math
import time
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from portbench import span_run, spans
from portbench.spec import Bench
from portbench.trace import BETWEEN, summarize
from tiny import CPU, tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = Bench(ROOT)
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
US = 1000                           # the synthetic trace counts microseconds
MAIN, AUTOGRAD = 10, 20


class Ev:
    def __init__(self, name, start, end, corr=0, tid=MAIN, device=False):
        self._n, self._c, self._t = name, corr, tid
        self._s, self._d = start * US, (end - start) * US
        self._dev = DeviceType.CUDA if device else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def _rec(name, t0, t1, id, parent, tid=MAIN, step=1):
    return {"name": name, "t0": t0 * US, "dur": (t1 - t0) * US / 1e9, "tid": tid, "id": id,
            "parent": parent, "step": step}


# a training step: the forward with one layer and a full collection, the
# backward with one recompute on autograd's thread and one kernel it
# launches outside it, the optimizer; then a copy of the harness's
RECORDS = [_rec("model.layer", 120, 250, 3, 2), _rec("gc.gen2", 260, 380, 7, 2),
           _rec("train.forward", 110, 400, 2, 1),
           _rec("remat.layer", 450, 600, 5, None, tid=AUTOGRAD),
           _rec("train.backward", 400, 800, 4, 1), _rec("train.optimizer", 800, 890, 6, 1),
           _rec("train.step", 100, 900, 1, None)]
EVENTS = [Ev("cudaDeviceSynchronize", -5, 0), Ev("cudaDeviceSynchronize", 995, 1000),
          Ev("cudaLaunchKernel", 130, 131, 1), Ev("k_layer", 140, 200, 1, device=True),
          Ev("cudaLaunchKernel", 390, 391, 2), Ev("k_forward", 395, 420, 2, device=True),
          Ev("cudaLaunchKernel", 460, 461, 3, AUTOGRAD),
          Ev("k_recompute", 470, 550, 3, device=True),
          Ev("cudaLaunchKernel", 610, 615, 4, AUTOGRAD),
          Ev("k_backward", 620, 700, 4, device=True),
          Ev("cudaStreamSynchronize", 750, 770, 0),
          Ev("cudaLaunchKernel", 810, 811, 5), Ev("k_adamw", 820, 880, 5, device=True),
          Ev("cudaMemcpyAsync", 950, 951, 6), Ev("Memcpy HtoD", 955, 990, 6, device=True),
          Ev(spans.WAIT, 2, 3), Ev(spans.WAIT, 1001, 1002)]


def _s(us):
    return us * US / 1e9


def test_device_time_and_gaps_go_to_the_spans_that_caused_them():
    brackets = [(1 * US, 4 * US), (1000 * US, 1001 * US)]
    got = spans.attribute(EVENTS, RECORDS, {"remat.recomputes": 1}, stamp_ns=1007 * US,
                          brackets=brackets)
    t = got["spans"]
    device = {"model.layer": 60, "train.forward": 85, "remat.layer": 80, "train.backward": 160,
              "train.optimizer": 60, "train.step": 305, "gc.gen2": 0, spans.NO_SPAN: 35}
    own = {"model.layer": 60, "train.forward": 25, "remat.layer": 80, "train.backward": 80,
           "train.optimizer": 60, "train.step": 0, "gc.gen2": 0, spans.NO_SPAN: 35}
    idle = {"model.layer": 0, "train.forward": 195, "gc.gen2": 195, "remat.layer": 70,
            "train.backward": 240, "train.optimizer": 0, "train.step": 435, spans.NO_SPAN: 0}
    assert set(t) == set(device)
    for name in device:
        assert t[name]["device_s"] == pytest.approx(_s(device[name]), abs=1e-15), name
        assert t[name]["self_device_s"] == pytest.approx(_s(own[name]), abs=1e-15), name
        assert t[name]["idle_s"] == pytest.approx(_s(idle[name]), abs=1e-15), name
    assert t["train.step"]["count"] == 1 and t["train.step"]["host_s"] == pytest.approx(_s(800))
    # the step's own host time: less the forward, backward and optimizer
    assert t["train.step"]["self_s"] == pytest.approx(_s(800 - 290 - 400 - 90))
    assert t["train.backward"]["self_s"] == pytest.approx(_s(400 - 150))
    assert got["counts"] == {"remat.recomputes": 1}
    assert got["clock_offset_us"] == pytest.approx(7.0)
    # the waits' middles on the trace less their brackets' on the host
    assert got["clock_skew_us"] == [pytest.approx(0.0), pytest.approx(1.0)]
    assert spans.attribute(EVENTS, RECORDS)["clock_offset_us"] is None
    gaps = dict(got["idle_gaps"])
    assert gaps == pytest.approx({BETWEEN: _s(225), "gc.gen2": _s(195), "train.backward": _s(50),
                                  "remat.layer": _s(70), "cudaStreamSynchronize": _s(120)})
    # what trace.summarize reads of the same trace is the spans' whole
    base = summarize(EVENTS)
    assert base["window_s"] == pytest.approx(_s(1000))
    assert base["busy_s"] == pytest.approx(_s(340))
    assert sum(r["self_device_s"] for r in t.values()) == pytest.approx(base["busy_s"])
    assert sum(s for _, s in base["breakdown"]["idle_gaps"]) == pytest.approx(_s(660))


def test_a_call_on_a_thread_no_span_knows_goes_to_the_innermost_open_span():
    """The profiler's thread ids need not be the spans' (``tid``): a call
    on a thread of none of them takes the innermost span open anywhere."""
    events = [Ev(e.name(), e.start_ns() // US, (e.start_ns() + e.duration_ns()) // US,
                 e.correlation_id(), 99, e.device_type() == DeviceType.CUDA) for e in EVENTS]
    t = spans.attribute(events, RECORDS)["spans"]
    assert t["remat.layer"]["self_device_s"] == pytest.approx(_s(80))
    assert t["train.backward"]["self_device_s"] == pytest.approx(_s(80))
    assert t["model.layer"]["self_device_s"] == pytest.approx(_s(60))
    assert t["train.step"]["device_s"] == pytest.approx(_s(305))


def _run(kind, **rows):
    table = {name: dict.fromkeys(("count", "host_s", "self_s", "device_s", "self_device_s",
                                  "idle_s"), 0.0) for name in rows}
    for name, row in rows.items():
        table[name].update(row)
    return {"kind": kind, "units": 2, "window_s": 4.0, "busy_s": 3.0, "spans": table,
            "counts": {}}


def test_the_readers_read_their_spans_and_nothing_else():
    train = _run("train", **{"train.step": {"count": 2}, "train.optimizer": {"device_s": 0.3},
                             "remat.layer": {"device_s": 0.8}, "gc.gen2": {"idle_s": 0.1},
                             "gc.gen0": {"idle_s": 0.02}})
    assert spans.optimizer_ms(train) == pytest.approx(150.0)
    assert spans.recompute_ms(train) == pytest.approx(400.0)
    assert spans.gc_idle_share(train) == pytest.approx(3.0)
    assert spans.head_ms(train) is None
    prefill = _run("prefill", **{"serve.prefill": {"count": 4}, "model.head": {"device_s": 0.2}})
    assert spans.head_ms(prefill) == pytest.approx(50.0)
    for read in (spans.optimizer_ms, spans.recompute_ms, spans.gc_idle_share):
        assert read(prefill) is None
    no_gc = _run("train", **{"train.step": {"count": 2}})
    assert spans.gc_idle_share(no_gc) == 0.0
    assert spans.optimizer_ms(no_gc) is None and spans.recompute_ms(no_gc) is None
    bare = {"kind": "train", "units": 2, "window_s": 4.0, "busy_s": 3.0}
    assert all(read(bare) is None for read in spans.READINGS.values())
    assert len(spans.table_lines(train, 2)) == 2 + len(train["spans"])


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_traced_run_puts_its_window_down_to_the_programs_spans(workload):
    config, mix = tiny(BENCH, workload)
    result = span_run.traced(BENCH, workload, 2 ** 31 + 7, 0.3, CPU, time.perf_counter(),
                             config=config, mix=mix)
    assert result["correct"] and "breakdown" in result
    t, kind = result["spans"], mix["driver"]
    unit = "train.step" if kind == "train" else "serve.prefill"
    assert t[unit]["count"] > 0
    assert t["model.layer"]["count"] == t[unit]["count"] * config["port"]["n_layers"]
    if kind == "train":
        assert result["counts"]["remat.recomputes"] == t["remat.layer"]["count"] \
            == t["model.layer"]["count"]
        assert t["train.optimizer"]["count"] == t[unit]["count"]
    else:
        assert t["serve.splice"]["count"] == t[unit]["count"]
    readings = result["span_readings"]
    want = {"train": {"optimizer_ms.train", "recompute_ms.train", "gc_idle_share.train"},
            "prefill": {"head_ms.prefill"}}[kind]
    assert set(readings) == want and all(math.isfinite(v) for v in readings.values())
    # no card: nothing on the device, and no synchronize to read the clock by
    assert result["clock_offset_us"] is None


def test_the_clock_offset_reads_the_windows_closing_synchronize():
    # the profiler's exit synchronizes the device again after the closing
    # bracket: the offset is read from the synchronize before the bracket
    brackets = [(1 * US, 4 * US), (1000 * US, 1001 * US)]
    exit_sync = Ev("cudaDeviceSynchronize", 1003, 1012)
    got = spans.attribute(EVENTS + [exit_sync], RECORDS, stamp_ns=1007 * US, brackets=brackets)
    assert got["clock_offset_us"] == pytest.approx(7.0)
    # without the closing bracket's call on the trace, no skew and no offset
    got = spans.attribute(EVENTS, RECORDS, stamp_ns=1007 * US,
                          brackets=[brackets[0], (5000 * US, 5001 * US)])
    assert got["clock_skew_us"] == [pytest.approx(0.0), None]
    assert got["clock_offset_us"] is None
