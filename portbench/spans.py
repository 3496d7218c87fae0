"""The program's spans in a traced window: each kernel and each idle gap
put down to the span of the port that caused it.

The port records its spans and counters into a collector that
``repro_torch.tally_hooks.set_spans`` attaches (that module's docstring
lists the spans and the record's fields). Each record's ``t0`` is ``time.time_ns()``: the Unix
epoch in nanoseconds, the clock of the profiler's host events, so that a
span and the CUDA runtime calls made inside it line up without a
conversion. ``SpanTracer`` is ``trace.Tracer`` with a collector attached
for the window; its ``summary`` is ``trace.summarize``'s, unchanged, and
``spans`` what ``attribute`` makes of the records. (``SpanTracer.window``,
``_parse`` and ``_name_gaps`` repeat ``trace.py``'s, which this module
may not change: the benchmark's files stay as they are until a benchmark
change moves ``attribute`` and this ``_name_gaps`` into ``trace.py`` in
place of the old ones and deletes the copies here.)

- ``spans``: {name: {"count", "host_s", "self_s", "device_s",
  "self_device_s", "idle_s"}}. A device operation (kernel, copy, set)
  belongs to the runtime call that launched it (the profiler links the
  two by ``correlation_id``); the call to the innermost span open on its
  own thread at its start or, where its thread has none open (autograd's
  device thread outside a recompute), to the innermost span open on any
  thread. (torch 2.11's profiler gives every CUDA call thread id 1, which
  is no span's ``tid``: the second rule decides, and is right while one
  thread launches at a time, as in the backward, where the main thread
  waits.) ``self_device_s`` is a span's own, ``device_s`` adds the spans
  inside it: on its thread through ``parent``, and a span opened with none
  on its thread lies inside the innermost span open on another thread at
  its start (the recompute inside ``train.backward``). ``idle_s`` sums the
  gaps of the device whose middle falls inside the span; ``self_s`` is
  ``host_s`` less the host time of the spans inside it. Device time that
  no span launched (the harness's own copies) is under ``NO_SPAN``;
- ``counts``: the program's counters over the window;
- ``idle_gaps``: the idle seconds by the innermost host event at a gap's
  middle, a runtime call or else a program span, as ``trace``'s breakdown
  names them by the calls alone;
- ``clock_offset_us``: the host clock just after the window's closing
  synchronize less the end of that synchronize in the trace. The closing
  one is the last ``cudaDeviceSynchronize`` to end before the
  ``cudaStreamWaitEvent`` of the closing (last) bracket (below) starts, both on
  the trace's clock: the profiler's own exit synchronizes the device
  again, later, while it still records. None without a stamp or without
  that bracket's call on the trace. It is read, not applied;
- ``clock_skew_us``: at the window's start and end, the middle of a
  ``cudaStreamWaitEvent`` call on the trace less the middle of the host
  clock's bracket around it (``_bracket``; None where the trace lacks it).

The readers' arithmetic (``optimizer_ms`` and the others) takes the
``run`` dict that ``cell.run`` hands a reader, with ``spans`` and
``counts`` added, and returns None where its kind or its span is missing.
``span_run.py`` runs a cell with the tracer and prints them.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from .trace import BETWEEN, LABELLED_GAPS, SYNC, WINDOW, Tracer, _ns, _top, _union, span, summarize

NO_SPAN = "(no span)"
WAIT = "cudaStreamWaitEvent"
GC = "gc."


class _Span:
    __slots__ = ("name", "t0", "t1", "tid", "id", "parent", "up", "names")

    def __init__(self, rec: dict):
        self.name, self.t0, self.tid = rec["name"], int(rec["t0"]), rec.get("tid")
        self.t1 = self.t0 + int(round(rec["dur"] * 1e9))
        self.id, self.parent = rec.get("id"), rec.get("parent")
        self.up: Optional["_Span"] = None


class SpanTracer(Tracer):
    """``trace.Tracer`` whose window, when ``on``, also attaches a span
    collector to the program and then holds ``spans`` (``attribute``'s)."""

    def __init__(self, on: bool, device: torch.device):
        super().__init__(on, device)
        self.spans: Optional[dict] = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            with span(WINDOW):
                yield
            return
        from repro_torch import tally_hooks
        from repro_torch.core.metrics import SpanCollector
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        collector = SpanCollector(maxlen=1 << 22)
        prev = tally_hooks.set_spans(collector)
        try:
            with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) \
                    as prof:
                brackets = []
                if cuda:
                    torch.cuda.synchronize(self.device)
                    brackets.append(_bracket(self.device))
                with span(WINDOW):
                    yield
                if cuda:
                    torch.cuda.synchronize(self.device)
                stamp = time.time_ns()
                if cuda:
                    brackets.append(_bracket(self.device))
        finally:
            tally_hooks.set_spans(prev)
        events = prof.profiler.kineto_results.events()
        self.summary = summarize(events)
        records = collector.drain()
        if collector.recorded > len(records):
            raise RuntimeError(f"the collector dropped {collector.recorded - len(records)} spans")
        self.spans = attribute(events, records, records.counts, stamp if cuda else None,
                               brackets)


def _bracket(device: torch.device) -> Tuple[int, int]:
    """The host clock just before and just after one ``cudaStreamWaitEvent``
    call, which the trace records: where the clocks agree, the trace puts
    the call inside the bracket."""
    event = torch.cuda.Event()
    event.record()
    stream = torch.cuda.current_stream(device)
    before = time.time_ns()
    stream.wait_event(event)
    return before, time.time_ns()


def _parse(events):
    """The trace as ``trace.summarize`` reads it: the device's operations
    (start, end, name, correlation id), the host's events (start, end,
    name, correlation id, thread) and the window."""
    from torch.autograd import DeviceType
    dev, host, window, syncs = [], [], None, []
    for ev in events:
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, name, ev.correlation_id()))
        else:
            host.append((start, start + dur, name, ev.correlation_id(), ev.start_thread_id()))
            if name == WINDOW:
                window = (start, start + dur)
            elif name.startswith(SYNC):
                syncs.append(start + dur)
    ranges = {h[2] for h in host}
    dev = [d for d in dev if d[2] not in ranges]
    if window is None and len(syncs) >= 2:
        window = (min(syncs), max(syncs))
    if window is None:
        raise RuntimeError(f"the trace has neither a {WINDOW} span nor two {SYNC}s")
    return dev, host, window, syncs


def _link(spans: List[_Span]) -> None:
    """Each span's enclosing span (``up``) and the distinct names of it
    and its enclosing spans (``names``)."""
    by_id = {s.id: s for s in spans if s.id is not None}
    orphans = []
    for s in spans:
        s.up = by_id.get(s.parent) if s.parent is not None else None
        if s.up is None:
            orphans.append(s)
    # a span with none open on its thread: the innermost open on another
    # thread at its start
    order = sorted(spans, key=lambda s: (s.t0, -s.t1))
    starts = [s.t0 for s in order]
    for s in orphans:
        i = bisect.bisect_right(starts, s.t0) - 1
        best = None
        while i >= 0:
            o = order[i]
            if o.tid != s.tid and o.t1 >= s.t1 and o is not s:
                best = o
                break
            i -= 1
        s.up = best
    for s in spans:
        names, cur, seen = [], s, set()
        while cur is not None and id(cur) not in seen:
            seen.add(id(cur))
            if cur.name not in names:
                names.append(cur.name)
            cur = cur.up
        s.names = tuple(names)


def _sweep(spans: List[_Span], calls: List[Tuple[int, object]], points: List[int]):
    """For each (start, tid) in ``calls`` the innermost span open on that
    thread at that time, or else on any thread; for each time in
    ``points`` the spans open then on any thread, innermost first."""
    threads = {s.tid for s in spans}
    marks = []
    for s in spans:
        marks.append((s.t0, 0, s))
        marks.append((s.t1, 3, s))
    for i, (t, _) in enumerate(calls):
        marks.append((t, 1, i))
    for i, t in enumerate(points):
        marks.append((t, 2, i))
    marks.sort(key=lambda m: (m[0], m[1]))
    stacks: Dict[object, List[_Span]] = defaultdict(list)
    call_span: List[Optional[_Span]] = [None] * len(calls)
    open_at: List[List[_Span]] = [[] for _ in points]

    def innermost():
        tops = [st[-1] for st in stacks.values() if st]
        return max(tops, key=lambda s: s.t0) if tops else None

    for _, kind, x in marks:
        if kind == 0:
            stacks[x.tid].append(x)
        elif kind == 3:
            st = stacks[x.tid]
            if st and st[-1] is x:
                st.pop()
            elif x in st:
                st.remove(x)
        elif kind == 1:
            tid = calls[x][1]
            own = stacks.get(tid) if tid in threads else None
            call_span[x] = own[-1] if own else innermost()
        else:
            open_at[x] = sorted((s for st in stacks.values() for s in st), key=lambda s: -s.t0)
    return call_span, open_at


def attribute(events, records, counts: Optional[dict] = None,
              stamp_ns: Optional[int] = None, brackets=()) -> dict:
    """What the module's docstring lists, from a profiler's events and the
    collector's records (and counters) of the same window."""
    dev, host, (w0, w1), syncs = _parse(events)
    spans = [_Span(r) for r in records]
    _link(spans)
    clipped, busy_ivs = [], []
    for s, e, name, corr in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e, corr))
            busy_ivs.append((s, e))
    busy = _union(busy_ivs)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]

    linked = {corr for _, _, corr in clipped}
    calls = [h for h in host if h[3] in linked and h[2] != WINDOW]
    mids = [(g0 + g1) // 2 for g0, g1 in gaps]
    call_span, open_at = _sweep(spans, [(h[0], h[4]) for h in calls], mids)
    owner = {h[3]: sp for h, sp in zip(calls, call_span)}

    table: Dict[str, Dict[str, float]] = defaultdict(lambda: dict.fromkeys(
        ("count", "host_s", "self_s", "device_s", "self_device_s", "idle_s"), 0.0))
    for s in spans:
        row = table[s.name]
        row["count"] += 1
        host_s = (s.t1 - s.t0) / 1e9
        row["host_s"] += host_s
        row["self_s"] += host_s
        if s.up is not None and s.up.name != s.name:
            table[s.up.name]["self_s"] -= host_s
    for s, e, corr in clipped:
        sec = (e - s) / 1e9
        sp = owner.get(corr)
        if sp is None:
            table[NO_SPAN]["device_s"] += sec
            table[NO_SPAN]["self_device_s"] += sec
            continue
        table[sp.name]["self_device_s"] += sec
        for name in sp.names:
            table[name]["device_s"] += sec
    for (g0, g1), inside in zip(gaps, open_at):
        for name in {s.name for s in inside}:
            table[name]["idle_s"] += (g1 - g0) / 1e9
    for row in table.values():
        row["count"] = int(row["count"])

    waits = [(h[0], h[1]) for h in host if h[2] == WAIT]
    skew, closing = [], None
    for before, after in brackets:
        near = [w for w in waits if before - 10 ** 6 <= w[0] <= after + 10 ** 6]
        mid = (before + after) / 2
        closing = min(near, key=lambda w: abs((w[0] + w[1]) / 2 - mid), default=None)
        skew.append(None if closing is None else ((closing[0] + closing[1]) / 2 - mid) / 1e3)
    ends = [e for e in syncs if closing is not None and e <= closing[0]]
    offset = (stamp_ns - max(ends)) / 1e3 if stamp_ns is not None and ends else None
    return {"spans": {k: dict(v) for k, v in table.items()}, "counts": dict(counts or {}),
            "idle_gaps": _name_gaps(gaps, host, open_at), "clock_offset_us": offset,
            "clock_skew_us": skew}


def _name_gaps(gaps, host, open_at) -> list:
    """``trace._name_gaps`` with the program's spans among the host's
    events: a gap between runtime calls takes the name of the innermost
    span open at its middle."""
    calls = sorted(h[:3] for h in host if h[2] != WINDOW and not h[2].startswith(SYNC))
    starts = [s for s, _, _ in calls]
    by: Dict[str, float] = defaultdict(float)
    ranked = sorted(range(len(gaps)), key=lambda i: gaps[i][0] - gaps[i][1])
    for i in ranked[:LABELLED_GAPS]:
        g0, g1 = gaps[i]
        mid = (g0 + g1) // 2
        label = open_at[i][0].name if open_at[i] else BETWEEN
        j = bisect.bisect_right(starts, mid) - 1
        for k in range(j, max(j - 20000, -1), -1):
            if calls[k][1] >= mid:
                if not open_at[i] or calls[k][0] >= open_at[i][0].t0:
                    label = calls[k][2]
                break
        by[label[:80]] += (g1 - g0) / 1e9
    rest = sum(gaps[i][1] - gaps[i][0] for i in ranked[LABELLED_GAPS:])
    if rest:
        by["(shorter gaps, not named)"] += rest / 1e9
    return _top(by.items())


# ------------------------------------------------------------------ #
# the readers' arithmetic
# ------------------------------------------------------------------ #
def _per_unit(run: dict, kind: str, unit: str, name: str) -> Optional[float]:
    """Device ms under span ``name`` per span ``unit`` (a step or batch)."""
    spans = run.get("spans")
    if run.get("kind") != kind or not spans or name not in spans:
        return None
    n = spans.get(unit, {}).get("count", 0)
    return 1e3 * spans[name]["device_s"] / n if n else None


def optimizer_ms(run: dict) -> Optional[float]:
    """Device ms a training step under ``train.optimizer`` (AdamW)."""
    return _per_unit(run, "train", "train.step", "train.optimizer")


def recompute_ms(run: dict) -> Optional[float]:
    """Device ms a training step under ``remat.layer``: the layers run again
    in the backward."""
    return _per_unit(run, "train", "train.step", "remat.layer")


def head_ms(run: dict) -> Optional[float]:
    """Device ms a prefill batch under ``model.head`` (the LM head)."""
    return _per_unit(run, "prefill", "serve.prefill", "model.head")


def gc_idle_share(run: dict) -> Optional[float]:
    """The device's idle time inside Python's collections (``gc.*``
    spans), as a share of the window; 0 where none ran."""
    spans = run.get("spans")
    if run.get("kind") != "train" or not spans or run.get("window_s", 0) <= 0:
        return None
    idle = sum(row["idle_s"] for name, row in spans.items() if name.startswith(GC))
    return 100.0 * idle / run["window_s"]


READINGS = {"optimizer_ms.train": optimizer_ms, "recompute_ms.train": recompute_ms,
            "head_ms.prefill": head_ms, "gc_idle_share.train": gc_idle_share}


def table_lines(run: dict, units: int) -> List[str]:
    """The by-span table for standard error: count, host ms, self ms,
    device ms and idle ms, each per step or batch, then the counters."""
    spans = run.get("spans") or {}
    n = max(units, 1)
    out = [f"by span, per step or batch ({units}): name: count, host ms, self ms, device ms "
           "(own), idle ms"]
    for name, row in sorted(spans.items(), key=lambda kv: -kv[1]["device_s"]):
        out.append(f"  {name}: {row['count'] / n:.2f}, {1e3 * row['host_s'] / n:.3f}, "
                   f"{1e3 * row['self_s'] / n:.3f}, {1e3 * row['device_s'] / n:.3f} "
                   f"({1e3 * row['self_device_s'] / n:.3f}), {1e3 * row['idle_s'] / n:.3f}")
    out.append("counters: " + (", ".join(f"{k} {v}" for k, v in sorted(
        (run.get("counts") or {}).items())) or "none"))
    return out
