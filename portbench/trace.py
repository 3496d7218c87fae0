"""The device trace of a run's window: ``torch.profiler`` kept in memory,
reduced to what the per-layer metrics and the breakdown read.

On a card only the device's activity is recorded (kernels, copies, sets,
and the CUDA runtime calls that launched them): recording every host
operator as well made mamba2's training steps a third slower, and its
device a third idle, under the profiler. The window runs from the end of
one device synchronize to the end of another, both issued by the tracer
around the driver's loop. (On the CPU, for the tests, the host's operators
are recorded and the window is the span ``portbench.window``.) Device
activity is clipped to the window; busy time is the union of those
intervals; an idle gap is named by the innermost host event running at its
middle: a CUDA runtime call, or none (the host between calls). Nothing is
written to disk.
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
SYNC = "cudaDeviceSynchronize"
BETWEEN = "host, between CUDA calls"
TOP = 10
LABELLED_GAPS = 4000          # the longest gaps are named; the rest are counted unnamed


def _ns(event, what: str) -> int:
    f = getattr(event, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(event, f"{what}_us")() * 1000)


def span(name: str):
    """A harness span: a ``record_function`` range in the trace."""
    return torch.profiler.record_function(name)


class Tracer:
    """``window()`` profiles what runs inside it when ``on``; ``summary``
    then holds the reduced trace (None when off)."""

    def __init__(self, on: bool, device: torch.device):
        self.on = on
        self.device = device
        self.summary: Optional[dict] = None

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            with span(WINDOW):
                yield
            return
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            if cuda:
                torch.cuda.synchronize(self.device)
            with span(WINDOW):
                yield
            if cuda:
                torch.cuda.synchronize(self.device)
        self.summary = summarize(prof.profiler.kineto_results.events())


def _union(ivs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events) -> dict:
    """{"window_s", "busy_s", "kernels": {name: [launches, seconds]},
    "breakdown": {"device_ops", "idle_gaps"}} of a profiler's events."""
    from torch.autograd import DeviceType

    dev, host, window, syncs = [], [], None, []
    for ev in events:
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            dev.append((start, start + dur, ev.name()))
        else:
            host.append((start, start + dur, ev.name()))
            if ev.name() == WINDOW:
                window = (start, start + dur)
            elif ev.name().startswith(SYNC):
                syncs.append(start + dur)
    # a host range (``record_function``) is also drawn on the device's
    # timeline over the kernels it launched: not device work
    ranges = {name for _, _, name in host}
    dev = [d for d in dev if d[2] not in ranges]
    if window is None and len(syncs) >= 2:
        window = (min(syncs), max(syncs))
    if window is None:
        raise RuntimeError(f"the trace has neither a {WINDOW} span nor two {SYNC}s")
    w0, w1 = window
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    clipped = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        clipped.append((s, e))
        kernels[name][0] += 1
        kernels[name][1] += (e - s) / 1e9
    busy = _union(clipped)
    busy_ns = sum(e - s for s, e in busy)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernels": {k: v for k, v in kernels.items()},
            "breakdown": {"device_ops": _top([(k, v[1]) for k, v in kernels.items()]),
                          "idle_gaps": _name_gaps(gaps, host)}}


def _top(pairs) -> list:
    return [[name[:120], sec] for name, sec in sorted(pairs, key=lambda p: -p[1])[:TOP]]


def _name_gaps(gaps: List[Tuple[int, int]], host: List[Tuple[int, int, str]]) -> list:
    """The idle seconds summed by what the host was doing: the innermost
    host event (the latest to start) that spans the gap's middle."""
    host = sorted(e for e in host if e[2] != WINDOW and not e[2].startswith(SYNC))
    starts = [s for s, _, _ in host]
    by: Dict[str, float] = defaultdict(float)
    ranked = sorted(gaps, key=lambda g: g[0] - g[1])
    for g0, g1 in ranked[:LABELLED_GAPS]:
        mid = (g0 + g1) // 2
        label = BETWEEN
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 20000, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by[label[:80]] += (g1 - g0) / 1e9
    rest = sum(g1 - g0 for g0, g1 in ranked[LABELLED_GAPS:])
    if rest:
        by["(shorter gaps, not named)"] += rest / 1e9
    return _top(by.items())
