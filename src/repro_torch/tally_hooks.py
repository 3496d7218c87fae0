"""Where the port's layers report their work to a running tally, and
their spans and counters to a span collector.

The collective helpers (``parallel/sharding.py``) call
``record_collective`` with each collective's result, and each kernel's
wrapper (``kernels/*.py``) is decorated ``counts_as(plain)``. Both do
nothing until a counter is set (``set_sink``): ``launch/tally.py`` sets
one for the step it counts. This module imports nothing of the port, so
the layers below depend on it and not on the launcher above them.

A sink has two methods: ``collective(kind, result)``, and ``kernel(plain,
kernel, args, kwargs)``, which runs ``kernel(*args, **kwargs)``, counts
what ``plain`` would on the same arguments and returns the kernel's
result.

The data plane's spans (``span``) and counters (``count``) go to a
collector set by ``set_spans``, with the two methods of
``core/metrics.py::SpanCollector``: ``record(dict)`` and ``count(name,
n)``. With none set, ``span`` returns one shared object that does nothing
(one global read and an ``is None`` check) and ``count`` returns at once.
There is no flag, environment variable or setting: setting a collector is
the switch. An operator attaches one around the steps to look at::

    col = SpanCollector()
    prev = tally_hooks.set_spans(col)      # also hooks gc.callbacks
    try:
        runtime.step(batch)                 # or model.prefill_step(...)
    finally:
        tally_hooks.set_spans(prev)         # unhooks gc
    records = col.drain()                   # the records; records.counts: the counters

or hands ``set_spans`` a collector that ``ClusterHealth`` hangs
(``health.collectors``), so that ``MetricsAggregator.consume_spans``,
which reads only ``name``, ``dur`` and ``stages``, sketches the data
plane's spans beside the control plane's. A span records when it closes::

    {"name", "t0": time.time_ns() at entry, "dur": seconds,
     "tid": threading.get_native_id(), "id", "parent": the id of the
     innermost span open on the same thread (or None), "step", **attrs}

``t0`` is on the Unix epoch in nanoseconds, the clock of the profiler's
host events, so a span lies on a trace's timeline as stamped.
``step`` is the step or batch the span belongs to: a span opened with
``step=`` sets it for every span that opens inside it, on any thread
(autograd's device thread runs remat's recompute inside the training
step that the main thread has open). While a collector is set, a
``gc.callbacks`` hook records Python's collections as spans ``gc.gen0``
to ``gc.gen2``. The spans and where they are opened:

- ``train.step`` (``step``: the optimizer's step it takes), whole
  ``runtime/elastic.py::ElasticRuntime.step``; ``train.upload``, the
  batch's copies to the device in it;
- ``train.forward`` (leaves, casts, ``loss_fn``) and ``train.backward``
  (the ``torch.autograd.grad`` call) in ``Model._value_and_grad``;
  ``train.optimizer``, ``apply_updates`` in ``Model.train_step``;
- ``model.embed``, ``model.head``, ``model.loss``: ``transformer._inputs``,
  ``layers.lm_logits``, ``layers.cross_entropy`` in ``loss_fn``;
- ``model.layer`` (attr ``i``): each layer body in ``transformer.forward``;
  ``remat.layer`` (``i``): the same body run again by
  ``torch.utils.checkpoint`` in the backward, counted in
  ``remat.recomputes``;
- ``mamba2.in_proj``, ``mamba2.conv``, ``mamba2.scan``, ``mamba2.out``: the
  four parts of ``models/mamba2.py::mamba_layer``; ``block.attention``,
  ``block.mlp``: the halves of ``transformer._block``;
- ``serve.prefill`` (``step``: the model's prefill count),
  ``Model.prefill_step``; ``serve.splice``, ``launch/serve.py::splice_cache``.

The kernels' wrappers have no spans: ``kernels/build.LAUNCHES`` counts
their calls, and a wrapper's host time is the self time of the span
around it. ``portbench/spans.py`` puts a traced window's kernels and idle
gaps down to these spans.
"""
from __future__ import annotations

import functools
import gc
import itertools
import threading
import time
from typing import Any, Callable, Dict, Optional

_SINK: Optional[Any] = None
_SPANS: Optional[Any] = None
_STEP: Optional[int] = None
_OPEN = threading.local()           # .stack: the ids of the spans open on a thread
_IDS = itertools.count(1)
_GC_T0 = [0]


def set_sink(sink: Optional[Any]) -> Optional[Any]:
    """Make ``sink`` the active counter (None: none); returns the one before."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def record_collective(kind: str, result) -> None:
    """Count one collective of ``kind`` whose result is the tensor
    ``result`` (the gathered or reduced array, an all-to-all's received
    buffer) in the active counter, if any."""
    if _SINK is not None:
        _SINK.collective(kind, result)


def counts_as(plain: Callable) -> Callable:
    """Decorate a kernel's wrapper, whose signature is its plain version
    ``plain``'s: under an active counter the call counts as ``plain`` on
    the same arguments would, and the wrapper's own ops do not count."""
    def wrap(kernel: Callable) -> Callable:
        @functools.wraps(kernel)
        def run(*args, **kwargs):
            if _SINK is None:
                return kernel(*args, **kwargs)
            return _SINK.kernel(plain, kernel, args, kwargs)
        return run
    return wrap


def set_spans(collector: Optional[Any]) -> Optional[Any]:
    """Make ``collector`` the one spans and counters go to (None: none)
    and hook Python's garbage collector while one is set; returns the one
    before."""
    global _SPANS
    prev, _SPANS = _SPANS, collector
    hooked = _on_gc in gc.callbacks
    if collector is not None and not hooked:
        gc.callbacks.append(_on_gc)
    elif collector is None and hooked:
        gc.callbacks.remove(_on_gc)
    return prev


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the set collector, if any."""
    c = _SPANS
    if c is not None:
        c.count(name, n)


class _Off:
    """The span of a run with no collector: enters and leaves, records
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> list:
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    return stack


class _Span:
    __slots__ = ("collector", "name", "attrs", "sets", "prev_step", "t0", "id", "parent", "step")

    def __init__(self, collector: Any, name: str, step: Optional[int], attrs: Dict):
        self.collector, self.name, self.attrs, self.sets = collector, name, attrs, step

    def __enter__(self):
        global _STEP
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        if self.sets is not None:
            self.prev_step, _STEP = _STEP, self.sets
        self.step = _STEP
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        global _STEP
        t1 = time.time_ns()
        stack = _stack()
        if self.id in stack:
            stack.remove(self.id)
        if self.sets is not None:
            _STEP = self.prev_step
        self.collector.record(dict(self.attrs, name=self.name, t0=self.t0,
                                   dur=(t1 - self.t0) / 1e9, tid=threading.get_native_id(),
                                   id=self.id, parent=self.parent, step=self.step))
        return False


def span(name: str, step: Optional[int] = None, **attrs):
    """A context manager around a piece of the data plane: with a
    collector set, it records ``name``, its clock and ``attrs`` when it
    closes; with ``step``, that step is the one of every span opened
    inside it. With none set, the shared ``OFF``."""
    c = _SPANS
    if c is None:
        return OFF
    return _Span(c, name, step, attrs)


def _on_gc(phase: str, info: Dict) -> None:
    """Python's collections as spans ``gc.gen<generation>`` (the collector
    is not reentrant: one start at a time)."""
    if phase == "start":
        _GC_T0[0] = time.time_ns()
        return
    c = _SPANS
    if c is None:
        return
    t0, t1 = _GC_T0[0], time.time_ns()
    stack = _stack()
    c.record({"name": f"gc.gen{info['generation']}", "t0": t0, "dur": (t1 - t0) / 1e9,
              "tid": threading.get_native_id(), "id": next(_IDS),
              "parent": stack[-1] if stack else None, "step": _STEP,
              "collected": info.get("collected", 0)})
