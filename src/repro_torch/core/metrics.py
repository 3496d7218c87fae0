"""Fleet metrics derived from the typed event stream.

The dynamic-graph model only pays off operationally if an operator can
*see* the fleet: utilization, fragmentation, wait percentiles, churn,
fair-share burn, lease debt ("Job Scheduling in High Performance
Computing" names wait-time percentiles and utilization as the canonical
RJMS health metrics).  This module derives all of them from the one
surface every consumer already has — the :class:`~repro_torch.core.events`
journal — instead of polling internals:

* :class:`MetricsAggregator` folds the typed :class:`JobEvent` stream
  into counters, busy-vertex integrals, and streaming percentile
  sketches.  Two feeding modes, identical results (the same
  replay==live contract the EventLog asserts):

  - **live push** — ``follow(log)`` attaches a batch sink; the hot path
    is one deque append per delivery chunk (folding is deferred to the
    next read, so emitters pay near-nothing);
  - **cursor replay** — ``pump(api)`` folds ``events_since(cursor)``,
    the reconnect path.  A cursor that fell behind the journal's
    retained window is *detected* (``events[0].seq > cursor``) and
    surfaced as ``resyncs``/``gap_events`` instead of silently skewing
    the derived metrics.

* :class:`QuantileSketch` — a bounded, deterministic, mergeable
  log-bucket sketch (DDSketch-style): p50/p90/p99 with relative error
  ≤ ``alpha`` without retaining samples.  Determinism and
  order-insensitivity of the bucket counts are what make the
  replay==live equivalence exact.

* :class:`SpanCollector` — a bounded pull-drained buffer for the
  structured trace spans ``GrowEngine`` (and ``SchedulerInstance``
  release) record per stage: local match → reclaim → revoke → forward
  → external → splice; the data plane's spans and counters
  (``tally_hooks.span`` / ``count``, whose module docstring lists them).
  Producers pay one ``is None`` check when no collector is attached;
  ``record`` takes only the collector's own lock and never calls out
  (the R2/R3 concurrency contract).

* :func:`fragmentation` — largest-free-block vs total-free per type,
  computed from the same per-vertex pruning aggregates the
  ``FlatGraph`` mirrors (``agg_free``), in one O(V) sweep.

Per-instance aggregators merge into a fleet rollup (``merge``), which
is how the dashboard consumer (``runtime/dashboard.py``) builds the
``status``/``metrics``/``tenants`` RPC view.
"""
from __future__ import annotations

import collections
import math
import threading
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..analysis.lockwitness import named_lock
from .events import EventType, JobEvent

__all__ = ["QuantileSketch", "SpanCollector", "Drained", "MetricsAggregator",
           "fragmentation"]


# ---------------------------------------------------------------------- #
# streaming quantiles
# ---------------------------------------------------------------------- #
class QuantileSketch:
    """Bounded streaming quantile sketch (log-width buckets).

    Values land in geometric buckets ``(gamma^(k-1), gamma^k]`` with
    ``gamma = (1+alpha)/(1-alpha)``; a quantile query returns the
    bucket midpoint ``2·gamma^k/(gamma+1)``, so the relative error is
    at most ``alpha`` for any quantile.  Counting is commutative:
    folding the same samples in any order (or merging partial sketches)
    yields bit-identical state — the property the replay==live metrics
    equivalence rests on.  ``maxbins`` bounds memory; on overflow the
    lowest buckets collapse (upper quantiles stay exact-within-alpha).
    """

    __slots__ = ("alpha", "_gamma", "_lg", "buckets", "zero", "n",
                 "sum", "max", "maxbins")

    def __init__(self, alpha: float = 0.01, maxbins: int = 2048):
        assert 0.0 < alpha < 1.0
        self.alpha = alpha
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self.buckets: Dict[int, int] = {}
        self.zero = 0               # values <= 0 count as exactly 0
        self.n = 0
        self.sum = 0.0
        self.max = 0.0
        self.maxbins = maxbins

    def add(self, x: float) -> None:
        self.n += 1
        if x <= 0.0:
            self.zero += 1
            return
        self.sum += x
        if x > self.max:
            self.max = x
        k = math.ceil(math.log(x) / self._lg)
        b = self.buckets
        b[k] = b.get(k, 0) + 1
        if len(b) > self.maxbins:
            # collapse the two lowest buckets (keeps p50+ accurate)
            keys = sorted(b)
            b[keys[1]] += b.pop(keys[0])

    def quantile(self, q: float) -> Optional[float]:
        if self.n == 0:
            return None
        rank = max(int(math.ceil(q * self.n)), 1)
        if rank <= self.zero:
            return 0.0
        seen = self.zero
        g = self._gamma
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if seen >= rank:
                return 2.0 * g ** k / (g + 1.0)
        return self.max

    def merge(self, other: "QuantileSketch") -> None:
        assert math.isclose(self.alpha, other.alpha), \
            "merging sketches needs one resolution"
        self.n += other.n
        self.zero += other.zero
        self.sum += other.sum
        self.max = max(self.max, other.max)
        b = self.buckets
        for k, c in other.buckets.items():
            b[k] = b.get(k, 0) + c

    def summary(self) -> Dict[str, Optional[float]]:
        return {"n": self.n,
                "mean": self.sum / max(self.n - self.zero, 1)
                if self.n else None,
                "p50": self.quantile(0.50),
                "p90": self.quantile(0.90),
                "p99": self.quantile(0.99),
                "max": self.max if self.n else None}


# ---------------------------------------------------------------------- #
# trace spans
# ---------------------------------------------------------------------- #
class Drained(list):
    """The spans of one :meth:`SpanCollector.drain`, in the order they
    closed, and in ``counts`` the counters added since the drain before."""

    def __init__(self, spans=(), counts: Optional[Dict[str, int]] = None):
        super().__init__(spans)
        self.counts: Dict[str, int] = counts if counts is not None else {}


class SpanCollector:
    """Bounded buffer for structured span records (plain dicts), and
    counters beside them.

    Producers (``GrowEngine.grow``, ``SchedulerInstance.release``; the
    data plane's spans through ``tally_hooks.set_spans``) call
    :meth:`record` with ``{"name", "dur", ...}`` (the control plane's
    ``{"name", "level", "jobid", "ok", "via", "dur", "stages": {stage:
    seconds}}``) and :meth:`count` with a counter's name and increment;
    consumers :meth:`drain` on their own schedule.  ``record`` is one
    atomic deque append — no lock — and never emits, calls back, or
    touches a transport; the producer may hold a scheduler lock's
    *caller* frame, so obeying R2/R3 here is load-bearing, not style.
    ``count`` takes only the collector's own lock."""

    def __init__(self, maxlen: int = 65536):
        self._lock = named_lock("spancollector")
        self._spans: Deque[Dict] = collections.deque(maxlen=maxlen)
        self.recorded = 0           # monotonic (drain does not reset)
        self.counts: Dict[str, int] = {}

    def record(self, span: Dict) -> None:
        # lock-free: deque.append is atomic and bounded by maxlen; a
        # racing drain sees the span either this drain or next.  The
        # counter increment can lose a tick under concurrent
        # producers — it is a monitoring gauge, not an invariant
        self._spans.append(span)
        self.recorded += 1

    def count(self, name: str, n: int = 1) -> None:
        # a read-modify-write: under the drain's lock, so that two threads'
        # adds, or an add racing a drain, lose nothing
        with self._lock:
            self.counts[name] = self.counts.get(name, 0) + n

    def drain(self) -> Drained:
        """The spans recorded since the last drain, with the counters
        (``Drained.counts``), which restart."""
        with self._lock:            # one drainer at a time
            counts, self.counts = self.counts, {}
            out = Drained(counts=counts)
            try:
                while True:
                    out.append(self._spans.popleft())
            except IndexError:
                return out

    def __len__(self) -> int:
        return len(self._spans)


# ---------------------------------------------------------------------- #
# fragmentation from the pruning aggregates
# ---------------------------------------------------------------------- #
def fragmentation(graph) -> Dict[str, Dict[str, float]]:
    """Largest-free-block vs total-free, per resource type.

    A *block* of type ``t`` is a vertex whose whole subtree is free in
    ``t`` (``agg_free[t] == subtree capacity of t``) — the largest unit
    a single contiguous match could claim.  ``frag = 1 -
    largest/total``: 0.0 when all free capacity is one contiguous
    block, approaching 1.0 when it is shattered into single vertices.
    One O(V) post-order sweep over the same per-vertex aggregates the
    ``FlatGraph`` ``agg`` table mirrors."""
    total: Dict[str, int] = {}
    for root in graph.roots:
        for t, n in graph.vertex(root).agg_free.items():
            total[t] = total.get(t, 0) + n
    largest: Dict[str, int] = {}
    cap: Dict[str, Dict[str, int]] = {}
    # iterative post-order: children's capacity sums roll up before the
    # parent is scored (graphs are shallow but can be wide)
    for root in graph.roots:
        stack: List[Tuple[str, bool]] = [(root, False)]
        while stack:
            path, done = stack.pop()
            if not done:
                stack.append((path, True))
                for c in graph.children(path):
                    stack.append((c, False))
                continue
            v = graph.vertex(path)
            c_cap: Dict[str, int] = {v.type: 1}
            for c in graph.children(path):
                for t, n in cap.pop(c).items():
                    c_cap[t] = c_cap.get(t, 0) + n
            cap[path] = c_cap
            free = v.agg_free
            for t, n in c_cap.items():
                if n and free.get(t, 0) == n and n > largest.get(t, 0):
                    largest[t] = n
    out: Dict[str, Dict[str, float]] = {}
    for t, n in total.items():
        big = largest.get(t, 0)
        out[t] = {"total_free": float(n), "largest_block": float(big),
                  "frag": 1.0 - big / n if n else 0.0}
    return out


# ---------------------------------------------------------------------- #
# the aggregator
# ---------------------------------------------------------------------- #
class MetricsAggregator:
    """Folds one instance's :class:`JobEvent` stream into derived
    metrics; per-instance aggregators :meth:`merge` into fleet rollups.

    Everything in :meth:`derived` is a pure function of the event
    sequence (per-event fold, order given by ``seq``), so live
    subscription, cursor replay, and a remote-over-mux feed of the same
    trace produce identical output — the tier-1-asserted contract.
    Gauges (:meth:`gauges` — utilization/fragmentation sampled from a
    graph) and span histograms are reported separately because they
    are not event-derived.

    Hot path: :meth:`sink` (the ``add_sink`` batch callback) appends
    the delivered chunk *by reference* and returns — O(1) per chunk,
    no per-event work on the emitter's thread.  Folding happens on the
    next :meth:`derived`/:meth:`snapshot` read, or — once
    ``FOLD_EVERY`` events have buffered (the memory bound) — on the
    aggregator's own folder thread when attached via :meth:`follow`,
    so the producer never pays the fold; the inline fold remains only
    for bare ``sink`` wirings with no folder running."""

    FOLD_EVERY = 8192

    def __init__(self, name: str = "instance", *, weight: float = 1.0,
                 alpha: float = 0.01):
        self.name = name
        self.weight = weight
        self._lock = named_lock(f"metrics:{name}")
        self._pend: Deque[List[JobEvent]] = collections.deque()
        self._pend_n = 0
        self._unsub: Optional[Callable[[], None]] = None
        self._folder: Optional[threading.Thread] = None
        self._folder_stop = threading.Event()
        self._folder_wake = threading.Event()
        # ---- event-derived state (all fold-updated) ----
        # keyed by the enum's raw ``_value_`` string: Enum.__hash__ is
        # a Python-level call (~300ns) and the fold needs two lookups
        # per event, while a str key hashes in C with the hash cached
        # on the object — measurable at journal-replay rates
        self.counts: Dict[str, int] = {et.value: 0 for et in EventType}
        self.grow_by_via: Dict[str, int] = {}
        self.exceptions_by_op: Dict[str, int] = {}
        self.wait = QuantileSketch(alpha)          # queue wait (START)
        self.requeue = QuantileSketch(alpha)       # PREEMPT -> restart
        self._busy: Dict[str, int] = {}            # jobid -> vertices
        self._preempted_at: Dict[str, float] = {}
        self.busy_now = 0
        self.busy_integral = 0.0                   # vertex-seconds
        self.first_t: Optional[float] = None
        self.last_t: Optional[float] = None
        self.n_events = 0
        self.cursor = 0             # next seq this aggregator expects
        self.resyncs = 0            # truncation gaps detected
        self.gap_events = 0         # events lost across those gaps

    # -- feeding ------------------------------------------------------- #
    def follow(self, source) -> Callable[[], None]:
        """Live mode: attach as a batch sink on ``source`` (an
        ``EventLog``, or anything with ``.events``) and start the
        folder thread, so the bounded-memory folds happen off the
        emitter's thread entirely.  Returns (and remembers) the detach
        function."""
        log = getattr(source, "events", source)
        if self._folder is None:
            self._folder_stop.clear()
            self._folder = threading.Thread(
                target=self._folder_loop, daemon=True,
                name=f"metrics-folder:{self.name}")
            self._folder.start()
        self._unsub = log.add_sink(self.sink)
        return self._unsub

    def sink(self, batch: List[JobEvent]) -> None:
        """``add_sink`` callback — the near-zero-cost emitter path.

        Lock-free on purpose: deque.append is atomic, the journal's
        single-drainer delivery serializes sink calls, and a racing
        reader zeroing ``_pend_n`` mid-increment can only leave it
        stale-high (an extra fold, never a lost one).  Once enough
        buffers, the folder thread (when running — i.e. attached via
        :meth:`follow`) is woken to fold concurrently; the inline fold
        is only the fallback memory bound for sink-without-follow
        wirings."""
        self._pend.append(batch)
        self._pend_n += len(batch)
        if self._pend_n >= self.FOLD_EVERY:
            if self._folder is not None:
                self._folder_wake.set()
            else:
                with self._lock:
                    self._fold_pending_locked()

    def _folder_loop(self) -> None:
        while True:
            self._folder_wake.wait()
            if self._folder_stop.is_set():
                return
            self._folder_wake.clear()
            with self._lock:
                self._fold_pending_locked()

    def observe(self, ev: JobEvent) -> None:
        """Fold a single event (remote subscription callbacks)."""
        with self._lock:
            self._fold(ev)

    def pump(self, source) -> int:
        """Cursor-replay / reconnect path: fold everything after our
        cursor from ``source.events_since``.  A cursor that fell behind
        the journal's retained window shows up as ``events[0].seq >
        cursor`` — counted in ``resyncs``/``gap_events`` and the
        per-job transient state is re-baselined rather than skewed."""
        fn = getattr(source, "events_since", None) or source.since
        events, nxt = fn(self.cursor)
        with self._lock:
            if events and events[0].seq > self.cursor:
                # pump semantics are "everything since my cursor", so a
                # higher first seq means the journal truncated past us
                # — even on the very first pump
                self._note_gap(events[0].seq)
            for ev in events:
                self._fold(ev)
            if self.cursor < nxt:
                self.cursor = nxt
        return len(events)

    def flush(self) -> None:
        """Fold everything buffered right now (blocks until caught
        up — if the folder thread is mid-fold this waits for it)."""
        with self._lock:
            self._fold_pending_locked()

    def detach(self) -> None:
        if self._unsub is not None:
            self._unsub()
            self._unsub = None
        if self._folder is not None:
            self._folder_stop.set()
            self._folder_wake.set()
            self._folder.join(timeout=5.0)
            self._folder = None

    # -- folding ------------------------------------------------------- #
    def _fold_pending_locked(self) -> None:
        # live emits deliver 1-event chunks, and _fold_many's
        # local-variable hoist costs about as much as folding one
        # event — so concatenate first and pay the hoist once per
        # flush instead of once per chunk
        if not self._pend:
            self._pend_n = 0
            return
        batch = self._pend.popleft()
        if self._pend:
            batch = list(batch)
            while self._pend:
                batch.extend(self._pend.popleft())
        self._fold_many(batch)
        self._pend_n = 0

    def _fold_many(self, events: List[JobEvent]) -> None:
        """Batch fold with the per-event bookkeeping hoisted into
        locals — same arithmetic as :meth:`_fold`, measurably cheaper
        at journal-replay rates (this loop IS the metrics plane's
        producer-side cost when folds trigger inline)."""
        cursor = self.cursor
        n_events = self.n_events
        first_t = self.first_t
        last_t = self.last_t
        counts = self.counts
        dispatch = self._DISPATCH
        for ev in events:
            seq = ev.seq
            if seq < cursor:
                continue            # replay overlap (reattach dedup)
            if seq > cursor and n_events > 0:
                # write back before the gap reset mutates shared state
                self.cursor = cursor
                self.n_events = n_events
                self._note_gap(seq)
                cursor = self.cursor
            cursor = seq + 1
            n_events += 1
            t = ev.t
            if first_t is None:
                first_t = t
            if last_t is not None and t > last_t:
                self.busy_integral += self.busy_now * (t - last_t)
            if last_t is None or t > last_t:
                last_t = t
            et = ev.type._value_
            counts[et] += 1
            h = dispatch.get(et)
            if h is not None:
                h(self, ev, t)
        self.cursor = cursor
        self.n_events = n_events
        self.first_t = first_t
        self.last_t = last_t

    def _note_gap(self, first_seq: int) -> None:
        """Mark derived metrics as resynced: count the lost events and
        re-baseline per-job transients (busy ledger, preempt
        timestamps) whose pairing events may be among the lost."""
        self.resyncs += 1
        self.gap_events += first_seq - self.cursor
        self.busy_now = 0
        self._busy.clear()
        self._preempted_at.clear()
        self.cursor = first_seq

    def _fold(self, ev: JobEvent) -> None:
        seq = ev.seq
        if seq < self.cursor:
            return                  # replay overlap (reattach dedup)
        if seq > self.cursor and self.n_events > 0:
            # the journal truncated between reads (a live join
            # mid-stream is not a gap — only a jump after we have
            # already folded events is)
            self._note_gap(seq)
        self.cursor = seq + 1
        self.n_events += 1
        t = ev.t
        if self.first_t is None:
            self.first_t = t
        if self.last_t is not None and t > self.last_t:
            self.busy_integral += self.busy_now * (t - self.last_t)
        if self.last_t is None or t > self.last_t:
            self.last_t = t
        et = ev.type._value_
        self.counts[et] += 1
        # one dict lookup instead of a type-comparison chain: most
        # events (SUBMIT et al.) have no per-type fold work at all
        h = self._DISPATCH.get(et)
        if h is not None:
            h(self, ev, t)

    def _on_start(self, ev: JobEvent, t: float) -> None:
        w = ev.detail.get("wait")
        if w is not None:
            self.wait.add(float(w))
        p = self._preempted_at.pop(ev.jobid, None)
        if p is not None:
            self.requeue.add(max(t - p, 0.0))

    def _on_alloc(self, ev: JobEvent, t: float) -> None:
        n = int(ev.detail.get("n_paths", 0))
        prev = self._busy.get(ev.jobid, 0)
        self._busy[ev.jobid] = n
        self.busy_now += n - prev

    def _on_grow(self, ev: JobEvent, t: float) -> None:
        detail = ev.detail
        via = detail.get("via", "?")
        self.grow_by_via[via] = self.grow_by_via.get(via, 0) + 1
        if detail.get("malleable"):
            # queue-level malleable grow: the job's allocation grew
            # mid-run (engine-level GROW events are keyed by
            # allocation and already reflected in ALLOC deltas)
            n = int(detail.get("n_paths", 0))
            self._busy[ev.jobid] = self._busy.get(ev.jobid, 0) + n
            self.busy_now += n

    def _on_shrink(self, ev: JobEvent, t: float) -> None:
        n = int(ev.detail.get("n_paths", 0))
        prev = self._busy.get(ev.jobid, 0)
        take = min(prev, n)
        self._busy[ev.jobid] = prev - take
        self.busy_now -= take

    def _on_preempt(self, ev: JobEvent, t: float) -> None:
        prev = self._busy.pop(ev.jobid, 0)
        self.busy_now -= prev
        self._preempted_at[ev.jobid] = t

    def _on_free(self, ev: JobEvent, t: float) -> None:
        prev = self._busy.pop(ev.jobid, 0)
        self.busy_now -= prev
        self._preempted_at.pop(ev.jobid, None)

    def _on_exception(self, ev: JobEvent, t: float) -> None:
        op = ev.detail.get("op", "?")
        self.exceptions_by_op[op] = self.exceptions_by_op.get(op, 0) + 1

    _DISPATCH = {
        EventType.START.value: _on_start,
        EventType.ALLOC.value: _on_alloc,
        EventType.GROW.value: _on_grow,
        EventType.SHRINK.value: _on_shrink,
        EventType.PREEMPT.value: _on_preempt,
        EventType.FREE.value: _on_free,
        EventType.EXCEPTION.value: _on_exception,
    }

    # -- reading ------------------------------------------------------- #
    def derived(self) -> Dict:
        """Event-derived metrics only — the replay==live surface."""
        with self._lock:
            self._fold_pending_locked()
            elapsed = (self.last_t - self.first_t) \
                if self.first_t is not None and self.last_t is not None \
                else 0.0
            return {
                "name": self.name,
                "n_events": self.n_events,
                "counts": dict(self.counts),
                "grow_by_via": dict(self.grow_by_via),
                "exceptions_by_op": dict(self.exceptions_by_op),
                "wait": self.wait.summary(),
                "requeue": self.requeue.summary(),
                "preemptions": self.counts[EventType.PREEMPT.value],
                "busy_now": self.busy_now,
                "busy_vertex_seconds": self.busy_integral,
                "burn": self.busy_integral / max(self.weight, 1e-9),
                "elapsed": elapsed,
                "churn_per_s":
                    (self.counts[EventType.PREEMPT.value]
                     + self.counts[EventType.REVOKE.value]) / elapsed
                    if elapsed > 0 else 0.0,
                "resyncs": self.resyncs,
                "gap_events": self.gap_events,
            }

    def gauges(self, graph=None, scheduler=None) -> Dict:
        """Sampled (non-event-derived) gauges: utilization and
        fragmentation from a graph's pruning aggregates."""
        if graph is None and scheduler is not None:
            graph = scheduler.graph
        out: Dict = {}
        if scheduler is not None:
            u = scheduler.usage()
            cap = max(u.get("capacity", 0), 1)
            out["utilization"] = u.get("allocated", 0) / cap
            out["capacity"] = u.get("capacity", 0)
            out["allocated"] = u.get("allocated", 0)
        if graph is not None:
            out["fragmentation"] = fragmentation(graph)
        return out

    def consume_spans(self, collector: SpanCollector,
                      into: Optional[Dict[str, QuantileSketch]] = None
                      ) -> Dict[str, Dict]:
        """Drain a :class:`SpanCollector` into latency sketches keyed
        ``<name>`` (total duration) and ``<name>.<stage>``; returns
        their summaries.  Pass ``into`` to accumulate across drains."""
        sk = into if into is not None else {}
        for span in collector.drain():
            name = span.get("name", "?")
            s = sk.get(name)
            if s is None:
                s = sk[name] = QuantileSketch(self.wait.alpha)
            s.add(float(span.get("dur", 0.0)))
            for stage, dur in span.get("stages", {}).items():
                key = f"{name}.{stage}"
                s2 = sk.get(key)
                if s2 is None:
                    s2 = sk[key] = QuantileSketch(self.wait.alpha)
                s2.add(float(dur))
        return {k: v.summary() for k, v in sk.items()}

    def merge(self, other: "MetricsAggregator") -> None:
        """Fleet rollup: fold ``other``'s derived state into this one
        (sketches merge bucket-wise; integrals and counters add)."""
        with other._lock:
            other._fold_pending_locked()
        with self._lock:
            self._fold_pending_locked()
            for k, v in other.counts.items():
                self.counts[k] = self.counts.get(k, 0) + v
            for k, v in other.grow_by_via.items():
                self.grow_by_via[k] = self.grow_by_via.get(k, 0) + v
            for k, v in other.exceptions_by_op.items():
                self.exceptions_by_op[k] = \
                    self.exceptions_by_op.get(k, 0) + v
            self.wait.merge(other.wait)
            self.requeue.merge(other.requeue)
            self.busy_now += other.busy_now
            self.busy_integral += other.busy_integral
            self.n_events += other.n_events
            self.resyncs += other.resyncs
            self.gap_events += other.gap_events
            if other.first_t is not None:
                self.first_t = other.first_t if self.first_t is None \
                    else min(self.first_t, other.first_t)
            if other.last_t is not None:
                self.last_t = other.last_t if self.last_t is None \
                    else max(self.last_t, other.last_t)
