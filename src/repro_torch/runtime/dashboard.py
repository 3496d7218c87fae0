"""Cluster-health consumer: the fleet view over the metrics plane.

:class:`ClusterHealth` is the thin consumer the observability plane
feeds: it attaches one live
:class:`~repro_torch.core.metrics.MetricsAggregator` per tenant instance (or
one for a single :class:`~repro_torch.core.api.Instance`), hangs
:class:`~repro_torch.core.metrics.SpanCollector`\\ s on the schedulers so the
MATCHGROW engine's per-stage spans land somewhere, and serves the
derived view read-only:

* ``status``  — compact fleet snapshot (utilization, fragmentation,
  wait percentiles, churn, lease debt),
* ``metrics`` — the full per-tenant + rollup dump,
* ``tenants`` — per-tenant weight / usage / burn / lease rows,
* ``metrics_stream`` — a pushed snapshot stream: each
  :meth:`publish` encodes the snapshot *once* and fans the same bytes
  out to every subscriber (encode once, fan out).

All four are registered on the target's ``MethodRegistry``, so a
:class:`~repro_torch.core.api.RemoteInstance` over ``MuxTransport`` sees the
identical fleet view (``remote.status()``), locally or across a
socket.  Everything served is derived from the event stream, the lease
ledger, and sampled graph gauges — no queue internals are touched.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.lockwitness import named_lock
from ..core.metrics import MetricsAggregator, QuantileSketch, SpanCollector
from ..core.rpc import pack_json, unpack_json

__all__ = ["ClusterHealth", "follow_metrics"]


class _SnapshotStream:
    """``metrics_stream`` verb: encode-once snapshot fan-out.

    Subscribers collect under the stream's own lock; the pushes happen
    outside it (one bad connection must not wedge the publisher, and
    no transport call runs under a non-API lock — R2)."""

    def __init__(self):
        self._lock = named_lock("metricsstream")
        self._subs: List[Dict] = []
        self.published = 0

    def open(self, payload: bytes, push: Callable[[int, bytes], None]
             ) -> Tuple[bytes, Callable[[], None]]:
        entry = {"push": push, "open": True}
        with self._lock:
            self._subs.append(entry)

        def close() -> None:
            with self._lock:
                entry["open"] = False
                if entry in self._subs:
                    self._subs.remove(entry)
        return pack_json({"ok": True}), close

    def publish(self, snapshot: Dict) -> int:
        with self._lock:
            subs = list(self._subs)
        if not subs:
            return 0
        enc = pack_json(snapshot)       # encoded once for all
        n = 0
        for s in subs:
            if not s["open"]:
                continue
            try:
                s["push"](1, enc)
                n += 1
            except Exception:
                pass
        self.published += 1
        return n


def follow_metrics(transport, cb: Callable[[Dict], None]):
    """Client side of ``metrics_stream``: subscribe on a MuxTransport;
    ``cb`` receives each pushed snapshot as a dict.  Returns the
    subscription (``.close()`` to detach)."""
    def on_batch(count: int, payload: Optional[bytes]) -> None:
        if payload:
            cb(unpack_json(payload))
    return transport.subscribe(pack_json({}), on_batch=on_batch,
                               method="metrics_stream")


class ClusterHealth:
    """Fleet observability over a ``MultiTenantTree`` or a single
    ``Instance``.

    Aggregators follow each tenant's event log live (the near-zero-cost
    sink path); reading any verb folds what has buffered.  The lease
    ledger (when the target has a fair-share arbiter) is surfaced as a
    first-class metric: per-donor debt, per-borrower credit, and the
    return counters — the ``status`` verb is where "lease debt returns
    to zero" becomes observable."""

    def __init__(self, target, *, register: bool = True,
                 spans: bool = True, alpha: float = 0.01):
        self._tree = target if hasattr(target, "instances") else None
        if self._tree is not None:
            self.clock = self._tree.clock
            weights = self._tree.root.arbiter.weights
            self.ledger = self._tree.root.arbiter.ledger
            self.instances = dict(self._tree.instances)
            self._reg_sched = self._tree.root
            self._span_hosts = [self._tree.root] + \
                [inst.scheduler for inst in self.instances.values()]
        else:
            self.clock = target.clock
            arb = getattr(target.scheduler, "arbiter", None)
            weights = getattr(arb, "weights", {}) if arb else {}
            self.ledger = getattr(arb, "ledger", None) if arb else None
            self.instances = {target.scheduler.name: target}
            self._reg_sched = target.scheduler
            self._span_hosts = [target.scheduler]
        self.aggs: Dict[str, MetricsAggregator] = {}
        for name, inst in self.instances.items():
            agg = MetricsAggregator(name, alpha=alpha,
                                    weight=weights.get(name, 1.0))
            agg.follow(inst.events)
            self.aggs[name] = agg
        self.collectors: Dict[str, SpanCollector] = {}
        if spans:
            for sched in self._span_hosts:
                col = SpanCollector()
                sched.span_collector = col
                self.collectors[sched.name] = col
        # span latency sketches accumulate across drains (keyed
        # "<name>" and "<name>.<stage>")
        self._span_sketches: Dict[str, QuantileSketch] = {}
        self._alpha = alpha
        self.stream = _SnapshotStream()
        if register:
            reg = self._reg_sched.register_method
            reg("status", self._rpc_status)
            reg("metrics", self._rpc_metrics)
            reg("tenants", self._rpc_tenants)
            self._reg_sched.register_stream("metrics_stream",
                                            self.stream.open)

    # ------------------------------------------------------------------ #
    # derived views
    # ------------------------------------------------------------------ #
    def _span_summary(self) -> Dict[str, Dict]:
        out: Dict[str, Dict] = {}
        drainer = MetricsAggregator("spans", alpha=self._alpha)
        for col in self.collectors.values():
            out = drainer.consume_spans(col, into=self._span_sketches)
        if not self.collectors:
            out = {k: v.summary()
                   for k, v in self._span_sketches.items()}
        return out

    def status(self) -> Dict:
        """Compact fleet snapshot — the terminal-dashboard row set."""
        rows: Dict[str, Dict] = {}
        alloc_sum = cap_sum = 0
        fleet = MetricsAggregator("fleet", alpha=self._alpha)
        debt = self.ledger.debt() if self.ledger is not None else {}
        credit = self.ledger.credit() if self.ledger is not None else {}
        for name, agg in self.aggs.items():
            d = agg.derived()
            sched = self.instances[name].scheduler
            u = sched.usage()
            alloc_sum += u["allocated"]
            cap_sum += u["capacity"]
            rows[name] = {
                "utilization": u["allocated"] / max(u["capacity"], 1),
                "wait_p50": d["wait"]["p50"],
                "wait_p99": d["wait"]["p99"],
                "busy_now": d["busy_now"],
                "preemptions": d["preemptions"],
                "churn_per_s": d["churn_per_s"],
                "burn": d["burn"],
                "resyncs": d["resyncs"],
                "lease_debt": debt.get(name, 0),
                "lease_credit": credit.get(name, 0),
            }
            fleet.merge(agg)
        fd = fleet.derived()
        out = {
            "t": self.clock.now(),
            "fleet": {
                "utilization": alloc_sum / max(cap_sum, 1),
                "capacity": cap_sum,
                "allocated": alloc_sum,
                "wait": fd["wait"],
                "requeue": fd["requeue"],
                "preemptions": fd["preemptions"],
                "grow_by_via": fd["grow_by_via"],
                "churn_per_s": fd["churn_per_s"],
                "resyncs": fd["resyncs"],
                "gap_events": fd["gap_events"],
                "n_events": fd["n_events"],
            },
            "tenants": rows,
        }
        if self.ledger is not None:
            out["lease"] = self.ledger.summary()
        return out

    def metrics(self) -> Dict:
        """The full dump: per-tenant derived + gauges, span latency
        histograms, lease ledger."""
        per = {}
        for name, agg in self.aggs.items():
            sched = self.instances[name].scheduler
            per[name] = {"derived": agg.derived(),
                         "gauges": agg.gauges(scheduler=sched)}
        out = {"t": self.clock.now(), "instances": per,
               "spans": self._span_summary()}
        if self.ledger is not None:
            out["lease"] = self.ledger.summary()
        return out

    def tenants(self) -> Dict:
        rows = {}
        debt = self.ledger.debt() if self.ledger is not None else {}
        credit = self.ledger.credit() if self.ledger is not None else {}
        for name, agg in self.aggs.items():
            d = agg.derived()
            u = self.instances[name].scheduler.usage()
            rows[name] = {
                "weight": agg.weight,
                "allocated": u["allocated"],
                "capacity": u["capacity"],
                "busy_vertex_seconds": d["busy_vertex_seconds"],
                "burn": d["burn"],
                "preemptions": d["preemptions"],
                "lease_debt": debt.get(name, 0),
                "lease_credit": credit.get(name, 0),
            }
        return {"tenants": rows}

    # ------------------------------------------------------------------ #
    def publish(self) -> Dict:
        """Push one ``status`` snapshot to every ``metrics_stream``
        subscriber (encoded once) and return it."""
        snap = self.status()
        self.stream.publish(snap)
        return snap

    def render(self, status: Optional[Dict] = None) -> str:
        """Terminal table for the cluster-health example."""
        s = status or self.status()
        lines = [f"fleet t={s['t']:.2f}  util="
                 f"{s['fleet']['utilization']:.2%}  "
                 f"preempts={s['fleet']['preemptions']}  "
                 f"events={s['fleet']['n_events']}"]
        hdr = (f"{'tenant':<10} {'util':>7} {'wait_p99':>9} "
               f"{'busy':>6} {'preempt':>8} {'debt':>5} {'credit':>7}")
        lines.append(hdr)
        lines.append("-" * len(hdr))
        for name, r in sorted(s["tenants"].items()):
            p99 = r["wait_p99"]
            lines.append(
                f"{name:<10} {r['utilization']:>7.2%} "
                f"{(f'{p99:.3f}' if p99 is not None else '-'):>9} "
                f"{r['busy_now']:>6} {r['preemptions']:>8} "
                f"{r['lease_debt']:>5} {r['lease_credit']:>7}")
        if "lease" in s:
            le = s["lease"]
            lines.append(f"leases: active={le['active']} "
                         f"outstanding={le['outstanding_vertices']} "
                         f"recorded={le['recorded']} "
                         f"returned={le['returned']}")
        return "\n".join(lines)

    # ------------------------------------------------------------------ #
    # RPC wrappers (read-only verbs on the MethodRegistry)
    # ------------------------------------------------------------------ #
    def _rpc_status(self, payload: bytes) -> bytes:
        return pack_json(self.status())

    def _rpc_metrics(self, payload: bytes) -> bytes:
        return pack_json(self.metrics())

    def _rpc_tenants(self, payload: bytes) -> bytes:
        return pack_json(self.tenants())

    def close(self) -> None:
        for agg in self.aggs.values():
            agg.detach()
        for sched in self._span_hosts:
            sched.span_collector = None
