"""The unified MATCHGROW engine (paper Algorithm 1).

One implementation of the MG pipeline shared by the caller side
(``SchedulerInstance.match_grow``) and the RPC-server side (the
``match_grow`` method a parent serves to its children):

    local match  ->  sibling reclaim  ->  forward up  ->  external
                 ->  splice + update + allocation bookkeeping

Every stage returns through a single ``GrowResult`` type — there is no
more ``Optional[ResourceGraph]``-annotated-but-sometimes-something-else
API.  A failed grow returns a *falsy* GrowResult that still carries the
MGTiming record, so benchmarks see failures too.

Sibling routing (paper Fig. 2 multi-user topology): when an instance
cannot satisfy a child's request locally, it first asks the requester's
*sibling* subtrees to give back free resources (the ``reclaim`` RPC)
before escalating to its own parent or the External API.  The donating
sibling removes the matched subgraph from its graph (a bottom-up
subtractive transform on the donor), the parent reassigns the vertices
to the requesting job, and the subgraph travels down to the requester in
JGF exactly like a parent-matched subgraph.

Preemptive reclaim (the ``revoke`` RPC): when free-resource reclaim
fails and the grow carries ``preempt=True``, the parent may ask sibling
subtrees to *evict* lower-priority preemptible allocations.  The donor
releases each victim bottom-up (its spliced-in vertices leave the donor
and propagate up exactly like a timed release), notifies its
``revoke_listeners`` so the owning job queue can requeue the victim,
and then donates the freed subgraph like an ordinary reclaim.
``GrowResult.victims`` carries the evicted jobids back to the caller —
embedded in the JGF payload under a top-level ``"victims"`` key, so
intermediate levels forward it verbatim.  A ``FairShareArbiter``
attached to the parent (``host.arbiter``) gates which tenant may
preempt which (weighted fair share over the ``usage`` RPC).

The JGF payload is encoded exactly once, at the level that matched, and
forwarded verbatim by intermediate levels (§Perf control-plane
optimization); encoding happens *outside* the measured t_match /
t_comms / t_add_upd components, matching the paper's accounting.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .events import EventType
from .graph import CONTAINMENT
from .jobspec import Jobspec
from .match import Matcher
from .rpc import pack_json
from .transform import (add_subgraph, remove_subgraph, splice_jgf,
                        update_metadata)


def _jgf_paths(jgf: Dict) -> List[str]:
    """All vertex paths named by a JGF payload."""
    out = []
    for node in jgf["graph"]["nodes"]:
        meta = node["metadata"]
        p = meta["paths"]
        out.append(p[CONTAINMENT] if isinstance(p, dict) else p)
    return out


@dataclass
class MGTiming:
    """Per-level component timings for one MATCHGROW (paper Section 6)."""

    level: str
    jobid: str
    request_size: int          # |V|+|E| of the requested subgraph
    matched_size: int = 0      # |V|+|E| of the matched subgraph
    t_match: float = 0.0
    t_comms: float = 0.0
    t_add_upd: float = 0.0
    matched_locally: bool = False
    external: bool = False
    via_sibling: Optional[str] = None   # donor sibling name, if routed
    ancestors_updated: int = 0
    n_victims: int = 0                  # allocations evicted by this grow

    @property
    def total(self) -> float:
        return self.t_match + self.t_comms + self.t_add_upd


@dataclass
class Allocation:
    jobid: str
    paths: List[str] = field(default_factory=list)
    # scheduling-policy metadata, set by the owning JobQueue: a revoke
    # may only evict allocations marked preemptible, and only to serve
    # a strictly higher-priority grow.  Raw match_allocate allocations
    # default to non-preemptible, so delegation markers and manually
    # placed jobs are never stolen.
    priority: int = 0
    preemptible: bool = False

    @property
    def n_vertices(self) -> int:
        return len(self.paths)


class GrowResult:
    """The one return type of MATCHGROW.

    Truthiness == success.  ``via`` records where the subgraph came
    from: "local", "sibling:<name>", "parent", "external", or None on
    failure.  ``jgf`` holds the encoded subgraph when the grow was
    served over RPC (encoded once, forwarded verbatim).  ``victims``
    lists the jobids whose allocations were revoked to satisfy a
    preemptive grow, so callers can account for displaced work.
    """

    __slots__ = ("ok", "new_paths", "size", "via", "timing", "jgf",
                 "victims")

    def __init__(self, ok: bool, new_paths: Optional[List[str]] = None,
                 size: int = 0, via: Optional[str] = None,
                 timing: Optional[MGTiming] = None,
                 jgf: Optional[bytes] = None,
                 victims: Optional[List[str]] = None):
        self.ok = ok
        self.new_paths = new_paths or []
        self.size = size
        self.via = via
        self.timing = timing
        self.jgf = jgf
        self.victims = victims or []

    def __bool__(self) -> bool:
        return self.ok

    def paths(self) -> List[str]:
        return list(self.new_paths)

    @property
    def matched_locally(self) -> bool:
        return self.via == "local"

    @property
    def external(self) -> bool:
        return self.via == "external"

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"GrowResult(ok={self.ok}, via={self.via!r}, "
                f"size={self.size}, n_paths={len(self.new_paths)}, "
                f"victims={self.victims})")


class GrowEngine:
    """The shared MG algorithm, bound to one scheduler instance.

    The host must expose: ``name``, ``graph``, ``parent`` (Transport or
    None), ``children`` (name -> Transport), ``external``,
    ``external_at_any_level``, ``allocations``, ``timings``,
    ``external_paths``, ``spliced_paths``, ``lock`` (an RLock guarding
    local mutations — the engine acquires it per stage, never across a
    transport call), and optionally ``eventlog`` (typed GROW/REVOKE
    events).  ``SchedulerInstance`` is the only host today; the
    indirection is what lets the caller and RPC-server sides share one
    implementation.
    """

    def __init__(self, host) -> None:
        self.host = host

    # ------------------------------------------------------------------ #
    def grow(self, jobspec: Jobspec, jobid: str, *,
             requester: Optional[str] = None,
             encode: bool = False,
             priority: int = 0,
             preempt: bool = False) -> GrowResult:
        """Run one MATCHGROW at this level.

        ``requester`` names the child the request came from (excluded
        from sibling routing); ``encode=True`` additionally produces the
        JGF bytes an RPC response needs (the caller side skips this).
        ``preempt=True`` arms the revoke path: after free-resource
        reclaim fails, sibling subtrees may evict preemptible
        allocations of priority strictly below ``priority``.

        When a span collector is attached to the host
        (``host.span_collector``), each grow additionally records one
        structured ``match_grow`` span with per-stage wall times
        (local_match / reclaim / revoke / forward / external / splice —
        see docs/OBSERVABILITY.md).  Detached, the only cost is one
        attribute read and ``None`` check per grow; the record call
        happens *after* every per-stage lock is released (R2/R3).
        """
        col = getattr(self.host, "span_collector", None)
        if col is None:
            return self._grow(jobspec, jobid, requester=requester,
                              encode=encode, priority=priority,
                              preempt=preempt, stages=None)
        stages: Dict[str, float] = {}
        t0 = time.perf_counter()
        res = self._grow(jobspec, jobid, requester=requester,
                         encode=encode, priority=priority,
                         preempt=preempt, stages=stages)
        dur = time.perf_counter() - t0
        rec = res.timing
        if rec is not None:
            stages["local_match"] = rec.t_match
            if rec.t_add_upd:
                stages["splice"] = rec.t_add_upd
        col.record({"name": "match_grow", "level": self.host.name,
                    "jobid": jobid, "ok": bool(res), "via": res.via,
                    "dur": dur, "stages": stages})
        return res

    def _grow(self, jobspec: Jobspec, jobid: str, *,
              requester: Optional[str], encode: bool, priority: int,
              preempt: bool,
              stages: Optional[Dict[str, float]]) -> GrowResult:
        host = self.host
        rec = MGTiming(level=host.name, jobid=jobid,
                       request_size=jobspec.graph_size())

        # 1. local match (MATCHALLOCATE with grow semantics) — the lock
        # spans match + allocate so two concurrent MGs cannot claim the
        # same free vertices (the lock is per-stage, never held across
        # a transport call; see SchedulerInstance.lock)
        t0 = time.perf_counter()
        with host.lock:
            matcher = Matcher(host.graph)
            paths = matcher.match(jobspec)
            rec.t_match = time.perf_counter() - t0
            if paths is not None:
                host.graph.set_allocated(paths, jobid)
                self._book(jobid, paths)
                if encode:
                    sub = host.graph.extract(paths)
                    size = sub.size
                else:
                    # caller-side grow: nobody consumes the subgraph, so
                    # don't materialize it — just its size accounting
                    size = host.graph.extent_size(paths)
        if paths is not None:
            rec.matched_locally = True
            rec.matched_size = size
            host.timings.append(rec)
            self._emit_grow(jobid, "local", size, n_paths=len(paths))
            return GrowResult(
                True, new_paths=list(paths), size=size, via="local",
                timing=rec,
                jgf=sub.to_jgf_bytes() if encode else None)

        # 2. sibling routing: reclaim from other child subtrees first
        t1 = time.perf_counter() if stages is not None else 0.0
        res = self._reclaim_from_children(jobspec, jobid, requester, rec,
                                          encode)
        if stages is not None:
            stages["reclaim"] = time.perf_counter() - t1
        if res is not None:
            return res

        # 2b. preemptive reclaim: evict lower-priority work from
        # sibling subtrees (gated by the fair-share arbiter, if any)
        if preempt:
            t1 = time.perf_counter() if stages is not None else 0.0
            res = self._reclaim_from_children(jobspec, jobid, requester,
                                              rec, encode, preempt=True,
                                              priority=priority)
            if stages is not None:
                stages["revoke"] = time.perf_counter() - t1
            if res is not None:
                return res

        # 3. forward up the hierarchy (preempt semantics travel along)
        t1 = time.perf_counter() if stages is not None else 0.0
        res = self._forward_to_parent(jobspec, jobid, rec,
                                      priority=priority, preempt=preempt)
        if stages is not None and host.parent is not None:
            stages["forward"] = time.perf_counter() - t1
        if res is not None:
            return res

        # 4. external fallback (top level, or any level when enabled)
        t1 = time.perf_counter() if stages is not None else 0.0
        res = self._provision_external(jobspec, jobid, rec, encode)
        if stages is not None and host.external is not None:
            stages["external"] = time.perf_counter() - t1
        if res is not None:
            return res

        host.timings.append(rec)
        return GrowResult(False, timing=rec)

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #
    def _book(self, jobid: str, paths: List[str]) -> Allocation:
        alloc = self.host.allocations.setdefault(jobid, Allocation(jobid))
        alloc.paths.extend(paths)
        return alloc

    def _emit_grow(self, jobid: str, via: str, size: int,
                   victims: Optional[List[str]] = None,
                   n_paths: int = 0) -> None:
        """Typed GROW event into the host's event log, if one is wired
        (grow/shrink are first-class observable operations).
        ``n_paths`` is the vertex count the allocation gained — the
        detail metrics consumers fold into busy-capacity ledgers."""
        log = getattr(self.host, "eventlog", None)
        if log is not None:
            log.emit(EventType.GROW, jobid, via=via, size=size,
                     n_paths=n_paths, victims=list(victims or ()))

    def _record_lease(self, donor: str, jobid: str,
                      requester: Optional[str], paths: List[str],
                      preempt: bool, n_victims: int) -> None:
        """Sibling donations are *leases*: when a fair-share arbiter
        (and thus its ledger) sits on this host, record (donor,
        borrower, vertices, t) so the donated-capacity debt is
        observable and the return-home policy can settle it.  Called
        outside ``host.lock`` — the ledger takes only its own lock and
        never calls out (R2/R3)."""
        arb = getattr(self.host, "arbiter", None)
        ledger = getattr(arb, "ledger", None) if arb is not None else None
        if ledger is None:
            return
        log = getattr(self.host, "eventlog", None)
        t = None
        if log is not None and log.clock is not None:
            t = log.clock.now()
        ledger.record(donor=donor, borrower=requester or self.host.name,
                      jobid=jobid, paths=paths, t=t, preempt=preempt,
                      n_victims=n_victims)

    def _reclaim_from_children(self, jobspec: Jobspec, jobid: str,
                               requester: Optional[str], rec: MGTiming,
                               encode: bool, preempt: bool = False,
                               priority: int = 0) -> Optional[GrowResult]:
        host = self.host
        arbiter = getattr(host, "arbiter", None) if preempt else None
        usage: Optional[Dict[str, Dict]] = None
        if arbiter is not None:
            usage = self._tenant_usage(host.children)
        for name, transport in host.children.items():
            if name == requester:
                continue
            if arbiter is not None and requester is not None and \
                    not arbiter.may_preempt(requester, name, usage):
                continue
            t0 = time.perf_counter()
            if preempt:
                resp = transport.call("revoke", pack_json(
                    {"jobspec": jobspec.to_dict(), "jobid": jobid,
                     "priority": priority}))
            else:
                resp = transport.call("reclaim", pack_json(
                    {"jobspec": jobspec.to_dict(), "jobid": jobid}))
            rec.t_comms += time.perf_counter() - t0
            if not resp:
                continue
            data = json.loads(resp)
            donated: List[str] = data["paths"]
            jgf = data["jgf"]
            victims: List[str] = data.get("victims", [])
            # Splice is the identity for vertices this level already
            # holds (the donor's graph is a subgraph of ours); anything
            # genuinely new (e.g. the donor's own external resources)
            # is added like a parent-matched subgraph.
            t0 = time.perf_counter()
            with host.lock:
                tres = splice_jgf(host.graph, jgf)
                update_metadata(host.graph, tres, jobid=jobid)
                host.graph.reassign(donated, jobid)
                # vertices the donor held that we did not (e.g. its own
                # external resources) only live here for this job
                host.spliced_paths.update(tres.new_paths)
                self._book(jobid, donated)
            rec.t_add_upd += time.perf_counter() - t0
            rec.matched_size = len(jgf["graph"]["nodes"]) + \
                len(jgf["graph"].get("edges", []))
            rec.ancestors_updated = tres.ancestors_updated
            rec.via_sibling = name
            rec.n_victims = len(victims)
            host.timings.append(rec)
            self._emit_grow(jobid, f"sibling:{name}", rec.matched_size,
                            victims, n_paths=len(donated))
            self._record_lease(name, jobid, requester, list(donated),
                               preempt, len(victims))
            if victims:
                # ride inside the JGF payload so intermediate levels
                # forward it verbatim; splice_jgf only reads "graph"
                jgf["victims"] = victims
            return GrowResult(
                True, new_paths=donated, size=rec.matched_size,
                via=f"sibling:{name}", timing=rec,
                jgf=json.dumps(jgf, separators=(",", ":")).encode()
                if encode else None,
                victims=victims)
        return None

    def _tenant_usage(self, children: Dict) -> Dict[str, Dict]:
        """Per-child usage snapshot for fair-share arbitration (one
        ``usage`` RPC per child subtree)."""
        out: Dict[str, Dict] = {}
        for name, transport in children.items():
            try:
                resp = transport.call("usage", b"")
            except Exception:
                continue
            if resp:
                out[name] = json.loads(resp)
        return out

    @staticmethod
    def _aliased(data: Dict, tres, jobid: str) -> bool:
        """True when the payload's *matched* vertices (the ones the
        ancestor allocated to ``jobid``; the free ancestor spine does
        not count) were not all new to this graph — or when nothing at
        all was new."""
        if not tres.new_paths:
            return True
        new = set(tres.new_paths)
        for node in data["graph"]["nodes"]:
            meta = node["metadata"]
            if jobid in meta.get("allocations", ()):
                p = meta["paths"]
                path = p[CONTAINMENT] if isinstance(p, dict) else p
                if path not in new:
                    return True
        return False

    def _forward_to_parent(self, jobspec: Jobspec, jobid: str,
                           rec: MGTiming, priority: int = 0,
                           preempt: bool = False) -> Optional[GrowResult]:
        host = self.host
        if host.parent is None:
            return None
        req = {"jobspec": jobspec.to_dict(), "jobid": jobid,
               "from": host.name}
        if preempt:
            req["preempt"] = True
            req["priority"] = priority
        t0 = time.perf_counter()
        resp = host.parent.call("match_grow", pack_json(req))
        rec.t_comms += time.perf_counter() - t0
        if not resp:
            return None
        # fused deserialize + AddSubgraph (RunGrow add=True)
        t0 = time.perf_counter()
        data = json.loads(resp)
        victims: List[str] = data.get("victims", [])
        rec.n_victims = len(victims)
        with host.lock:
            tres = splice_jgf(host.graph, data)
            aliased = self._aliased(data, tres, jobid)
            if aliased:
                # vertices the ancestor matched (and allocated to the
                # job) already exist here: the hierarchy's path
                # namespaces alias (subgraph-inclusion discipline broken
                # upstream).  Booking this grow would double-use local
                # vertices and strand the ancestor's allocation on
                # release — undo and fail instead.
                rec.t_add_upd = time.perf_counter() - t0
                if tres.new_paths:      # roll the partial splice back
                    update_metadata(host.graph, tres)
                    remove_subgraph(host.graph, list(tres.new_paths))
            else:
                update_metadata(host.graph, tres, jobid=jobid)
                rec.t_add_upd = time.perf_counter() - t0
                host.spliced_paths.update(tres.new_paths)
                self._book(jobid, tres.new_paths)
        if aliased:
            host.parent.call("release", pack_json(
                {"jobid": jobid, "paths": _jgf_paths(data)}))
            host.timings.append(rec)
            return GrowResult(False, timing=rec)
        rec.matched_size = tres.total_size
        rec.ancestors_updated = tres.ancestors_updated
        host.timings.append(rec)
        self._emit_grow(jobid, "parent", tres.total_size, victims,
                        n_paths=len(tres.new_paths))
        return GrowResult(
            True, new_paths=list(tres.new_paths), size=tres.total_size,
            via="parent", timing=rec, jgf=bytes(resp),  # verbatim
            victims=victims)

    def _provision_external(self, jobspec: Jobspec, jobid: str,
                            rec: MGTiming,
                            encode: bool) -> Optional[GrowResult]:
        host = self.host
        if host.external is None or (
                host.parent is not None and not host.external_at_any_level):
            return None
        root = host.graph.roots[0] if host.graph.roots else "/external"
        result = host.external.provision(jobspec, root)
        if result is None:
            return None
        rec.external = True
        t0 = time.perf_counter()
        with host.lock:
            tres = add_subgraph(host.graph, result.subgraph)
            update_metadata(host.graph, tres, jobid=jobid)
            self._book(jobid, tres.new_paths)
            host.external_paths.update(tres.new_paths)
        rec.t_add_upd = time.perf_counter() - t0
        rec.matched_size = result.subgraph.size
        rec.ancestors_updated = tres.ancestors_updated
        host.timings.append(rec)
        self._emit_grow(jobid, "external", result.subgraph.size,
                        n_paths=len(tres.new_paths))
        return GrowResult(
            True, new_paths=list(tres.new_paths), size=result.subgraph.size,
            via="external", timing=rec,
            jgf=result.subgraph.to_jgf_bytes() if encode else None)

    # ------------------------------------------------------------------ #
    # donor side of sibling routing
    # ------------------------------------------------------------------ #
    def reclaim(self, jobspec: Jobspec) -> Optional[Dict]:
        """Give back free local resources matching ``jobspec``.

        Local-only (never recurses — the *parent* owns escalation), and
        subtractive on the donor: the matched subgraph leaves this
        instance's graph bottom-up, preserving subgraph inclusion with
        the sibling that receives it.  Returns ``{"paths", "jgf"}`` or
        None when nothing matches.
        """
        host = self.host
        with host.lock:
            matcher = Matcher(host.graph)
            paths = matcher.match(jobspec)
            if paths is None:
                return None
            sub = host.graph.extract(paths)  # extract while still free
            remove_subgraph(host.graph, list(paths))
            host.spliced_paths.difference_update(paths)
            host.external_paths.difference_update(paths)
            return {"paths": list(paths), "jgf": sub.to_jgf()}

    def revoke(self, jobspec: Jobspec, priority: int) -> Optional[Dict]:
        """Preemptive variant of :meth:`reclaim`.

        If free resources alone cannot cover ``jobspec``, evict local
        allocations that are ``preemptible`` and of priority strictly
        below ``priority`` — lowest priority first, newest first within
        a priority — until the match succeeds.  Each victim is released
        bottom-up through ``host.release`` (its spliced-in and external
        vertices leave this graph and the release propagates to the
        parent, exactly like a timed release), and ``host``'s
        ``revoke_listeners`` are notified so the owning job queue can
        requeue the victim.  Returns ``{"paths", "jgf", "victims"}`` or
        None when even eviction cannot possibly help (checked against
        the pruning aggregates before anything is evicted).
        """
        host = self.host

        def donatable(alloc: Allocation) -> Dict[str, int]:
            # vertices that would return to THIS graph's free pool on
            # eviction: spliced-in and external copies leave the graph
            # instead (they free at the ancestor), so they cannot be
            # donated from here and do not justify evicting their owner
            out: Dict[str, int] = {}
            for p in alloc.paths:
                v = host.graph.get(p)
                if v is None or p in host.spliced_paths \
                        or p in host.external_paths:
                    continue
                out[v.type] = out.get(v.type, 0) + 1
            return out

        def deficit() -> Dict[str, int]:
            free: Dict[str, int] = {}
            for root in host.graph.roots:
                for t, n in host.graph.vertex(root).agg_free.items():
                    free[t] = free.get(t, 0) + n
            return {t: n - free.get(t, 0)
                    for t, n in jobspec.type_counts().items()
                    if n - free.get(t, 0) > 0}

        out = self.reclaim(jobspec)
        if out is not None:
            out["victims"] = []
            return out
        # candidate selection + feasibility under the lock; the actual
        # evictions below re-check per victim and lock per stage, so
        # the lock is NEVER held across host.release's parent RPC (the
        # invariant that keeps parent<->child locking cycle-free)
        with host.lock:
            candidates = [a for a in host.allocations.values()
                          if a.preemptible and a.priority < priority]
            if not candidates:
                return None
            # feasibility precheck over the pruning aggregates: free
            # counts plus every candidate's *donatable* vertices must
            # cover the request per type, else eviction would displace
            # work for nothing the requester could ever receive
            avail: Dict[str, int] = {}
            for root in host.graph.roots:
                for t, n in host.graph.vertex(root).agg_free.items():
                    avail[t] = avail.get(t, 0) + n
            for alloc in candidates:
                for t, n in donatable(alloc).items():
                    avail[t] = avail.get(t, 0) + n
            if any(n > avail.get(t, 0)
                   for t, n in jobspec.type_counts().items()):
                return None
            # lowest priority first; newest first within a priority
            # (later-started work is the cheaper loss)
            order = {id(a): i
                     for i, a in enumerate(host.allocations.values())}
            candidates.sort(key=lambda a: (a.priority, -order[id(a)]))
        victims: List[str] = []
        for alloc in candidates:
            with host.lock:
                if alloc.jobid not in host.allocations:
                    continue    # concurrently released: nothing to evict
                gap = deficit()
                useless = gap and not any(t in gap
                                          for t in donatable(alloc))
                freed = list(alloc.paths)
            if useless:
                continue        # evicting this one cannot close the gap
            jobid = alloc.jobid
            host.release(jobid)
            victims.append(jobid)
            log = getattr(host, "eventlog", None)
            if log is not None:
                log.emit(EventType.REVOKE, jobid, n_paths=len(freed),
                         priority=priority)
            for fn in getattr(host, "revoke_listeners", ()):
                fn(jobid, freed)
            out = self.reclaim(jobspec)
            if out is not None:
                out["victims"] = victims
                return out
        # structural mismatch despite sufficient counts: the victims
        # are already requeued by their listeners and will restart on
        # the freed resources at their queue's next scheduling pass
        return None
