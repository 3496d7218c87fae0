"""Fully hierarchical scheduler instances with MATCHALLOCATE / MATCHGROW.

Implements the paper's Algorithm 1 over the dynamic resource graph:

* ``match_allocate`` (MA) — match a jobspec against the local graph and
  allocate the resources on success.
* ``match_grow`` (MG) — one call into the shared :class:`GrowEngine`
  (``core/engine.py``): try MA locally; on local failure ask sibling
  subtrees to reclaim free resources; then forward to the parent
  instance via RPC; at the top level fall through to the External API.
  The matched subgraph travels back down in JGF; every level on the way
  splices it in with ``AddSubgraph`` + ``UpdateMetadata`` — the
  top-down additive transform.  The RPC-served side runs the *same*
  engine with ``encode=True``.
* ``match_shrink`` — the subtractive transform, applied bottom-up: the
  leaf removes the subgraph first, then notifies its parent, which
  releases the allocation (and optionally removes vertices that only
  existed for this child, e.g. external resources).

The hierarchy is a *tree* (paper Fig. 2's multi-user topology), not
just a chain: an instance can have many children, and a parent routes a
child's failed MG to the child's siblings before escalating.

Every MG records per-level component timings (t_match, t_comms,
t_add_upd), which the benchmarks aggregate to reproduce the paper's
Figures 1/3/4 and its analytical model (Section 6):

    t_MG = sum_i  t_match_i + t_comms_i + t_add_upd_i
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from ..analysis.lockwitness import named_rlock
from .engine import Allocation, GrowEngine, GrowResult, MGTiming
from .events import EventType
from .external import ExternalProvider
from .graph import ResourceGraph
from .jobspec import Jobspec
from .match import Matcher
from .rpc import (InProcTransport, MethodRegistry, MuxServer,
                  SocketTransport, Transport, pack_json, unpack_json)
from .transform import TransformKind, TransformResult, remove_subgraph


class SchedulerInstance:
    """One level of the fully hierarchical scheduler.

    ``parent`` is a Transport (in-proc for intranode, socket for
    internode) or None for the top level.  ``children`` maps child
    instance names to *downward* transports, used for sibling routing
    (the ``reclaim`` RPC).  ``external`` is the optional ExternalAPI
    provider — per the paper, an external provider attached to a
    *non-top* instance realizes "external resource specialization"
    (resources E_i = G_i \\ G_0 managed independently of the top level).
    """

    def __init__(self, name: str, graph: ResourceGraph,
                 parent: Optional[Transport] = None,
                 external: Optional[ExternalProvider] = None,
                 external_at_any_level: bool = False):
        self.name = name
        self.graph = graph
        self.parent = parent
        self.external = external
        self.external_at_any_level = external_at_any_level
        self.allocations: Dict[str, Allocation] = {}
        self.timings: List[MGTiming] = []
        self.children: Dict[str, Transport] = {}
        self.engine = GrowEngine(self)
        self._jobids = itertools.count()
        self._server: Optional[MuxServer] = None
        # stream verbs (server-push subscriptions) survive a close()/
        # re-serve() cycle: they are re-applied to the fresh MuxServer
        self._stream_openers: Dict[str, Callable] = {}
        self.external_paths: Set[str] = set()   # E_i bookkeeping
        # vertices spliced in from above (parent/sibling grows): they
        # only exist here for a job's lifetime and are removed — not
        # freed into the local pool — when that job releases them
        self.spliced_paths: Set[str] = set()
        # preemption hooks: called with (jobid, freed_paths) when a
        # revoke evicts an allocation at this instance, so the owning
        # JobQueue can requeue the victim (PREEMPTED -> PENDING)
        self.revoke_listeners: List[Callable[[str, List[str]], None]] = []
        # optional weighted fair-share arbiter (core/tenancy.py): gates
        # which child subtree may preempt which sibling's work
        self.arbiter = None
        # typed event sink (core/events.py), set by the owning JobQueue
        # or Instance: RELEASE is emitted here, GROW/REVOKE by the
        # engine.  Scheduler-level events are keyed by allocation id.
        self.eventlog = None
        # optional trace-span sink (core/metrics.py SpanCollector or
        # anything with .record(dict)): the engine records per-stage
        # match_grow spans and release() records release spans.  None
        # (the default) costs producers one attribute check.
        self.span_collector = None
        # per-instance mutation lock: RPCServer sessions run in their
        # own threads and SocketTransport pools connections, so
        # concurrent MG/release/revoke requests can hit one instance at
        # once.  The lock guards LOCAL graph/allocation mutations only
        # — never held across a transport call (a parent routing to a
        # child while the child escalates to the parent would deadlock
        # otherwise).  RLock: revoke releases victims re-entrantly.
        self.lock = named_rlock(f"scheduler:{name}")
        # prewarm the flat-array mirror: schedulers are long-lived, so
        # the one-time build happens here (instance construction), not
        # inside the first match's timed region.  Small graphs stay on
        # the dict DFS (see Matcher), so they skip mirror upkeep too.
        from .flatgraph import FLAT_MIN_VERTICES, flat_enabled
        if flat_enabled() and graph.num_vertices >= FLAT_MIN_VERTICES:
            graph.flat()
        self.methods = MethodRegistry()
        self.methods.register("match_grow", self._rpc_match_grow)
        self.methods.register("release", self._rpc_release)
        self.methods.register("reclaim", self._rpc_reclaim)
        self.methods.register("revoke", self._rpc_revoke)
        self.methods.register("usage", self._rpc_usage)

    # ------------------------------------------------------------------ #
    # serving (parent side)
    # ------------------------------------------------------------------ #
    def serve(self, backlog: int = 512, workers: int = 8
              ) -> Tuple[str, int]:
        """Expose this instance over a loopback socket ("internode").
        The server is a :class:`MuxServer` — it speaks both the legacy
        ``SocketTransport`` protocol and the multiplexed/push protocol
        of ``MuxTransport`` on the same port."""
        if self._server is None:
            self._server = MuxServer(self.rpc_handler, backlog=backlog,
                                     workers=workers,
                                     streams=self._stream_openers)
        return self._server.address

    def inproc_transport(self) -> InProcTransport:
        """An "intranode" channel to this instance."""
        return InProcTransport(self.rpc_handler)

    def add_child(self, name: str, transport: Transport) -> None:
        """Register a downward channel to a child (sibling routing)."""
        self.children[name] = transport

    def close(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None

    def rpc_handler(self, method: str, payload: bytes) -> bytes:
        return self.methods(method, payload)

    def register_method(self, name: str,
                        fn: Callable[[bytes], bytes]) -> None:
        """Extension point: expose an extra RPC method on this level."""
        self.methods.register(name, fn)

    def register_stream(self, name: str, opener: Callable) -> None:
        """Extension point: expose a server-push stream verb.
        ``opener(payload, push) -> (ack_payload, close_fn)``; ``push``
        enqueues EVENT frames on the subscriber's connection."""
        self._stream_openers[name] = opener
        if self._server is not None:
            self._server.register_stream(name, opener)

    # -- registered RPC methods ---------------------------------------- #
    def _rpc_match_grow(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        jobspec = Jobspec.from_dict(req["jobspec"])
        jobid = req.get("jobid", "remote")
        res = self.engine.grow(jobspec, jobid,
                               requester=req.get("from"), encode=True,
                               priority=req.get("priority", 0),
                               preempt=bool(req.get("preempt", False)))
        return res.jgf if res and res.jgf is not None else b""

    def _rpc_release(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        self.release(req["jobid"], req.get("paths"))
        return pack_json({"ok": True})

    def _rpc_reclaim(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        jobspec = Jobspec.from_dict(req["jobspec"])
        out = self.engine.reclaim(jobspec)
        return pack_json(out) if out is not None else b""

    def _rpc_revoke(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        jobspec = Jobspec.from_dict(req["jobspec"])
        out = self.engine.revoke(jobspec, req.get("priority", 0))
        return pack_json(out) if out is not None else b""

    def _rpc_usage(self, payload: bytes) -> bytes:
        return pack_json(self.usage())

    def usage(self) -> Dict[str, int]:
        """Occupancy snapshot for fair-share arbitration: vertices held
        by real jobs (delegation markers do not count as usage)."""
        from .graph import DELEGATION_PREFIX
        with self.lock:
            allocated = sum(
                1 for v in self.graph.vertices()
                if any(not j.startswith(DELEGATION_PREFIX)
                       for j in v.allocations))
            return {"allocated": allocated,
                    "capacity": self.graph.num_vertices}

    # ------------------------------------------------------------------ #
    # MATCHALLOCATE
    # ------------------------------------------------------------------ #
    def new_jobid(self, prefix: str = "job") -> str:
        return f"{prefix}-{self.name}-{next(self._jobids)}"

    def match_allocate(self, jobspec: Jobspec,
                       jobid: Optional[str] = None) -> Optional[Allocation]:
        """MA: match against the local graph; allocate on success."""
        jobid = jobid or self.new_jobid()
        with self.lock:
            matcher = Matcher(self.graph)
            paths = matcher.match(jobspec)
            if paths is None:
                return None
            self.graph.set_allocated(paths, jobid)
            alloc = self.allocations.setdefault(jobid, Allocation(jobid))
            alloc.paths.extend(paths)
            return alloc

    # ------------------------------------------------------------------ #
    # MATCHGROW (Algorithm 1, via the shared engine)
    # ------------------------------------------------------------------ #
    def match_grow(self, jobspec: Jobspec, jobid: str, *,
                   priority: int = 0, preempt: bool = False) -> GrowResult:
        """MG: grow ``jobid``'s allocation by ``jobspec``.

        Returns a :class:`GrowResult` (truthy on success) and records an
        MGTiming either way.  ``preempt=True`` allows the hierarchy to
        revoke preemptible allocations of priority below ``priority``
        from sibling subtrees when free resources do not suffice.
        """
        return self.engine.grow(jobspec, jobid, priority=priority,
                                preempt=preempt)

    # ------------------------------------------------------------------ #
    # MATCHSHRINK (subtractive, bottom-up)
    # ------------------------------------------------------------------ #
    def match_shrink(self, jobid: str, paths: Sequence[str],
                     remove_vertices: bool = True) -> TransformResult:
        """Shrink ``jobid``'s allocation by ``paths``.

        Bottom-up: remove locally first, then notify the parent so it
        can release (the parent keeps the vertices — they return to its
        free pool — unless they were external)."""
        with self.lock:
            if remove_vertices:
                res = remove_subgraph(self.graph, list(paths), jobid=jobid)
                self.spliced_paths.difference_update(paths)
                self.external_paths.difference_update(paths)
            else:
                self.graph.set_free(paths, jobid)
                res = TransformResult(kind=TransformKind.SUBTRACTIVE)
            alloc = self.allocations.get(jobid)
            if alloc is not None:
                doomed = set(paths)
                alloc.paths = [p for p in alloc.paths
                               if p not in doomed
                               and self.graph.get(p) is not None]
                if not alloc.paths:
                    self.allocations.pop(jobid, None)
        if self.parent is not None:
            self.parent.call("release", pack_json(
                {"jobid": jobid, "paths": list(paths)}))
        return res

    def release(self, jobid: str, paths: Optional[Sequence[str]] = None) -> None:
        """Release an allocation (fully, or the given subset).

        Local vertices return to the free pool.  External vertices and
        vertices spliced in from above (which only existed here for
        this job) are removed.  The release propagates bottom-up: the
        parent frees its own copies in turn, all the way to the level
        that originally matched the subgraph.

        With a span collector attached, each release records one
        ``release`` span (this is the latency behind queue-level
        shrink and free operations); the record happens after every
        lock is released.
        """
        col = self.span_collector
        if col is None:
            self._release(jobid, paths)
            return
        t0 = time.perf_counter()
        n = self._release(jobid, paths)
        col.record({"name": "release", "level": self.name,
                    "jobid": jobid, "ok": n > 0, "via": None,
                    "dur": time.perf_counter() - t0,
                    "stages": {}, "n_paths": n})

    def _release(self, jobid: str,
                 paths: Optional[Sequence[str]] = None) -> int:
        with self.lock:
            alloc = self.allocations.get(jobid)
            if alloc is None:
                return 0
            target = list(paths) if paths is not None else list(alloc.paths)
            present = [p for p in target if p in self.graph]
            self.graph.set_free(present, jobid)
            # external vertices disappear when their job releases them
            ext = [p for p in present if p in self.external_paths]
            if ext:
                self._remove_departed(ext, jobid, self.external_paths)
            # pass-through copies from parent/sibling grows likewise
            # leave this graph instead of inflating the local free pool
            spl = [p for p in present
                   if p in self.spliced_paths and p in self.graph]
            if spl:
                self._remove_departed(spl, jobid, self.spliced_paths)
            if paths is None:
                self.allocations.pop(jobid, None)
            else:
                doomed = set(target)
                alloc.paths = [p for p in alloc.paths if p not in doomed]
                if not alloc.paths:  # don't retain a record per dead job
                    self.allocations.pop(jobid, None)
        if self.eventlog is not None and present:
            self.eventlog.emit(EventType.RELEASE, jobid,
                               n_paths=len(present))
        # propagate only when the release touched pass-through copies —
        # an ancestor can hold state for exactly those; purely local
        # jobs release without an RPC round trip per completion
        if self.parent is not None and spl:
            self.parent.call("release", pack_json(
                {"jobid": jobid, "paths": target}))
        return len(present)

    def _remove_departed(self, paths: Sequence[str], jobid: str,
                         book: Set[str]) -> None:
        """Remove ``jobid``'s departing (spliced/external) vertices.

        Two jobs' spliced-in subgraphs may share an ancestor spine
        vertex (both grew sockets under one spliced node): removing the
        first job's paths as whole subtrees would destroy the second
        job's still-allocated vertices beneath the shared spine.  A
        path is therefore removed only while nothing under it is still
        allocated; blocked spines stay (free, still in ``book``) and
        are swept once the last tenant beneath them departs."""
        removable = []
        for p in paths:
            if any(self.graph.vertex(s).allocations
                   for s in self.graph.subtree(p)):
                continue            # someone else still lives below
            removable.append(p)
        if removable:
            remove_subgraph(self.graph, removable, jobid=jobid)
            book.difference_update(removable)
        self._sweep_orphan_spines()

    def _sweep_orphan_spines(self) -> None:
        """Drop spliced/external spine vertices whose payload subtrees
        are gone: free, childless, and pass-through — bottom-up until
        a fixpoint, so an entire orphaned spine chain unwinds."""
        changed = True
        while changed:
            changed = False
            for book in (self.spliced_paths, self.external_paths):
                for p in sorted(book, key=lambda s: s.count("/"),
                                reverse=True):
                    v = self.graph.get(p)
                    if v is None:
                        book.discard(p)
                        changed = True
                    elif v.free and not self.graph.children(p):
                        remove_subgraph(self.graph, [p])
                        book.discard(p)
                        changed = True


# ---------------------------------------------------------------------- #
# hierarchy builders (chain and tree)
# ---------------------------------------------------------------------- #
@dataclass
class TreeSpec:
    """Declarative node of a scheduler-hierarchy tree.

    ``socket=True`` links this node to its parent over the loopback
    socket ("internode"); the default link is in-process ("intranode").
    ``link_latency_s`` adds a simulated one-way latency to that socket
    link (loopback is microseconds; real internode fabrics are not).
    ``external`` attaches a provider to this node (the paper's external
    resource specialization when the node is not the root).
    """

    graph: ResourceGraph
    name: str = ""
    children: List["TreeSpec"] = field(default_factory=list)
    socket: bool = False
    link_latency_s: float = 0.0
    external: Optional[ExternalProvider] = None


@dataclass
class Hierarchy:
    """A tree of scheduler instances, preorder (top first, leaf last)."""

    instances: List[SchedulerInstance]

    @property
    def top(self) -> SchedulerInstance:
        return self.instances[0]

    @property
    def leaf(self) -> SchedulerInstance:
        return self.instances[-1]

    def __getitem__(self, name: str) -> SchedulerInstance:
        for inst in self.instances:
            if inst.name == name:
                return inst
        raise KeyError(name)

    def close(self) -> None:
        for inst in self.instances:
            inst.close()

    def total_timings(self) -> List[MGTiming]:
        out: List[MGTiming] = []
        for inst in self.instances:
            out.extend(inst.timings)
        return out


def build_tree(spec: TreeSpec) -> Hierarchy:
    """Build a scheduler-instance tree from a :class:`TreeSpec`.

    Each child gets an upward transport to its parent, and the parent
    gets a downward transport to the child (for sibling routing).  Both
    directions use the socket regime when ``spec.socket`` is set.
    """
    instances: List[SchedulerInstance] = []
    counter = itertools.count()

    def _build(node: TreeSpec,
               parent: Optional[SchedulerInstance]) -> SchedulerInstance:
        name = node.name or f"L{next(counter)}"
        parent_t: Optional[Transport] = None
        if parent is not None:
            if node.socket:
                parent_t = SocketTransport(parent.serve(),
                                           latency_s=node.link_latency_s)
            else:
                parent_t = parent.inproc_transport()
        inst = SchedulerInstance(name, node.graph, parent=parent_t,
                                 external=node.external)
        if node.external is not None and parent is not None:
            inst.external_at_any_level = True
        instances.append(inst)
        if parent is not None:
            down: Transport = (
                SocketTransport(inst.serve(),
                                latency_s=node.link_latency_s)
                if node.socket else inst.inproc_transport())
            parent.add_child(name, down)
        for child in node.children:
            _build(child, inst)
        return inst

    _build(spec, None)
    return Hierarchy(instances)


def build_chain(graphs: List[ResourceGraph],
                names: Optional[List[str]] = None,
                socket_levels: Optional[Sequence[int]] = None,
                external: Optional[ExternalProvider] = None) -> Hierarchy:
    """Build a parent→child chain of instances (a degenerate tree).

    ``graphs[0]`` is the top level.  ``socket_levels`` lists child indices
    whose link *to their parent* uses the loopback socket ("internode");
    all other links are in-process ("intranode").  ``external`` attaches
    to the top level (the paper's default ExternalAPI placement).
    """
    names = names or [f"L{i}" for i in range(len(graphs))]
    socket_levels = set(socket_levels or ())
    spec: Optional[TreeSpec] = None
    for i in range(len(graphs) - 1, -1, -1):
        spec = TreeSpec(graph=graphs[i], name=names[i],
                        socket=i in socket_levels,
                        external=external if i == 0 else None,
                        children=[spec] if spec is not None else [])
    assert spec is not None
    return build_tree(spec)
