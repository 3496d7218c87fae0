"""Runtime lock-order witness: named locks, observed orders, AB-BA detection.

Layer 2 of the concurrency-correctness subsystem (layer 1 is the static
lint in :mod:`repro.analysis.lint`; the contract both enforce is written
down in ``docs/CONCURRENCY.md``).  Core modules construct every lock
through :func:`named_lock` / :func:`named_rlock` instead of calling
``threading.Lock()`` directly (lint rule R4 enforces this).  Normally
that is free: with the witness inactive the factories return the raw
``threading`` primitive.

Set ``REPRO_LOCK_WITNESS=1`` (or call :func:`activate`) and the factories
return wrappers that record, per thread, the stack of witness locks held
at every first acquisition.  Each ``held -> acquired`` pair becomes an
edge in a global lock-order graph, tagged with the set of threads that
drove it.  From that graph the witness reports:

* **cycles** — strongly connected components of the order graph.  A
  cycle is *fatal* only when its edges were driven by two or more
  distinct threads: that is a real AB-BA deadlock candidate.  A cycle
  produced by a single thread (e.g. one driver stepping two mutually
  preemptive queues, the ``MultiTenantTree`` pattern) cannot deadlock
  by itself and is reported as benign.
* **transport violations** — a transport ``call``/``call_many`` entered
  while the thread holds any witness lock not created with
  ``allow_transport=True``.  The queue's ``_api_lock`` is the one lock
  deliberately held across transport (the documented escalation
  design); every other core lock must be released first.

``dump()`` writes the whole graph as JSON so CI can archive it and a
human can audit which orders actually occurred (see CONCURRENCY.md for
how to read it).

This module is imported by ``repro_torch.core`` and therefore depends only on
the standard library.
"""
from __future__ import annotations

import json
import os
import threading
import traceback
from contextlib import contextmanager
from typing import Dict, List, Optional, Set, Tuple


class LockRegistry:
    """Every lock core constructs gets a unique name here (lint R4).

    Registration happens whether or not the witness is active, so the
    registry doubles as a census of which locks exist at runtime.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.locks: Dict[str, dict] = {}     # name -> {kind, allow_transport}

    def register(self, base: str, kind: str, allow_transport: bool) -> str:
        with self._mu:
            n = self._counts.get(base, 0)
            self._counts[base] = n + 1
            name = base if n == 0 else f"{base}#{n}"
            self.locks[name] = {"kind": kind,
                                "allow_transport": allow_transport}
            return name


REGISTRY = LockRegistry()


def _short_stack(skip: int = 3, depth: int = 6) -> List[str]:
    """A compact ``file:line:func`` sample of the acquiring call site."""
    frames = traceback.extract_stack()[:-skip]
    return [f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
            for f in frames[-depth:]]


class _ThreadState(threading.local):
    def __init__(self) -> None:
        self.held: List[str] = []            # first-acquisition order
        self.depth: Dict[str, int] = {}      # re-entrancy counts


class LockOrderWitness:
    """Global observed-order graph over all named locks."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._tls = _ThreadState()
        self.transport_ok: Dict[str, bool] = {}
        # (held, acquired) -> {count, threads, stack}
        self.edges: Dict[Tuple[str, str], dict] = {}
        self.transport_violations: List[dict] = []

    # -- wrapper callbacks ---------------------------------------- #
    def register_lock(self, name: str, allow_transport: bool) -> None:
        with self._mu:
            self.transport_ok[name] = allow_transport

    def acquired(self, name: str) -> None:
        st = self._tls
        d = st.depth.get(name, 0)
        st.depth[name] = d + 1
        if d:                                # re-entrant: no new order
            return
        if st.held:
            tid = threading.get_ident()
            with self._mu:
                for h in st.held:
                    e = self.edges.get((h, name))
                    if e is None:
                        e = {"count": 0, "threads": set(),
                             "stack": _short_stack()}
                        self.edges[(h, name)] = e
                    e["count"] += 1
                    e["threads"].add(tid)
        st.held.append(name)

    def released(self, name: str) -> None:
        st = self._tls
        d = st.depth.get(name, 0) - 1
        if d > 0:
            st.depth[name] = d
            return
        st.depth.pop(name, None)
        # usually LIFO; tolerate out-of-order release
        for i in range(len(st.held) - 1, -1, -1):
            if st.held[i] == name:
                del st.held[i]
                break

    def note_transport_call(self, method: str) -> None:
        st = self._tls
        bad = [n for n in st.held if not self.transport_ok.get(n, False)]
        if bad:
            with self._mu:
                self.transport_violations.append({
                    "method": method,
                    "held": list(bad),
                    "thread": threading.get_ident(),
                    "stack": _short_stack(),
                })

    def held_by_current_thread(self) -> List[str]:
        return list(self._tls.held)

    # -- analysis -------------------------------------------------- #
    def cycles(self) -> List[dict]:
        """Strongly connected components with >= 2 locks, each tagged
        ``fatal`` when its internal edges span >= 2 threads."""
        with self._mu:
            edges = {k: set(v["threads"]) for k, v in self.edges.items()}
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        sccs = _tarjan(graph)
        out = []
        for comp in sccs:
            if len(comp) < 2:
                continue
            comp_set = set(comp)
            threads: Set[int] = set()
            internal = []
            for (a, b), tids in edges.items():
                if a in comp_set and b in comp_set:
                    internal.append([a, b])
                    threads |= tids
            out.append({
                "locks": sorted(comp),
                "edges": sorted(internal),
                "threads": sorted(threads),
                "fatal": len(threads) >= 2,
            })
        return out

    def fatal_cycles(self) -> List[dict]:
        return [c for c in self.cycles() if c["fatal"]]

    def has_edge(self, a: str, b: str) -> bool:
        with self._mu:
            return (a, b) in self.edges

    def snapshot(self) -> dict:
        with self._mu:
            edges = [{
                "from": a, "to": b, "count": e["count"],
                "threads": sorted(e["threads"]), "stack": e["stack"],
            } for (a, b), e in sorted(self.edges.items())]
            violations = [dict(v) for v in self.transport_violations]
            locks = {n: {"allow_transport": ok}
                     for n, ok in sorted(self.transport_ok.items())}
        cycles = self.cycles()
        return {
            "locks": locks,
            "edges": edges,
            "cycles": cycles,
            "fatal_cycles": [c for c in cycles if c["fatal"]],
            "transport_violations": violations,
        }

    def dump(self, path: str) -> dict:
        snap = self.snapshot()
        with open(path, "w") as fh:
            json.dump(snap, fh, indent=2, sort_keys=True)
        return snap

    def report(self) -> str:
        snap = self.snapshot()
        lines = [f"lock-order witness: {len(snap['locks'])} locks, "
                 f"{len(snap['edges'])} edges"]
        for c in snap["cycles"]:
            tag = "FATAL" if c["fatal"] else "benign (single-thread)"
            lines.append(f"  cycle [{tag}]: " + " <-> ".join(c["locks"]))
        for v in snap["transport_violations"]:
            lines.append(f"  transport call '{v['method']}' while holding "
                         f"{v['held']}")
        return "\n".join(lines)


def _tarjan(graph: Dict[str, Set[str]]) -> List[List[str]]:
    """Iterative Tarjan SCC (no recursion limit surprises)."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    sccs: List[List[str]] = []
    counter = [0]

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(graph.get(root, ())))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(graph.get(nxt, ()))))
                    advanced = True
                    break
                elif nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                sccs.append(comp)
    return sccs


class _WitnessLock:
    """Wrapper recording acquisition order into a witness.

    Delegates everything else (``_is_owned``, ``locked``, ...) to the
    wrapped ``threading`` primitive so callers can't tell the difference.
    """

    def __init__(self, inner, name: str, witness: "LockOrderWitness",
                 allow_transport: bool) -> None:
        self._inner = inner
        self.witness_name = name
        self._witness = witness
        self.allow_transport = allow_transport
        witness.register_lock(name, allow_transport)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.acquired(self.witness_name)
        return ok

    def release(self) -> None:
        self._witness.released(self.witness_name)
        self._inner.release()

    def __enter__(self) -> "_WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def __repr__(self) -> str:
        return f"<witness {self.witness_name} {self._inner!r}>"


# ------------------------------------------------------------------ #
_witness: Optional[LockOrderWitness] = None


def active_witness() -> Optional[LockOrderWitness]:
    return _witness


def activate() -> LockOrderWitness:
    """Turn the witness on (idempotent).  Only locks created *after*
    activation are wrapped; tests activate before building fixtures."""
    global _witness
    if _witness is None:
        _witness = LockOrderWitness()
    return _witness


def deactivate() -> None:
    """Stop wrapping newly created locks.  Locks already wrapped keep
    recording into the (now detached) witness they were born with."""
    global _witness
    _witness = None


@contextmanager
def scoped_witness():
    """A fresh witness for the duration of the block (unit tests),
    restoring whatever witness was active before — so witness tests
    behave identically inside and outside the CI witness lane."""
    global _witness
    prev = _witness
    _witness = LockOrderWitness()
    try:
        yield _witness
    finally:
        _witness = prev


def named_lock(base: str, *, allow_transport: bool = False):
    """A ``threading.Lock`` registered under ``base`` (uniquified)."""
    name = REGISTRY.register(base, "Lock", allow_transport)
    w = _witness
    if w is None:
        return threading.Lock()
    return _WitnessLock(threading.Lock(), name, w, allow_transport)


def named_rlock(base: str, *, allow_transport: bool = False):
    """A ``threading.RLock`` registered under ``base`` (uniquified)."""
    name = REGISTRY.register(base, "RLock", allow_transport)
    w = _witness
    if w is None:
        return threading.RLock()
    return _WitnessLock(threading.RLock(), name, w, allow_transport)


def note_transport_call(method: str) -> None:
    """Transports call this on entry to ``call``/``call_many``; records
    a violation when the calling thread holds a non-exempt lock."""
    w = _witness
    if w is not None:
        w.note_transport_call(method)


if os.environ.get("REPRO_LOCK_WITNESS") == "1":
    activate()
