"""Failure detection and recovery policy (the port of
``repro/runtime/fault.py``).

Heartbeat-based detector over the resource graph's node vertices; a
missed-deadline node is marked DOWN and ejected via the subtractive
transform, then replaced through MATCHGROW (spare pool first, then the
External API — the Prabhakaran-2018 dynamic-node-replacement policy
expressed as a policy over the paper's primitives).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..core.graph import DOWN
from .elastic import ElasticRuntime


@dataclass
class HeartbeatMonitor:
    """Tracks per-node heartbeats; nodes silent > ``timeout_s`` fail."""

    timeout_s: float = 10.0
    last_seen: Dict[str, float] = field(default_factory=dict)

    def beat(self, node_path: str, t: Optional[float] = None) -> None:
        self.last_seen[node_path] = t if t is not None else time.time()

    def dead_nodes(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        return [n for n, t in self.last_seen.items()
                if now - t > self.timeout_s]


class FaultPolicy:
    """Connects the monitor to the elastic runtime."""

    def __init__(self, runtime: ElasticRuntime,
                 monitor: Optional[HeartbeatMonitor] = None,
                 on_restore: Optional[Callable[[], None]] = None):
        self.runtime = runtime
        self.monitor = monitor or HeartbeatMonitor()
        self.on_restore = on_restore
        self.failures: List[str] = []

    def watch_allocation(self) -> None:
        g = self.runtime.scheduler.graph
        alloc = self.runtime.scheduler.allocations.get(self.runtime.jobid)
        if alloc is None:
            return
        nodes = set()
        for p in alloc.paths:
            if p in g:
                v = g.vertex(p)
                node = p if v.type == "node" else None
                if node is None:
                    for anc in g.ancestors(p):
                        if g.vertex(anc).type == "node":
                            node = anc
                            break
                if node:
                    nodes.add(node)
        for n in nodes:
            self.monitor.last_seen.setdefault(n, time.time())

    def tick(self, now: Optional[float] = None) -> List[str]:
        """Check heartbeats; eject+replace every dead node.  Returns the
        list of ejected node paths."""
        dead = self.monitor.dead_nodes(now)
        for node in dead:
            g = self.runtime.scheduler.graph
            if node in g:
                g.set_status(node, DOWN)
            self.runtime.eject_and_replace(node)
            self.failures.append(node)
            self.monitor.last_seen.pop(node, None)
            if self.on_restore is not None:
                self.on_restore()
        return dead
