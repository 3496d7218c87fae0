"""Hierarchical resource request specification (Fluxion-style jobspec).

A jobspec expresses a nested resource request, e.g. "4 nodes, each with
2 sockets, each with 16 cores".  It is the argument of MATCHALLOCATE and
MATCHGROW (paper Section 3) and is what the External API translates into
provider requests (paper Section 4).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class ResourceReq:
    """One level of a nested resource request."""

    type: str
    count: int = 1
    with_: List["ResourceReq"] = field(default_factory=list)
    # optional property constraints: vertex.properties must include these
    properties: Dict[str, str] = field(default_factory=dict)
    # optional minimum size (e.g. memory GB)
    size: int = 1

    def to_dict(self) -> Dict:
        d: Dict = {"type": self.type, "count": self.count}
        if self.with_:
            d["with"] = [w.to_dict() for w in self.with_]
        if self.properties:
            d["properties"] = dict(self.properties)
        if self.size != 1:
            d["size"] = self.size
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "ResourceReq":
        return cls(
            type=d["type"],
            count=d.get("count", 1),
            with_=[cls.from_dict(w) for w in d.get("with", [])],
            properties=dict(d.get("properties", {})),
            size=d.get("size", 1),
        )

    def total_vertices(self) -> int:
        """Number of vertices a successful match will contain."""
        n = self.count
        for w in self.with_:
            n += self.count * w.total_vertices()
        return n

    def graph_size(self) -> int:
        """Request 'graph size' in the paper's convention (Table 1):
        every matched vertex carries one up-edge, so size = 2·|V|; a
        request not rooted at ``node`` is wrapped in a slot vertex
        (paper T8: 1 socket × 16 cores → 18 vertices → size 36)."""
        v = self.total_vertices()
        if self.type != "node":
            v += 1  # implicit slot wrapping (Fluxion convention)
        return 2 * v

    def type_counts(self, out: Optional[Dict[str, int]] = None,
                    mult: int = 1) -> Dict[str, int]:
        """Total requested vertices per type — the aggregate the pruning
        filters track.  Used for shadow-time reservations and for
        preemption-feasibility prechecks."""
        if out is None:
            out = {}
        out[self.type] = out.get(self.type, 0) + mult * self.count
        for w in self.with_:
            w.type_counts(out, mult * self.count)
        return out


@dataclass
class Jobspec:
    """A resource match request (the paper's jobspec)."""

    resources: List[ResourceReq]
    attributes: Dict[str, str] = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "version": 1,
            "resources": [r.to_dict() for r in self.resources],
            "attributes": dict(self.attributes),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "Jobspec":
        return cls(
            resources=[ResourceReq.from_dict(r) for r in d.get("resources", [])],
            attributes=dict(d.get("attributes", {})),
        )

    def graph_size(self) -> int:
        return sum(r.graph_size() for r in self.resources)

    def type_counts(self) -> Dict[str, int]:
        """Total requested vertices per type across all resource roots.

        Memoized: a jobspec is read-only once submitted (interned specs
        are shared across thousands of jobs in the scale replays), and
        every consumer treats the returned dict as read-only."""
        out = self.__dict__.get("_tc_cache")
        if out is None:
            out = {}
            for r in self.resources:
                r.type_counts(out)
            self.__dict__["_tc_cache"] = out
        return out

    # ------------------------------------------------------------------ #
    # convenience constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def hpc(cls, nodes: int = 0, sockets: int = 2, cores: int = 16,
            gpus: int = 0, mem: int = 0) -> "Jobspec":
        """Paper-style request: ``nodes`` nodes × ``sockets`` sockets ×
        ``cores`` cores [+gpus, +memory].  With ``nodes == 0`` the request
        is socket-rooted (paper test T8)."""
        leaf: List[ResourceReq] = [ResourceReq("core", cores)]
        if gpus:
            leaf.append(ResourceReq("gpu", gpus))
        if mem:
            leaf.append(ResourceReq("memory", mem))  # per-GB vertices
        sock = ResourceReq("socket", max(sockets, 1), with_=leaf)
        if nodes <= 0:
            return cls(resources=[sock])
        # distribute sockets/cores per node: the paper's T-tests request
        # k nodes each with sockets/nodes sockets etc.
        spn = max(sockets // nodes, 1)
        cps = max(cores // max(sockets, 1), 1)
        leaf = [ResourceReq("core", cps)]
        if gpus:
            leaf.append(ResourceReq("gpu", max(gpus // max(sockets, 1), 1)))
        if mem:
            leaf.append(ResourceReq("memory", mem))
        node = ResourceReq(
            "node", nodes, with_=[ResourceReq("socket", spn, with_=leaf)]
        )
        return cls(resources=[node])

    @classmethod
    def tpu(cls, pods: int = 0, nodes: int = 0, chips: int = 4) -> "Jobspec":
        """TPU-fleet request: whole pods, or nodes × chips."""
        if pods > 0:
            return cls(resources=[ResourceReq("pod", pods)])
        chip = ResourceReq("chip", chips)
        if nodes > 0:
            return cls(resources=[ResourceReq("node", nodes,
                                              with_=[ResourceReq("chip", 4)])])
        return cls(resources=[chip])

    @classmethod
    def instances(cls, instance_type: str, count: int = 1) -> "Jobspec":
        """External-provider request for named instance types."""
        return cls(
            resources=[ResourceReq("node", count,
                                   properties={"instance_type": instance_type})],
            attributes={"external": "true"},
        )

    @classmethod
    def fleet(cls, count: int, allowed_types: Optional[List[str]] = None) -> "Jobspec":
        """EC2-Fleet-style request: 'count' instances, provider's choice of
        type (optionally restricted)."""
        attrs = {"external": "true", "fleet": "true"}
        if allowed_types:
            attrs["allowed_types"] = ",".join(allowed_types)
        return cls(resources=[ResourceReq("node", count)], attributes=attrs)
