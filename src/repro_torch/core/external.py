"""External resource providers (paper Sections 3-4: ExternalAPI / EC2API).

The External API translates a jobspec into provider calls and returns the
provisioned resources *as a subgraph* (JGF), so "to a scheduler instance,
the external resource provider is functionally just another parent in the
hierarchical scheduling".

Providers:

* ``SimulatedEC2Provider`` — reproduces the paper's EC2API: the Table-3
  instance catalog (t2.* / g2 / g3 with their CPU/mem/GPU shapes and
  resulting subgraph sizes), specific-instance requests, and EC2-Fleet
  requests where the *provider* chooses instance types/zones out of a
  300-type catalog.  Instance-creation latency is *modeled* (calibrated
  to paper Fig. 2: roughly constant per request batch) and reported, not
  slept, unless ``latency_scale > 0``.
* ``TPUSliceProvider`` — the same interface offering TPU v5e slices
  (the converged-computing analogue: burst a training job to more chips).

Zone vertices are interposed between the cluster and node vertices
(paper Section 4), enabling location-aware scheduling of the returned
resources.

A copy of ``repro/core/external.py`` with one change: a provisioned
subgraph is built on the host (``ResourceGraph("cpu")``). It is only
spliced into the scheduler's graph, vertex by vertex, and never gets a
flat mirror of its own, so it needs no card.
"""
from __future__ import annotations

import itertools
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .graph import ResourceGraph, Vertex
from .jobspec import Jobspec, ResourceReq


@dataclass(frozen=True)
class InstanceType:
    name: str
    cpus: int
    memory_gb: int
    gpus: int

    def subgraph_size(self) -> int:
        """|V|+|E| of one instance's subgraph: node + per-cpu core +
        per-GB memory + per-gpu vertices, each with one containment edge
        (node itself has one edge to the zone).  Matches paper Table 3."""
        v = 1 + self.cpus + self.memory_gb + self.gpus
        return 2 * v


# Paper Table 3 catalog.
TABLE3_CATALOG: Dict[str, InstanceType] = {
    it.name: it
    for it in [
        InstanceType("t2.micro", 1, 1, 0),
        InstanceType("t2.small", 1, 2, 0),
        InstanceType("t2.medium", 2, 4, 0),
        InstanceType("t2.large", 2, 8, 0),
        InstanceType("t2.xlarge", 4, 16, 0),
        InstanceType("t2.2xlarge", 8, 32, 0),
        InstanceType("g2.2xlarge", 8, 15, 1),
        InstanceType("g3.4xlarge", 16, 128, 4),
    ]
}


def fleet_catalog(n_types: int = 300) -> Dict[str, InstanceType]:
    """A 300-type catalog (the paper lets AWS return any of 300 types)."""
    fams = ["m5", "m6i", "c5", "c6g", "r5", "r6i", "t3", "t3a", "i3", "d3",
            "x2", "z1d", "p3", "p4d", "g4dn", "g5", "inf1", "trn1", "h1", "a1"]
    sizes = [("medium", 1, 4), ("large", 2, 8), ("xlarge", 4, 16),
             ("2xlarge", 8, 32), ("4xlarge", 16, 64), ("8xlarge", 32, 128),
             ("12xlarge", 48, 192), ("16xlarge", 64, 256),
             ("24xlarge", 96, 384), ("32xlarge", 128, 512),
             ("metal", 96, 768), ("nano", 1, 1), ("micro", 1, 2),
             ("small", 1, 4), ("18xlarge", 72, 288)]
    cat: Dict[str, InstanceType] = dict(TABLE3_CATALOG)
    for fam, (size, cpu, mem) in itertools.product(fams, sizes):
        if len(cat) >= n_types:
            break
        name = f"{fam}.{size}"
        gpus = 4 if fam in ("p3", "p4d") else (1 if fam.startswith("g") else 0)
        cat.setdefault(name, InstanceType(name, cpu, mem, gpus))
    return dict(itertools.islice(cat.items(), n_types))


AWS_ZONES = [f"us-east-1{c}" for c in "abcdef"] + \
            [f"us-west-2{c}" for c in "abcd"] + \
            [f"eu-west-1{c}" for c in "abc"]


@dataclass
class ProvisionResult:
    """What the provider returns: the subgraph + latency accounting."""

    subgraph: ResourceGraph
    instance_names: List[str]
    modeled_latency_s: float      # provider-side creation time (modeled)
    encode_latency_s: float       # measured time to encode JGF


class ExternalProvider:
    """Interface: jobspec -> ProvisionResult (subgraph in JGF form)."""

    name = "abstract"

    def provision(self, jobspec: Jobspec, cluster_root: str) -> Optional[ProvisionResult]:
        raise NotImplementedError

    def release(self, instance_names: Sequence[str]) -> None:
        pass


class SimulatedEC2Provider(ExternalProvider):
    """The paper's EC2API against a simulated AWS endpoint.

    Latency model (calibrated to paper Fig. 2): instance creation takes
    ~11 s regardless of type or batch size (<=8); we model
    ``base + jitter`` and report it.  JGF-encoding overhead is *measured*
    (the paper reports it at ~1.6% of creation time).
    """

    name = "ec2"

    def __init__(self, catalog: Optional[Dict[str, InstanceType]] = None,
                 zones: Optional[List[str]] = None,
                 latency_scale: float = 0.0,
                 base_latency_s: float = 11.0,
                 jitter_s: float = 1.5,
                 seed: int = 0,
                 max_fleet_types: int = 300):
        self.catalog = catalog or fleet_catalog(300)
        self.zones = zones or list(AWS_ZONES)
        self.latency_scale = latency_scale
        self.base_latency_s = base_latency_s
        self.jitter_s = jitter_s
        self.max_fleet_types = max_fleet_types
        self._rng = random.Random(seed)
        self._count = itertools.count()
        self._live: Dict[str, str] = {}   # instance name -> zone

    # -------------------------------------------------------------- #
    def provision(self, jobspec: Jobspec, cluster_root: str) -> Optional[ProvisionResult]:
        attrs = jobspec.attributes
        if attrs.get("fleet") == "true":
            return self._provision_fleet(jobspec, cluster_root)
        return self._provision_instances(jobspec, cluster_root)

    def _pick_type_for(self, req: ResourceReq) -> Optional[InstanceType]:
        """Map a jobspec resource request onto an instance type."""
        want = req.properties.get("instance_type")
        if want is not None:
            return self.catalog.get(want)
        # generic request: find the smallest type covering the nested ask
        def tally(reqs, mult=1):
            c = g = m = 0
            for w in reqs:
                if w.type == "core":
                    c += mult * w.count
                elif w.type == "gpu":
                    g += mult * w.count
                elif w.type == "memory":
                    m += mult * w.count * w.size
                cc, gg, mm = tally(w.with_, mult * w.count)
                c, g, m = c + cc, g + gg, m + mm
            return c, g, m
        cores, gpus, mem = tally(req.with_)
        cores = cores or 1
        best = None
        for it in self.catalog.values():
            if it.cpus >= cores and it.gpus >= gpus and it.memory_gb >= mem:
                if best is None or (it.cpus, it.memory_gb, it.gpus) < \
                        (best.cpus, best.memory_gb, best.gpus):
                    best = it
        return best

    def _provision_instances(self, jobspec: Jobspec,
                             cluster_root: str) -> Optional[ProvisionResult]:
        picks: List[InstanceType] = []
        for req in jobspec.resources:
            if req.type != "node":
                # generic sub-node request (cores/gpus/...): wrap it in
                # a synthetic node request and pick a covering instance
                req = ResourceReq("node", 1, with_=[req])
            it = self._pick_type_for(req)
            if it is None:
                return None
            picks.extend([it] * req.count)
        return self._materialize(picks, cluster_root)

    def _provision_fleet(self, jobspec: Jobspec,
                         cluster_root: str) -> Optional[ProvisionResult]:
        allowed = jobspec.attributes.get("allowed_types")
        names = list(self.catalog)
        if allowed:
            names = [n for n in allowed.split(",") if n in self.catalog]
        if len(names) > self.max_fleet_types:
            # the AWS API returns an error if >300 types are specified
            raise ValueError(
                f"fleet request specifies {len(names)} instance types; "
                f"the provider supports at most {self.max_fleet_types}")
        count = sum(r.count for r in jobspec.resources)
        picks = [self.catalog[self._rng.choice(names)] for _ in range(count)]
        return self._materialize(picks, cluster_root)

    # -------------------------------------------------------------- #
    def _materialize(self, picks: List[InstanceType],
                     cluster_root: str) -> ProvisionResult:
        modeled = self.base_latency_s + self._rng.uniform(0, self.jitter_s)
        if self.latency_scale > 0:
            time.sleep(modeled * self.latency_scale)
        t0 = time.perf_counter()
        sub = ResourceGraph("cpu")
        root = cluster_root or "/ec2"
        sub.add_vertex(Vertex(type="cluster", name=root.strip("/"), path=root))
        names: List[str] = []
        for it in picks:
            zone = self._rng.choice(self.zones)
            zpath = f"{root}/{zone}"
            if zpath not in sub:
                sub.add_vertex(Vertex(type="zone", name=zone, path=zpath,
                                      properties={"provider": "aws"}))
                sub.add_edge(root, zpath)
            idx = next(self._count)
            iname = f"{it.name.replace('.', '-')}-{idx}"
            npath = f"{zpath}/{iname}"
            sub.add_vertex(Vertex(
                type="node", name=iname, path=npath,
                properties={"instance_type": it.name, "zone": zone,
                            "provider": "aws"}))
            sub.add_edge(zpath, npath)
            for c in range(it.cpus):
                p = f"{npath}/core{c}"
                sub.add_vertex(Vertex(type="core", name=f"core{c}", path=p))
                sub.add_edge(npath, p)
            for g in range(it.gpus):
                p = f"{npath}/gpu{g}"
                sub.add_vertex(Vertex(type="gpu", name=f"gpu{g}", path=p))
                sub.add_edge(npath, p)
            for m in range(it.memory_gb):
                p = f"{npath}/memory{m}"
                sub.add_vertex(Vertex(type="memory", name=f"memory{m}", path=p))
                sub.add_edge(npath, p)
            names.append(iname)
            self._live[iname] = zone
        sub.init_aggregates()
        # measured encode cost (JGF round trip, like the paper's EC2 plugin)
        _ = sub.to_jgf_bytes()
        encode = time.perf_counter() - t0
        return ProvisionResult(subgraph=sub, instance_names=names,
                               modeled_latency_s=modeled,
                               encode_latency_s=encode)

    def release(self, instance_names: Sequence[str]) -> None:
        for n in instance_names:
            self._live.pop(n, None)


class TPUSliceProvider(ExternalProvider):
    """Converged-computing provider: on-demand TPU v5e slices.

    A slice request of ``nodes`` nodes × 4 chips returns a subgraph
    shaped like ``build_tpu_fleet`` output, so elastic training jobs can
    burst to more chips through the same ExternalAPI path as EC2.
    """

    name = "tpu"

    def __init__(self, chips_per_node: int = 4, latency_scale: float = 0.0,
                 base_latency_s: float = 45.0, seed: int = 0):
        self.chips_per_node = chips_per_node
        self.latency_scale = latency_scale
        self.base_latency_s = base_latency_s
        self._rng = random.Random(seed)
        self._count = itertools.count()

    def provision(self, jobspec: Jobspec, cluster_root: str) -> Optional[ProvisionResult]:
        nodes = 0
        for req in jobspec.resources:
            if req.type == "node":
                nodes += req.count
            elif req.type == "chip":
                nodes += -(-req.count // self.chips_per_node)
            elif req.type == "pod":
                nodes += req.count * 64   # v5e pod = 64 hosts x 4 chips
        if nodes <= 0:
            return None
        modeled = self.base_latency_s * (1.0 + 0.1 * self._rng.random())
        if self.latency_scale > 0:
            time.sleep(modeled * self.latency_scale)
        t0 = time.perf_counter()
        root = cluster_root or "/tpu"
        sub = ResourceGraph("cpu")
        sub.add_vertex(Vertex(type="cluster", name=root.strip("/"), path=root))
        sid = next(self._count)
        spath = f"{root}/slice{sid}"
        sub.add_vertex(Vertex(type="slice", name=f"slice{sid}", path=spath,
                              properties={"provider": "tpu-cloud"}))
        sub.add_edge(root, spath)
        names = []
        for n in range(nodes):
            npath = f"{spath}/node{n}"
            sub.add_vertex(Vertex(type="node", name=f"node{n}", path=npath,
                                  properties={"provider": "tpu-cloud"}))
            sub.add_edge(spath, npath)
            names.append(f"slice{sid}/node{n}")
            for c in range(self.chips_per_node):
                cpath = f"{npath}/chip{c}"
                sub.add_vertex(Vertex(type="chip", name=f"chip{c}", path=cpath))
                sub.add_edge(npath, cpath)
        sub.init_aggregates()
        _ = sub.to_jgf_bytes()
        encode = time.perf_counter() - t0
        return ProvisionResult(subgraph=sub, instance_names=names,
                               modeled_latency_s=modeled,
                               encode_latency_s=encode)
