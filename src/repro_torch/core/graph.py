"""Dynamic directed resource graph with path indexing and JGF serialization.

This module implements the paper's core data model: a dynamic, directed
resource graph (Section 3).  Key properties reproduced from the paper:

* **Path indexing** — vertices are indexed by their containment path
  (e.g. ``/cluster0/node3/socket1/core12``), so the attach point of a
  subgraph is located in O(1) ("localization").
* **Local metadata aggregates** — each vertex only stores metadata about
  itself and aggregate quantities of the subtree rooted at it (free counts
  per resource type, used as pruning filters).  Attaching a subgraph only
  requires updating the subgraph itself plus its ``p`` ancestors:
  ``AddSubgraph`` is O(n+m) and ``UpdateMetadata`` is O(n+m+p).
* **JGF serialization** — subgraphs are exchanged between scheduler levels
  (and with external providers) in JSON Graph Format.

The containment hierarchy is a tree (the paper assumes a tree topology for
the scheduling hierarchy and resource graphs).

A copy of ``repro/core/graph.py`` with one change: a graph carries a
``device`` (``"cuda"`` by default, resolved by ``device.resolve_device``).
The dict graph itself stays on the host; the device is where its flat
mirror (``flat()``) runs the aggregate sweep and the feasibility kernel.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple, Union

import torch

from ..device import resolve_device

# Resource states.
UP = "up"
DOWN = "down"

# Containment edge subsystem name (Fluxion uses "containment").
CONTAINMENT = "containment"

# Jobid prefix marking delegation rather than a live workload: a parent
# that hands a subtree to a child instance marks the vertices allocated
# to a jobid starting with this prefix ("delegated", "delegated-to-X").
# Sibling reclaim may displace delegation markers but never a real job.
DELEGATION_PREFIX = "delegated"


@dataclass(slots=True)
class Vertex:
    """A resource vertex.

    ``agg_free`` is the *pruning-filter* aggregate: for each resource type,
    the number of free (unallocated, up) vertices of that type in the
    subtree rooted here, **including** this vertex.  This is the
    generalization of Fluxion's ``ALL:core`` pruning filter to all types.
    (``slots=True``: attribute access dominates the matcher's inner loop.)
    """

    type: str
    name: str
    path: str
    id: int = -1
    size: int = 1
    rank: int = -1
    status: str = UP
    properties: Dict[str, str] = field(default_factory=dict)
    # jobid -> units allocated (exclusive allocation: size units)
    allocations: Dict[str, int] = field(default_factory=dict)
    # pruning filter aggregates: type -> free count in subtree (inclusive)
    agg_free: Dict[str, int] = field(default_factory=dict)

    @property
    def basename(self) -> str:
        return self.path.rsplit("/", 1)[-1]

    @property
    def allocated(self) -> bool:
        return bool(self.allocations)

    @property
    def free(self) -> bool:
        return not self.allocations and self.status == UP

    def to_meta(self) -> Dict:
        """Compact JGF metadata: default-valued fields are omitted
        (halves the wire size — §Perf control-plane optimization)."""
        meta: Dict = {
            "type": self.type,
            "paths": {CONTAINMENT: self.path},
        }
        if self.name and self.name != self.basename:
            meta["name"] = self.name
        if self.id >= 0:
            meta["id"] = self.id
        if self.size != 1:
            meta["size"] = self.size
        if self.rank >= 0:
            meta["rank"] = self.rank
        if self.status != UP:
            meta["status"] = self.status
        if self.properties:
            meta["properties"] = dict(self.properties)
        if self.allocations:
            meta["allocations"] = dict(self.allocations)
        return meta

    @classmethod
    def from_meta(cls, meta: Dict) -> "Vertex":
        path = meta["paths"][CONTAINMENT]
        return cls(
            type=meta["type"],
            name=meta.get("name") or path.rsplit("/", 1)[-1],
            path=path,
            id=meta.get("id", -1),
            size=meta.get("size", 1),
            rank=meta.get("rank", -1),
            status=meta.get("status", UP),
            properties=dict(meta.get("properties", ())) if "properties" in meta else {},
            allocations=dict(meta.get("allocations", ())) if "allocations" in meta else {},
        )


class ResourceGraph:
    """A dynamic, path-indexed directed resource graph (tree containment).

    Vertices are indexed by path; edges are parent->child containment
    edges.  The graph supports O(n+m) subgraph addition/removal with
    O(n+m+p) metadata update (p = number of ancestors of the attach
    point) — the paper's "localization" technique.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda") -> None:
        self.device = resolve_device(device)
        self._v: Dict[str, Vertex] = {}
        self._children: Dict[str, List[str]] = {}
        self._parent: Dict[str, Optional[str]] = {}
        self._by_type: Dict[str, Set[str]] = {}
        self._next_id = 0
        self.roots: List[str] = []
        # flat-array mirror (core/flatgraph.py), attached lazily by
        # flat(); every mutation primitive notifies it so it stays
        # incrementally consistent — no full rebuilds under churn.
        self._flat = None
        # bumped by every match-relevant mutation (structure, free
        # flips, status flips).  Equal versions guarantee equal match
        # results, so queues can memoize failed matches between graph
        # events instead of re-running the same failing DFS.
        self.version = 0
        # counts init_aggregates() full rebuilds; the churn property
        # tests assert this stays frozen across alloc/release/splice/
        # revoke (rebuilds are a build-time-only cost).
        self.n_agg_rebuilds = 0

    def flat(self):
        """The flat-array mirror of this graph (built on first use,
        maintained incrementally afterwards).  See ``core/flatgraph``."""
        if self._flat is None:
            from .flatgraph import FlatGraph
            self._flat = FlatGraph(self, self.device)
        return self._flat

    # ------------------------------------------------------------------ #
    # basic accessors
    # ------------------------------------------------------------------ #
    def __contains__(self, path: str) -> bool:
        return path in self._v

    def __len__(self) -> int:
        return len(self._v)

    @property
    def num_vertices(self) -> int:
        return len(self._v)

    @property
    def num_edges(self) -> int:
        return sum(len(c) for c in self._children.values())

    @property
    def size(self) -> int:
        """Graph size = |V| + |E| (the paper's 'graph size' metric)."""
        return self.num_vertices + self.num_edges

    def vertex(self, path: str) -> Vertex:
        return self._v[path]

    def get(self, path: str) -> Optional[Vertex]:
        return self._v.get(path)

    def children(self, path: str) -> List[str]:
        return self._children.get(path, [])

    def parent(self, path: str) -> Optional[str]:
        return self._parent.get(path)

    def vertices(self) -> Iterator[Vertex]:
        return iter(self._v.values())

    def paths(self) -> Iterable[str]:
        return self._v.keys()

    def by_type(self, type_: str) -> Set[str]:
        return self._by_type.get(type_, set())

    def edges(self) -> Iterator[Tuple[str, str]]:
        for src, kids in self._children.items():
            for dst in kids:
                yield (src, dst)

    def ancestors(self, path: str) -> Iterator[str]:
        """Yield ancestor paths from immediate parent to root."""
        p = self._parent.get(path)
        while p is not None:
            yield p
            p = self._parent.get(p)

    def subtree(self, path: str) -> Iterator[str]:
        """DFS over the subtree rooted at ``path`` (inclusive)."""
        stack = [path]
        while stack:
            cur = stack.pop()
            yield cur
            stack.extend(self._children.get(cur, ()))

    # ------------------------------------------------------------------ #
    # primitive edits (graph library native functions of Algorithm 1)
    # ------------------------------------------------------------------ #
    def add_vertex(self, v: Vertex) -> Vertex:
        if v.path in self._v:
            return self._v[v.path]  # addition is the identity if it exists
        if v.id < 0:
            v.id = self._next_id
        self._next_id = max(self._next_id, v.id + 1)
        self._v[v.path] = v
        self._children.setdefault(v.path, [])
        self._by_type.setdefault(v.type, set()).add(v.path)
        if v.path not in self._parent:
            self._parent[v.path] = None
            self.roots.append(v.path)
        # own contribution to pruning aggregate
        v.agg_free = {v.type: 1 if v.free else 0}
        self.version += 1
        if self._flat is not None:
            self._flat.on_add(v)
        return v

    def add_edge(self, src: str, dst: str) -> None:
        kids = self._children.setdefault(src, [])
        if dst in kids:
            return  # identity
        kids.append(dst)
        if self._parent.get(dst) is None and dst in self.roots:
            self.roots.remove(dst)
        self._parent[dst] = src
        self.version += 1
        if self._flat is not None:
            self._flat.on_edge(src, dst)

    def remove_vertex(self, path: str) -> None:
        v = self._v.pop(path, None)
        if v is None:
            return
        self.version += 1
        if self._flat is not None:
            self._flat.on_remove(path)
        self._by_type.get(v.type, set()).discard(path)
        par = self._parent.pop(path, None)
        if par is not None and par in self._children:
            try:
                self._children[par].remove(path)
            except ValueError:
                pass
        for child in self._children.pop(path, []):
            self._parent[child] = None
            self.roots.append(child)
        if path in self.roots:
            self.roots.remove(path)

    # ------------------------------------------------------------------ #
    # pruning-filter metadata (localized updates)
    # ------------------------------------------------------------------ #
    def init_aggregates(self) -> None:
        """(Re)build subtree free-count aggregates bottom-up in O(n).

        Build-time only: the dynamic paths (alloc/release/splice/
        revoke) maintain aggregates via localized ``_bubble`` deltas —
        ``n_agg_rebuilds`` makes any hot-path regression visible."""
        self.n_agg_rebuilds += 1
        # post-order: children before parents
        order: List[str] = []
        for root in self.roots:
            order.extend(self.subtree(root))
        for path in reversed(order):
            v = self._v[path]
            agg: Dict[str, int] = {v.type: 1 if v.free else 0}
            for c in self._children.get(path, ()):
                for t, n in self._v[c].agg_free.items():
                    agg[t] = agg.get(t, 0) + n
            v.agg_free = agg
        if self._flat is not None:
            self._flat.on_rebuild()

    def _bubble(self, path: str, delta: Dict[str, int]) -> int:
        """Apply ``delta`` to the aggregates of ``path``'s ancestors.

        Returns the number of ancestors updated (the ``p`` of O(n+m+p)).
        """
        p = 0
        for anc in self.ancestors(path):
            agg = self._v[anc].agg_free
            for t, n in delta.items():
                agg[t] = agg.get(t, 0) + n
            p += 1
        return p

    def set_allocated(self, paths: Iterable[str], jobid: str) -> None:
        """Mark vertices allocated and update aggregates (localized)."""
        # group delta per vertex, bubble once per disjoint subtree root
        touched: Dict[str, Dict[str, int]] = {}
        pset = set(paths)
        for path in pset:
            v = self._v[path]
            was_free = v.free
            v.allocations[jobid] = v.size
            if was_free:
                v.agg_free[v.type] = v.agg_free.get(v.type, 1) - 1
                touched[path] = {v.type: -1}
                if self._flat is not None:
                    self._flat.on_flip(path, v)
        if touched:
            self.version += 1
        self._bubble_group(touched, pset)

    def set_free(self, paths: Iterable[str], jobid: str) -> None:
        touched: Dict[str, Dict[str, int]] = {}
        pset = set(paths)
        for path in pset:
            v = self._v.get(path)
            if v is None:
                continue
            was_allocated = jobid in v.allocations
            v.allocations.pop(jobid, None)
            if was_allocated and v.free:
                v.agg_free[v.type] = v.agg_free.get(v.type, 0) + 1
                touched[path] = {v.type: +1}
                if self._flat is not None:
                    self._flat.on_flip(path, v)
        if touched:
            self.version += 1
        self._bubble_group(touched, pset)

    def set_status(self, path: str, status: str) -> None:
        """Flip a vertex's UP/DOWN status with a localized aggregate
        update (the fault path: a DOWN vertex leaves the pruning
        aggregates immediately, so matchers never descend toward it)."""
        v = self._v.get(path)
        if v is None or v.status == status:
            return
        was = v.free
        v.status = status
        if was != v.free:
            d = 1 if v.free else -1
            v.agg_free[v.type] = v.agg_free.get(v.type, 0) + d
            self._bubble(path, {v.type: d})
            self.version += 1
            if self._flat is not None:
                self._flat.on_flip(path, v)

    def reassign(self, paths: Iterable[str], jobid: str) -> None:
        """Hand vertices over to ``jobid``.

        Used when a parent re-routes resources between child subtrees
        (sibling reclaim).  Free vertices go through the normal
        aggregate-updating allocation.  Already-allocated vertices are
        rebound in place (allocated before and after, so the pruning
        aggregates are unchanged) — but only *delegation markers*
        (jobids starting with ``DELEGATION_PREFIX``) are displaced; a
        binding to a live job is never stolen: the new jobid is added
        alongside, keeping both owners' release bookkeeping intact and
        the conflict visible.  Paths absent from this graph are ignored
        — a donor's external resources need not exist here.
        """
        present = [p for p in paths if p in self._v]
        self.set_allocated([p for p in present if self._v[p].free], jobid)
        for p in present:
            v = self._v[p]
            if jobid not in v.allocations:
                for owner in [j for j in v.allocations
                              if j.startswith(DELEGATION_PREFIX)]:
                    del v.allocations[owner]
                v.allocations[jobid] = v.size

    def _bubble_group(self, touched: Dict[str, Dict[str, int]], group: Set[str]) -> None:
        """Bubble per-vertex deltas: internal ancestors within ``group`` are
        updated in one pass, external ancestors get the summed delta so the
        total work is O(n + p) rather than O(n·p)."""
        if not touched:
            return
        # accumulate deltas up within the touched set first
        total_external: Dict[str, Dict[str, int]] = {}
        for path, delta in touched.items():
            # walk up while ancestors are inside the group
            cur = self._parent.get(path)
            while cur is not None and cur in group:
                agg = self._v[cur].agg_free
                for t, n in delta.items():
                    agg[t] = agg.get(t, 0) + n
                cur = self._parent.get(cur)
            if cur is not None:
                ext = total_external.setdefault(cur, {})
                for t, n in delta.items():
                    ext[t] = ext.get(t, 0) + n
        for anchor, delta in total_external.items():
            agg = self._v[anchor].agg_free
            for t, n in delta.items():
                agg[t] = agg.get(t, 0) + n
            self._bubble(anchor, delta)

    # ------------------------------------------------------------------ #
    # subgraph extraction
    # ------------------------------------------------------------------ #
    def extract(self, paths: Iterable[str], include_ancestors: bool = True) -> "ResourceGraph":
        """Extract the subgraph induced by ``paths`` (plus, optionally, the
        ancestor spine up to the root so the receiver can attach it)."""
        keep: Set[str] = set(paths)
        if include_ancestors:
            extra: Set[str] = set()
            for p in keep:
                for anc in self.ancestors(p):
                    if anc in keep or anc in extra:
                        break
                    extra.add(anc)
            keep |= extra
        sub = ResourceGraph(self.device)
        for path in sorted(keep, key=lambda s: s.count("/")):
            src = self._v[path]
            sub.add_vertex(
                Vertex(
                    type=src.type, name=src.name, path=src.path, id=src.id,
                    size=src.size, rank=src.rank, status=src.status,
                    properties=dict(src.properties),
                    allocations=dict(src.allocations),
                )
            )
        for path in keep:
            par = self._parent.get(path)
            if par is not None and par in keep:
                sub.add_edge(par, path)
        sub.init_aggregates()
        return sub

    def extent_size(self, paths: Iterable[str],
                    include_ancestors: bool = True) -> int:
        """|V|+|E| of the subgraph :meth:`extract` would build, without
        building it — the matched-subgraph-size accounting for grows
        that skip encoding."""
        keep: Set[str] = set(paths)
        if include_ancestors:
            extra: Set[str] = set()
            for p in keep:
                for anc in self.ancestors(p):
                    if anc in keep or anc in extra:
                        break
                    extra.add(anc)
            keep |= extra
        edges = sum(1 for p in keep if self._parent.get(p) in keep)
        return len(keep) + edges

    # ------------------------------------------------------------------ #
    # JGF serialization
    # ------------------------------------------------------------------ #
    def to_jgf(self) -> Dict:
        nodes = [{"id": str(v.id), "metadata": v.to_meta()} for v in self._v.values()]
        edges = [
            {
                "source": str(self._v[s].id),
                "target": str(self._v[t].id),
                "metadata": {"subsystem": CONTAINMENT},
            }
            for s, t in self.edges()
        ]
        return {"graph": {"nodes": nodes, "edges": edges}}

    def to_jgf_bytes(self) -> bytes:
        return json.dumps(self.to_jgf(), separators=(",", ":")).encode()

    @classmethod
    def from_jgf(cls, jgf: Dict, init_aggs: bool = True,
                 device: Union[str, torch.device] = "cuda") -> "ResourceGraph":
        """``init_aggs=False`` skips the aggregate rebuild — transport
        paths that immediately AddSubgraph into another graph recompute
        aggregates there anyway (§Perf control-plane optimization)."""
        g = cls(device)
        id2path: Dict[str, str] = {}
        for node in jgf["graph"]["nodes"]:
            v = Vertex.from_meta(node["metadata"])
            id2path[node["id"]] = v.path
            g.add_vertex(v)
        for edge in jgf["graph"].get("edges", []):
            g.add_edge(id2path[edge["source"]], id2path[edge["target"]])
        if init_aggs:
            g.init_aggregates()
        return g

    @classmethod
    def from_jgf_bytes(cls, data: bytes, init_aggs: bool = True,
                       device: Union[str, torch.device] = "cuda") -> "ResourceGraph":
        return cls.from_jgf(json.loads(data), init_aggs=init_aggs, device=device)

    # ------------------------------------------------------------------ #
    # misc
    # ------------------------------------------------------------------ #
    def counts_by_type(self) -> Dict[str, int]:
        return {t: len(ps) for t, ps in self._by_type.items() if ps}

    def validate_tree(self) -> bool:
        """Invariant check: containment is a forest and aggregates match."""
        seen: Set[str] = set()
        for root in self.roots:
            for p in self.subtree(root):
                if p in seen:
                    return False
                seen.add(p)
        if seen != set(self._v):
            return False
        for root in self.roots:
            if not self._check_agg(root):
                return False
        return True

    def _check_agg(self, path: str) -> bool:
        v = self._v[path]
        expect: Dict[str, int] = {v.type: 1 if v.free else 0}
        ok = True
        for c in self._children.get(path, ()):
            ok &= self._check_agg(c)
            for t, n in self._v[c].agg_free.items():
                expect[t] = expect.get(t, 0) + n
        mine = {t: n for t, n in v.agg_free.items() if n != 0}
        expect = {t: n for t, n in expect.items() if n != 0}
        return ok and mine == expect

    def is_subgraph_of(self, other: "ResourceGraph") -> bool:
        """Subgraph-inclusion test (paper's partial ordering G_c ⊆ G_p)."""
        for path in self._v:
            if path not in other._v:
                return False
        for s, t in self.edges():
            if other._parent.get(t) != s:
                return False
        return True


# ---------------------------------------------------------------------- #
# graph builders
# ---------------------------------------------------------------------- #
def build_cluster(
    name: str = "cluster0",
    nodes: int = 4,
    sockets_per_node: int = 2,
    cores_per_socket: int = 16,
    gpus_per_socket: int = 0,
    mem_per_socket: int = 0,
    node_prefix: str = "node",
    rank_offset: int = 0,
    device: Union[str, torch.device] = "cuda",
) -> ResourceGraph:
    """Build an HPC cluster resource graph (paper Tables 1-2 shapes)."""
    g = ResourceGraph(device)
    root = f"/{name}"
    g.add_vertex(Vertex(type="cluster", name=name, path=root))
    for n in range(nodes):
        npath = f"{root}/{node_prefix}{n}"
        g.add_vertex(Vertex(type="node", name=f"{node_prefix}{n}", path=npath,
                            rank=rank_offset + n))
        g.add_edge(root, npath)
        for s in range(sockets_per_node):
            spath = f"{npath}/socket{s}"
            g.add_vertex(Vertex(type="socket", name=f"socket{s}", path=spath))
            g.add_edge(npath, spath)
            for c in range(cores_per_socket):
                cpath = f"{spath}/core{c}"
                g.add_vertex(Vertex(type="core", name=f"core{c}", path=cpath))
                g.add_edge(spath, cpath)
            for u in range(gpus_per_socket):
                upath = f"{spath}/gpu{u}"
                g.add_vertex(Vertex(type="gpu", name=f"gpu{u}", path=upath))
                g.add_edge(spath, upath)
            for m in range(mem_per_socket):
                mpath = f"{spath}/memory{m}"
                g.add_vertex(Vertex(type="memory", name=f"memory{m}",
                                    path=mpath))
                g.add_edge(spath, mpath)
    g.init_aggregates()
    return g


def build_tpu_fleet(
    name: str = "fleet0",
    pods: int = 2,
    racks_per_pod: int = 4,
    nodes_per_rack: int = 16,
    chips_per_node: int = 4,
    device: Union[str, torch.device] = "cuda",
) -> ResourceGraph:
    """Build a TPU training-fleet resource graph: cluster→pod→rack→node→chip.

    Default: 2 pods × 4 racks × 16 nodes × 4 chips = 256 chips/pod (v5e pod).
    """
    g = ResourceGraph(device)
    root = f"/{name}"
    g.add_vertex(Vertex(type="cluster", name=name, path=root))
    for p in range(pods):
        ppath = f"{root}/pod{p}"
        g.add_vertex(Vertex(type="pod", name=f"pod{p}", path=ppath))
        g.add_edge(root, ppath)
        for r in range(racks_per_pod):
            rpath = f"{ppath}/rack{r}"
            g.add_vertex(Vertex(type="rack", name=f"rack{r}", path=rpath))
            g.add_edge(ppath, rpath)
            for n in range(nodes_per_rack):
                npath = f"{rpath}/node{n}"
                g.add_vertex(Vertex(type="node", name=f"node{n}", path=npath,
                                    rank=((p * racks_per_pod + r) * nodes_per_rack + n)))
                g.add_edge(rpath, npath)
                for c in range(chips_per_node):
                    cpath = f"{npath}/chip{c}"
                    g.add_vertex(Vertex(type="chip", name=f"chip{c}", path=cpath))
                    g.add_edge(npath, cpath)
    g.init_aggregates()
    return g
