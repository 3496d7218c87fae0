"""Graph transformations: AddSubgraph / RemoveSubgraph / UpdateMetadata.

These are the paper's primitive operations (Section 3, Algorithm 1):

* ``add_subgraph`` — splice a subgraph (received in JGF from a parent or
  an external provider) into the local resource graph.  Uses the path
  index to locate the attach point in O(1); total cost O(n+m) for a
  subgraph of n vertices and m edges.  Addition is the identity for
  vertices/edges that already exist.
* ``update_metadata`` — update scheduler state for the new subgraph:
  allocate its vertices to the growing job and refresh the pruning
  aggregates of the subgraph plus its p supergraph ancestors —
  O(n+m+p), never a global update ("localization").
* ``remove_subgraph`` — the subtractive transform, applied bottom-up.

Directionality (paper Section 3): an additive transformation invalidates
the *supergraph* inclusion subsequence and therefore propagates top-down;
a subtractive transformation invalidates the *subgraph* subsequence and
propagates bottom-up.  ``TransformKind`` records this.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from .graph import CONTAINMENT, ResourceGraph, Vertex


class TransformKind(enum.Enum):
    ADDITIVE = "additive"        # propagates top-down
    SUBTRACTIVE = "subtractive"  # propagates bottom-up

    @property
    def direction(self) -> str:
        return "top-down" if self is TransformKind.ADDITIVE else "bottom-up"


@dataclass
class TransformResult:
    """Accounting for one transform application (drives the cost model)."""

    kind: TransformKind
    added_vertices: int = 0
    added_edges: int = 0
    removed_vertices: int = 0
    removed_edges: int = 0
    ancestors_updated: int = 0   # the "p" of O(n+m+p)
    total_size: int = 0          # |V|+|E| of the incoming subgraph
    new_paths: List[str] = field(default_factory=list)

    @property
    def subgraph_size(self) -> int:
        return (self.added_vertices + self.added_edges
                + self.removed_vertices + self.removed_edges)


def add_subgraph(graph: ResourceGraph, sub: ResourceGraph,
                 adopt: bool = True) -> TransformResult:
    """Algorithm 1 AddSubgraph: splice ``sub`` into ``graph``.

    Vertices/edges already present are skipped (addition is the identity
    on existing elements).  Roots of ``sub`` that are not in ``graph``
    and have no incoming edge become new roots (external resources
    E_i = G_i \\ G_0).

    Traversal is the subgraph's own DFS (parents before children) — no
    sort, O(n+m).  With ``adopt=True`` (default) the incoming Vertex
    objects are inserted directly instead of copied: every caller hands
    us a freshly deserialized/extracted subgraph, so ownership transfer
    is safe and saves one dict-heavy copy per vertex.
    """
    res = TransformResult(kind=TransformKind.ADDITIVE)
    # DFS over sub's roots yields parents before children: insertion
    # order is already topological.
    for root in sub.roots:
        for path in sub.subtree(root):
            if path in graph:
                continue
            v = sub.vertex(path)
            if not adopt:
                v = Vertex(type=v.type, name=v.name, path=v.path, id=-1,
                           size=v.size, rank=v.rank, status=v.status,
                           properties=dict(v.properties),
                           allocations=dict(v.allocations))
            else:
                v.id = -1  # the receiving graph assigns ids
            graph.add_vertex(v)
            res.added_vertices += 1
            res.new_paths.append(v.path)
    for src, dst in sub.edges():
        if src in graph and dst in graph:
            if graph.parent(dst) != src:
                graph.add_edge(src, dst)
                res.added_edges += 1
    return res


def splice_jgf(graph: ResourceGraph, jgf: Dict) -> TransformResult:
    """Fused deserialize+AddSubgraph: parse a JGF payload straight into
    ``graph`` without materializing an intermediate ResourceGraph
    (§Perf control-plane optimization — one dict-build per vertex
    instead of three).  Returns a TransformResult whose ``total_size``
    is the |V|+|E| of the incoming subgraph (existing elements included,
    matching the paper's 'matched subgraph size' accounting)."""
    from .graph import Vertex as _V  # local import to avoid cycle noise
    res = TransformResult(kind=TransformKind.ADDITIVE)
    nodes = jgf["graph"]["nodes"]
    edges = jgf["graph"].get("edges", [])
    res.total_size = len(nodes) + len(edges)
    id2path: Dict[str, str] = {}
    depths_ok = True
    last_depth = -1
    for node in nodes:
        meta = node["metadata"]
        path = meta["paths"][CONTAINMENT] if isinstance(meta.get("paths"), dict) \
            else meta["paths"]
        id2path[node["id"]] = path
        if path in graph:
            continue
        v = _V.from_meta(meta)
        v.id = -1
        graph.add_vertex(v)
        res.added_vertices += 1
        res.new_paths.append(path)
        d = path.count("/")
        if d < last_depth:
            depths_ok = False
        last_depth = max(last_depth, d)
    if not depths_ok:   # foreign JGF with unordered nodes: restore order
        res.new_paths.sort(key=lambda s: s.count("/"))
    for edge in edges:
        src = id2path.get(edge["source"])
        dst = id2path.get(edge["target"])
        if src is not None and dst is not None and src in graph \
                and dst in graph and graph.parent(dst) != src:
            graph.add_edge(src, dst)
            res.added_edges += 1
    return res


def update_metadata(graph: ResourceGraph, res: TransformResult,
                    jobid: Optional[str] = None) -> TransformResult:
    """Algorithm 1 UpdateMetadata — localized scheduler-state update.

    Rebuilds the pruning aggregates for the newly added vertices and
    bubbles the delta up through the attach point's ancestors.  If
    ``jobid`` is given the new vertices are allocated to that job (the
    MATCHGROW semantic: new resources arrive already attached to the
    running allocation).
    """
    new = set(res.new_paths)
    if not new:
        return res
    if jobid is not None:
        graph.version += 1
        for path in res.new_paths:
            v = graph.vertex(path)
            v.allocations[jobid] = v.size
            if graph._flat is not None:
                graph._flat.on_flip(path, v)

    # Recompute aggregates bottom-up over the new subgraph only.
    # new_paths is in parent-before-child (DFS) order, so the reverse is
    # a valid children-first order — no sort needed (O(n), not O(n log n)).
    for path in reversed(res.new_paths):
        v = graph.vertex(path)
        agg: Dict[str, int] = {v.type: 1 if v.free else 0}
        for c in graph.children(path):
            for t, n in graph.vertex(c).agg_free.items():
                agg[t] = agg.get(t, 0) + n
        v.agg_free = agg

    # Bubble the delta from each attach root (new vertex whose parent is
    # pre-existing) up through its ancestors: O(p) per attach root.
    p_total = 0
    for path in res.new_paths:
        par = graph.parent(path)
        if par is not None and par not in new:
            delta = dict(graph.vertex(path).agg_free)
            p_total += graph._bubble(path, delta)
    res.ancestors_updated = p_total
    return res


def remove_subgraph(graph: ResourceGraph, paths: List[str],
                    jobid: Optional[str] = None) -> TransformResult:
    """Subtractive transform: remove ``paths`` (and their subtrees).

    Applied bottom-up (children before parents).  The pruning aggregates
    of the removed vertices' ancestors are decremented (localized).
    """
    res = TransformResult(kind=TransformKind.SUBTRACTIVE)
    # Expand to full subtrees, dedupe.
    doomed: Set[str] = set()
    for p in paths:
        if p in graph:
            doomed.update(graph.subtree(p))
    # Bubble negative deltas from each removal root before removal.
    roots = [p for p in doomed
             if graph.parent(p) is None or graph.parent(p) not in doomed]
    for r in roots:
        v = graph.vertex(r)
        delta = {t: -n for t, n in v.agg_free.items() if n}
        if delta:
            res.ancestors_updated += graph._bubble(r, delta)
    # bottom-up removal
    for p in sorted(doomed, key=lambda s: s.count("/"), reverse=True):
        v = graph.vertex(p)
        if jobid is not None:
            v.allocations.pop(jobid, None)
        res.removed_edges += (1 if graph.parent(p) is not None else 0)
        res.removed_edges += 0  # child edges removed with children first
        graph.remove_vertex(p)
        res.removed_vertices += 1
    return res
