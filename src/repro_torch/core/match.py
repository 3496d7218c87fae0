"""Resource matcher: depth-first traversal with pruning filters.

MATCHALLOCATE's matching stage.  The traversal is pruned using the
per-vertex subtree free-count aggregates maintained by ``ResourceGraph``
(the analogue of Fluxion's ``ALL:core`` pruning filter): a subtree is
never entered if it cannot possibly satisfy the remaining request, so
allocated subtrees are skipped (paper Section 5.2.3).

By default matching runs on the graph's flat-array mirror
(``core/flatgraph.FlatMatcher``) — same traversal, same claims, same
result, via contiguous arrays and a vectorized feasibility prefilter.
The dict DFS below remains the oracle: ``Matcher(g, use_flat=False)``
(or env ``CONVERGED_FLAT_MATCH=0``) forces it, and the tier-1 suite
asserts both return identical matches.
"""
from __future__ import annotations

from typing import List, Optional, Set

from .graph import ResourceGraph, Vertex
from .jobspec import Jobspec, ResourceReq


class Matcher:
    """DFS matcher over a ResourceGraph."""

    def __init__(self, graph: ResourceGraph,
                 use_flat: Optional[bool] = None):
        self.g = graph
        # visit statistics, useful for verifying pruning behaviour
        self.visited = 0
        self._auto = use_flat is None
        if use_flat is None:
            from .flatgraph import FLAT_MIN_VERTICES, flat_enabled
            # small graphs match faster through the dict DFS than the
            # flat path's fixed per-match setup; the cutoff re-evaluates
            # per Matcher, so a graph that grows past it switches over
            use_flat = (flat_enabled()
                        and graph.num_vertices >= FLAT_MIN_VERTICES)
        self.use_flat = use_flat

    # ------------------------------------------------------------------ #
    def match(self, jobspec: Jobspec) -> Optional[List[str]]:
        """Return the list of matched vertex paths, or None.

        Matching is exclusive: a matched vertex must be free, and all
        vertices named by the (nested) request under it are claimed.
        """
        use_flat = self.use_flat
        if use_flat and self._auto:
            # auto dispatch also weighs the request: a small request on
            # a big graph rides the pruned dict spine in microseconds,
            # under the flat path's per-match setup cost
            from .flatgraph import FLAT_REQ_RATIO
            use_flat = (jobspec.graph_size() * FLAT_REQ_RATIO
                        >= self.g.num_vertices)
        if use_flat:
            from .flatgraph import FlatMatcher
            fm = FlatMatcher(self.g.flat())
            got = fm.match(jobspec)
            self.visited = fm.visited
            return got
        self.visited = 0
        matched: List[str] = []
        claimed: Set[str] = set()
        for req in jobspec.resources:
            found = False
            for root in self.g.roots:
                got = self._match_count(root, req, claimed)
                if got is not None:
                    matched.extend(got)
                    found = True
                    break
            if not found:
                return None
        return matched

    # ------------------------------------------------------------------ #
    @staticmethod
    def _prune(v: Vertex, req: ResourceReq, needed: int) -> bool:
        """True if the subtree at ``v`` cannot hold ``needed`` free
        vertices of ``req.type`` (pruning filter).  Takes the Vertex
        the caller already holds — one dict lookup per visit, not two."""
        return v.agg_free.get(req.type, 0) < needed

    def _satisfies(self, v: Vertex, req: ResourceReq) -> bool:
        if v.type != req.type or not v.free:
            return False
        if v.size < req.size:
            return False
        for k, val in req.properties.items():
            if v.properties.get(k) != val:
                return False
        return True

    def _match_count(self, scope: str, req: ResourceReq,
                     claimed: Set[str]) -> Optional[List[str]]:
        """Find ``req.count`` matches of ``req`` within the subtree at
        ``scope``.  Returns claimed paths (and records them in ``claimed``)
        or None, leaving ``claimed`` untouched on failure."""
        got: List[str] = []
        local_claim: Set[str] = set()
        stack = [scope]
        need = req.count
        while stack and need > 0:
            path = stack.pop()
            if path in claimed or path in local_claim:
                continue
            self.visited += 1
            v = self.g.vertex(path)
            if self._prune(v, req, 1):
                continue  # no free req.type anywhere below — skip subtree
            if self._satisfies(v, req):
                sub = self._match_one(path, req, claimed, local_claim)
                if sub is not None:
                    got.extend(sub)
                    local_claim.update(sub)
                    need -= 1
                    continue  # exclusive: don't descend into a match
            stack.extend(self.g.children(path))
        if need > 0:
            return None
        claimed.update(local_claim)
        return got

    def _match_one(self, path: str, req: ResourceReq, claimed: Set[str],
                   local_claim: Set[str]) -> Optional[List[str]]:
        """Try to match ``req`` rooted exactly at ``path`` (which already
        satisfies type/free/properties), including nested requests."""
        sub: List[str] = [path]
        inner: Set[str] = set(local_claim)
        inner.add(path)
        for child_req in req.with_:
            got = self._match_count_under(path, child_req, claimed, inner)
            if got is None:
                return None
            sub.extend(got)
            inner.update(got)
        return sub

    def _match_count_under(self, scope: str, req: ResourceReq,
                           claimed: Set[str], inner: Set[str]) -> Optional[List[str]]:
        got: List[str] = []
        need = req.count
        stack = list(self.g.children(scope))
        while stack and need > 0:
            path = stack.pop()
            if path in claimed or path in inner:
                continue
            self.visited += 1
            v = self.g.vertex(path)
            if self._prune(v, req, 1):
                continue
            if self._satisfies(v, req):
                sub = self._match_one_under(path, req, claimed, inner)
                if sub is not None:
                    got.extend(sub)
                    inner.update(sub)
                    need -= 1
                    continue
            stack.extend(self.g.children(path))
        if need > 0:
            return None
        return got

    def _match_one_under(self, path: str, req: ResourceReq, claimed: Set[str],
                         inner: Set[str]) -> Optional[List[str]]:
        sub: List[str] = [path]
        nested: Set[str] = set(inner)
        nested.add(path)
        for child_req in req.with_:
            got = self._match_count_under(path, child_req, claimed, nested)
            if got is None:
                return None
            sub.extend(got)
            nested.update(got)
        return sub
