"""Flat-array mirror of ``ResourceGraph`` + vectorized feasibility matcher.

The dict-graph (``core/graph.py``) is the source of truth for the
paper's dynamic resource model; its per-vertex ``agg_free`` dicts are
exact but slow to *traverse*: at request_size 4480 the DFS matcher pays
a string hash per visit plus an O(claimed) set copy per candidate
trial.  This module keeps a contiguous mirror of the same state —

* per-vertex columns: ``parent`` / ``type_id`` / ``free`` / ``size`` /
  property bitmask (numpy, capacity-doubled), children as int lists;
* a 2-D pruning aggregate ``agg[vertex, type]`` — the flat twin of
  ``Vertex.agg_free`` — maintained **incrementally** by
  dirty-propagation: allocation flips queue ``(vertex, type, ±1)``
  deltas that are bubbled up the ancestor chain in one vectorized
  ``np.add.at`` pass per tree level (never an ``init_aggregates()``
  style full dict rebuild); topology changes (splice / revoke /
  subtractive release) trigger one vectorized per-level aggregate
  sweep over the flat arrays instead;
* a vectorized feasibility prefilter (:func:`candidate_mask` /
  :meth:`FlatGraph.feasible_roots`) that evaluates type + free + size
  + property-mask + per-type subtree aggregates for *every* candidate
  vertex at once, so the DFS only descends into provably feasible
  subtrees — and failure ("nothing can match") is detected without
  entering the graph at all.

A copy of ``repro/core/flatgraph.py``. The host columns stay numpy, as
there (the DFS reads them as Python lists). The two device hooks run on
the graph's device in place of the ``use_jax`` dispatch: the per-level
aggregate sweep is one ``index_add_`` per tree level (:func:`aggregate_sweep`),
and :meth:`FlatGraph.feasible_roots_batch` goes to
``kernels/ops.py::batched_feasible_op`` (the CUDA feasibility kernel on a
card, its plain version on the CPU).

:class:`FlatMatcher` is a faithful port of the DFS in ``core/match.py``
to integer indices (same traversal order, same claim/rollback
semantics, via an undo journal instead of per-trial set copies), so the
flat and dict matchers return **identical** matches; the dict matcher
remains as the oracle (``Matcher(g, use_flat=False)``).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels.ops import batched_feasible_op
from .jobspec import Jobspec, ResourceReq

# vertices below this count: vectorized prefilters cost more than the
# plain int-DFS saves, so FlatMatcher skips them (the arrays are still
# what makes the DFS itself fast)
VECTOR_MIN_VERTICES = 192

# graphs below this count: the flat path's fixed per-match cost (sync,
# request compilation, column snapshots) exceeds what the dict DFS
# spends on the whole match, so ``Matcher`` keeps the dict path.  The
# measured crossover on build_cluster shapes is ~500 vertices.
FLAT_MIN_VERTICES = 512

# on the auto path, requests smaller than |V| / FLAT_REQ_RATIO also
# stay on the dict DFS: a small request on a big graph descends
# straight down the pruned spine in ~10us, well under the flat path's
# O(|V|) per-match column snapshots (~0.8ms at 2k vertices), while the
# dict DFS's per-trial set copies grow superlinearly with request
# size.  Measured crossovers: request ~400 at 2241 vertices, ~700-900
# at 4481 — i.e. request ~ |V| / 6.
FLAT_REQ_RATIO = 6

_NO_PROPS: Dict[str, str] = {}


# ---------------------------------------------------------------------- #
# per-level aggregate sweep on the graph's device
# ---------------------------------------------------------------------- #
def aggregate_sweep(own, parent, levels: Sequence,
                    device: Union[str, torch.device]) -> torch.Tensor:
    """Bottom-up subtree-sum over a forest, one tree level at a time.

    ``own[v, t]`` is vertex ``v``'s own contribution per type;
    ``parent[v]`` its parent index; ``levels`` lists vertex indices
    grouped by depth, root level first. Each may be a numpy array or a
    tensor, and is moved to ``device`` (no copy when it is there already:
    ``FlatGraph`` keeps its levels and parents on the device between
    structural changes). Returns ``agg`` on ``device`` with
    ``agg[v] = sum(own[u] for u in subtree(v))``: one ``index_add_`` per
    level, deepest first. The sums are integer, so the order in which the
    device adds them does not change the result.
    """
    dev = torch.device(device)
    agg = torch.as_tensor(own, device=dev).clone()
    par = torch.as_tensor(parent, device=dev)
    for lvl in reversed(levels[1:]):
        lvl = torch.as_tensor(lvl, device=dev)
        agg.index_add_(0, par[lvl], agg[lvl])
    return agg


def candidate_mask(type_id: np.ndarray, free: np.ndarray,
                   present: np.ndarray, size: np.ndarray,
                   prop_mask: np.ndarray, agg: np.ndarray,
                   tid: int, min_size: int, req_mask: int,
                   agg_need: Sequence[Tuple[int, int]]) -> np.ndarray:
    """Vectorized feasibility: True for vertices that satisfy the
    request root (type/free/size/properties) AND whose subtree
    aggregates cover every nested per-type requirement.  A necessary
    condition only — the DFS still verifies structure — so masking a
    vertex out never changes the match result."""
    m = (type_id == tid) & free & present
    if min_size > 1:
        m &= size >= min_size
    if req_mask:
        m &= (prop_mask & req_mask) == req_mask
    for t, n in agg_need:
        m &= agg[:, t] >= n
    return m


# ---------------------------------------------------------------------- #
# the flat mirror
# ---------------------------------------------------------------------- #
class FlatGraph:
    """Contiguous mirror of one ``ResourceGraph``.

    Attach via ``graph.flat()``; the graph's mutation primitives call
    the ``on_*`` hooks (O(1) each), and :meth:`sync` settles the
    queued dirty state vectorized before the next query.  The mirror
    never walks the dict graph after construction except to resync a
    row the hooks marked (there is no full dict rebuild on any alloc /
    release / splice / revoke path).
    """

    def __init__(self, graph, device: Union[str, torch.device]) -> None:
        self.g = graph
        self.device = torch.device(device)
        # perf counters (asserted by the churn property tests)
        self.n_builds = 0           # full builds incl. compactions
        self.n_agg_sweeps = 0       # vectorized struct-change sweeps
        self.n_bubbles = 0          # incremental dirty-propagations
        self.n_sync_fast = 0        # sync() calls short-circuited clean
        self._build()

    # -- construction --------------------------------------------------- #
    def _build(self) -> None:
        g = self.g
        self.n_builds += 1
        paths = list(g.paths())
        n = len(paths)
        cap = max(64, n + (n >> 1))
        self.n = n
        self.path: List[str] = paths
        self.idx: Dict[str, int] = {p: i for i, p in enumerate(paths)}
        self.types: List[str] = []
        self.tmap: Dict[str, int] = {}
        self.parent = np.full(cap, -1, np.int32)
        self.type_id = np.zeros(cap, np.int32)
        self.size = np.ones(cap, np.int32)
        self.free = np.zeros(cap, bool)
        self.present = np.zeros(cap, bool)
        self.prop_mask = np.zeros(cap, np.int64)
        self.children: List[List[int]] = [[] for _ in range(cap)]
        self.props: List[Dict[str, str]] = [_NO_PROPS] * cap
        self.prop_bit: Dict[Tuple[str, str], int] = {}
        self.prop_overflow = False
        self._tombs = 0
        self._pending: List[Tuple[int, int, int]] = []
        self._struct_dirty = True       # forces first sweep + level calc
        # vertex indices by depth and the parent column, on the device:
        # refreshed once per structural change, read by every sweep
        self._levels: List[torch.Tensor] = []
        self._parent_dev = torch.empty(0, dtype=torch.int32, device=self.device)
        # sync fast-path: graph.version at the last settle.  Every
        # mutation hook stamps it stale, so a clean sync() is one int
        # compare — a kick that syncs via the dispatcher, the matcher,
        # and feasible_roots settles exactly once.
        self._synced_version = -1
        # compiled-request cache.  Requests resolve against the type /
        # property-bit tables only, and those are grow-only between
        # full builds — so entries stay valid across graph.version
        # bumps (strictly better than keying on the version, which
        # would recompile every pending job each kick) and are
        # invalidated by table growth or a rebuild.
        self._req_cache: Dict[int, Tuple[ResourceReq, Tuple,
                                         "_CompiledReq"]] = {}
        idx = self.idx
        for i, p in enumerate(paths):
            v = g.vertex(p)
            self.type_id[i] = self._tid(v.type)
            self.size[i] = v.size
            self.free[i] = v.free
            self.present[i] = True
            if v.properties:
                self.props[i] = v.properties
                self.prop_mask[i] = self._mask_of(v.properties)
            par = g.parent(p)
            if par is not None:
                self.parent[i] = idx[par]
        ch = g._children
        self.children = [[idx[c] for c in ch.get(p, ())] for p in paths] \
            + [[] for _ in range(cap - n)]
        self.agg = np.zeros((cap, len(self.types)), np.int32)
        self.sync()

    def _tid(self, type_: str) -> int:
        t = self.tmap.get(type_)
        if t is None:
            t = self.tmap[type_] = len(self.types)
            self.types.append(type_)
            if hasattr(self, "agg") and self.agg.shape[1] < len(self.types):
                self.agg = np.pad(self.agg, ((0, 0), (0, 4)))
                self._struct_dirty = True
        return t

    def _mask_of(self, properties: Dict[str, str]) -> int:
        mask = 0
        for kv in properties.items():
            bit = self.prop_bit.get(kv)
            if bit is None:
                if len(self.prop_bit) >= 62:
                    # bitmask exhausted: keep exactness via the per-
                    # vertex dict check (FlatMatcher falls back)
                    self.prop_overflow = True
                    continue
                bit = self.prop_bit[kv] = 1 << len(self.prop_bit)
            mask |= bit
        return mask

    def _grow_rows(self) -> None:
        cap = max(64, self.n * 2)
        ext = cap - len(self.parent)
        if ext <= 0:
            return
        self.parent = np.concatenate(
            [self.parent, np.full(ext, -1, np.int32)])
        self.type_id = np.concatenate(
            [self.type_id, np.zeros(ext, np.int32)])
        self.size = np.concatenate([self.size, np.ones(ext, np.int32)])
        self.free = np.concatenate([self.free, np.zeros(ext, bool)])
        self.present = np.concatenate([self.present, np.zeros(ext, bool)])
        self.prop_mask = np.concatenate(
            [self.prop_mask, np.zeros(ext, np.int64)])
        self.agg = np.vstack(
            [self.agg, np.zeros((ext, self.agg.shape[1]), np.int32)])
        self.children.extend([] for _ in range(ext))
        self.props.extend([_NO_PROPS] * ext)

    # -- mutation hooks (called by ResourceGraph primitives) ------------ #
    def on_add(self, v) -> None:
        if self._tombs > 64 and self._tombs * 2 > self.n:
            self._build()       # amortized compaction
            return
        if self.n >= len(self.parent):
            self._grow_rows()
        i = self.n
        self.n += 1
        self.path.append(v.path)
        self.idx[v.path] = i
        self.type_id[i] = self._tid(v.type)
        self.size[i] = v.size
        self.free[i] = v.free
        self.present[i] = True
        self.parent[i] = -1
        self.children[i] = []
        if v.properties:
            self.props[i] = v.properties
            self.prop_mask[i] = self._mask_of(v.properties)
        else:
            self.props[i] = _NO_PROPS
            self.prop_mask[i] = 0
        self._struct_dirty = True
        self._synced_version = -1

    def on_edge(self, src: str, dst: str) -> None:
        s, d = self.idx[src], self.idx[dst]
        old = self.parent[d]
        if old == s:
            return
        if old >= 0:
            try:
                self.children[old].remove(d)
            except ValueError:
                pass
        self.parent[d] = s
        self.children[s].append(d)
        self._struct_dirty = True
        self._synced_version = -1

    def on_remove(self, path: str) -> None:
        i = self.idx.pop(path, None)
        if i is None:
            return
        par = self.parent[i]
        if par >= 0:
            try:
                self.children[par].remove(i)
            except ValueError:
                pass
        for c in self.children[i]:
            self.parent[c] = -1     # children become roots (dict semantics)
        self.children[i] = []
        self.parent[i] = -1
        self.present[i] = False
        self.free[i] = False
        self.props[i] = _NO_PROPS
        self._tombs += 1
        self._struct_dirty = True
        self._synced_version = -1

    def on_flip(self, path: str, v) -> None:
        """Own free-ness of ``path`` changed (alloc/release/status)."""
        i = self.idx.get(path)
        if i is None:
            return
        was = bool(self.free[i])
        now = v.free
        if was == now:
            return
        self.free[i] = now
        self._synced_version = -1
        if not self._struct_dirty:
            self._pending.append(
                (i, int(self.type_id[i]), 1 if now else -1))

    def on_rebuild(self) -> None:
        """The dict graph ran a full ``init_aggregates()`` rebuild (a
        build-time path): resync free flags and schedule a sweep."""
        g = self.g
        for i in range(self.n):
            if self.present[i]:
                vv = g.get(self.path[i])
                if vv is not None:
                    self.free[i] = vv.free
        self._pending.clear()
        self._struct_dirty = True
        self._synced_version = -1

    # -- settling ------------------------------------------------------- #
    def sync(self) -> None:
        """Settle queued dirty state.  Alloc/release flips bubble their
        deltas up the ancestor chains (vectorized, never a rebuild);
        topology changes run one vectorized per-level sweep.

        Fast path: the mutation hooks stamp ``_synced_version`` stale,
        so a second sync in the same kick (dispatcher, then matcher,
        then a feasibility scan) is a single int compare."""
        if self.g.version == self._synced_version:
            self.n_sync_fast += 1
            return
        if self._struct_dirty:
            self._refresh_levels()
            self._sweep()
            self._pending.clear()
            self._struct_dirty = False
        elif self._pending:
            self._bubble_pending()
        self._synced_version = self.g.version

    def _refresh_levels(self) -> None:
        n = self.n
        depth = np.zeros(n, np.int32)
        order: List[int] = []
        children = self.children
        roots = [self.idx[r] for r in self.g.roots if r in self.idx]
        stack = [(r, 0) for r in roots]
        while stack:
            i, d = stack.pop()
            depth[i] = d
            order.append(i)
            for c in children[i]:
                stack.append((c, d + 1))
        self._levels = []
        if order:
            maxd = int(depth[order].max())
            by = [[] for _ in range(maxd + 1)]
            for i in order:
                by[depth[i]].append(i)
            self._levels = [torch.tensor(np.asarray(l, np.int64), device=self.device)
                            for l in by]
        self._parent_dev = torch.tensor(self.parent[:n], device=self.device)

    def _sweep(self) -> None:
        self.n_agg_sweeps += 1
        n, T = self.n, len(self.types)
        own = np.zeros((n, T), np.int32)
        live = np.nonzero(self.present[:n] & self.free[:n])[0]
        own[live, self.type_id[live]] = 1
        if self._levels:
            agg = aggregate_sweep(own, self._parent_dev, self._levels,
                                  self.device).cpu().numpy()
        else:
            agg = own
        self.agg[:n, :T] = agg

    def _bubble_pending(self) -> None:
        self.n_bubbles += 1
        pend = self._pending
        self._pending = []
        agg, parent = self.agg, self.parent
        if len(pend) <= 8:
            for i, t, d in pend:        # scalar walk: cheaper than numpy
                while i >= 0:
                    agg[i, t] += d
                    i = parent[i]
            return
        k = len(pend)
        idxs = np.fromiter((p[0] for p in pend), np.int64, k)
        delta = np.zeros((k, agg.shape[1]), np.int32)
        delta[np.arange(k), [p[1] for p in pend]] = [p[2] for p in pend]
        cur = idxs
        while len(cur):
            np.add.at(agg, cur, delta)
            par = parent[cur]
            m = par >= 0
            cur, delta = par[m], delta[m]

    # -- queries -------------------------------------------------------- #
    def root_indices(self) -> List[int]:
        return [self.idx[r] for r in self.g.roots if r in self.idx]

    def compiled(self, req: ResourceReq) -> "_CompiledReq":
        """Cached :class:`_CompiledReq` for ``req``.  Compilation reads
        only the type / property-bit tables, which are grow-only
        between full builds, so the entry stays valid across
        ``graph.version`` bumps: an unchanged pending job never
        recompiles, no matter how much the graph churns."""
        key = id(req)
        gen = (len(self.types), len(self.prop_bit), self.prop_overflow)
        hit = self._req_cache.get(key)
        if hit is not None and hit[0] is req and hit[1] == gen:
            return hit[2]
        if len(self._req_cache) >= 8192:    # deep-backlog bound
            self._req_cache.clear()
        c = _CompiledReq(self, req)
        self._req_cache[key] = (req, gen, c)
        return c

    def feasible_roots(self, req: ResourceReq) -> np.ndarray:
        """Indices of vertices where a match of ``req`` could root
        (vectorized necessary-condition scan).  Empty array == the
        request provably cannot match anywhere."""
        self.sync()
        c = self.compiled(req)
        if c.tid is None:
            return np.empty(0, np.int64)
        n = self.n
        mask = candidate_mask(self.type_id[:n], self.free[:n],
                              self.present[:n], self.size[:n],
                              self.prop_mask[:n], self.agg[:n],
                              c.tid, c.min_size, c.req_mask, c.agg_need)
        return np.nonzero(mask)[0]

    def feasible_roots_batch(self, reqs: Sequence[ResourceReq]) -> np.ndarray:
        """``feasible_roots`` for N requests in **one** vectorized pass.

        The compiled requests are stacked into a request matrix and
        scanned against the ``agg[vertex, type]`` pruning table at
        once; the result is an ``[N, V]`` boolean feasibility mask
        (``mask[i].nonzero()`` == ``feasible_roots(reqs[i])``).  A
        backfill window repeats a handful of request shapes, so rows
        are deduplicated by compiled signature first — the scan cost is
        one pass over the *unique* shapes, not over N.

        The scan runs on the graph's device: the deduplicated request
        matrix and the ``[:n]`` vertex columns are copied there and handed
        to ``kernels/ops.py::batched_feasible_op`` (the CUDA kernel on a
        card, its plain version on the CPU). ``agg`` goes across as its
        contiguous ``[n, cap_T]`` rows and reaches the scan as the
        ``[:, :T]`` view: ``_tid`` grows the type columns in steps of 4,
        and the kernel takes the row stride."""
        self.sync()
        n, N = self.n, len(reqs)
        out = np.zeros((N, n), bool)
        if N == 0 or n == 0:
            return out
        sig_rows: Dict[Tuple, List[int]] = {}
        for i, req in enumerate(reqs):
            c = self.compiled(req)
            if c.tid is None:       # some required type absent: no row
                continue
            sig = (c.tid, c.min_size, c.req_mask, tuple(c.agg_need))
            sig_rows.setdefault(sig, []).append(i)
        if not sig_rows:
            return out
        uniq = list(sig_rows)
        U, T = len(uniq), len(self.types)
        tid = np.fromiter((s[0] for s in uniq), np.int32, U)
        min_size = np.fromiter((s[1] for s in uniq), np.int32, U)
        req_mask = np.fromiter((s[2] for s in uniq), np.int64, U)
        need = np.zeros((U, T), np.int32)
        for u, s in enumerate(uniq):
            for t, k in s[3]:
                need[u, t] = k
        dev = self.device

        def col(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(dev)

        m = batched_feasible_op(
            col(self.type_id[:n]), col(self.free[:n] & self.present[:n]),
            col(self.size[:n]), col(self.prop_mask[:n]), col(self.agg[:n])[:, :T],
            col(tid), col(min_size), col(req_mask), col(need)).cpu().numpy() != 0
        for u, s in enumerate(uniq):
            row = m[u]
            for i in sig_rows[s]:
                out[i] = row
        return out

    # -- verification (tests) ------------------------------------------- #
    def verify_against(self, g=None) -> bool:
        """Exact agreement with the dict graph: same vertex set, free
        flags, and pruning aggregates."""
        g = g or self.g
        self.sync()
        live = {self.path[i] for i in range(self.n) if self.present[i]}
        if live != set(g.paths()):
            return False
        for p in g.paths():
            i = self.idx[p]
            v = g.vertex(p)
            if bool(self.free[i]) != v.free:
                return False
            row = self.agg[i]
            for t, cnt in v.agg_free.items():
                if t not in self.tmap:
                    if cnt:
                        return False
                elif row[self.tmap[t]] != cnt:
                    return False
            for t in self.types:
                if row[self.tmap[t]] != v.agg_free.get(t, 0):
                    return False
        return True


# ---------------------------------------------------------------------- #
# compiled requests
# ---------------------------------------------------------------------- #
class _CompiledReq:
    """One ``ResourceReq`` resolved against a FlatGraph's type/property
    tables: int type ids, nested per-type aggregate needs, property
    bitmask, and recursively compiled children."""

    __slots__ = ("req", "tid", "min_size", "req_mask", "props",
                 "agg_need", "count", "with_")

    def __init__(self, f: FlatGraph, req: ResourceReq):
        self.req = req
        self.tid = f.tmap.get(req.type)
        self.count = req.count
        self.min_size = req.size
        self.props = req.properties
        mask = 0
        if req.properties and not f.prop_overflow:
            for kv in req.properties.items():
                bit = f.prop_bit.get(kv)
                if bit is None:
                    mask = -1       # pair never seen: no vertex has it
                    break
                mask |= bit
        self.req_mask = 0 if mask == -1 else mask
        self.with_ = [_CompiledReq(f, w) for w in req.with_]
        # per-INSTANCE type totals: what one match rooted at a candidate
        # vertex consumes (the whole-request total would over-prune a
        # single trial and diverge from the dict matcher)
        one: Dict[str, int] = {req.type: 1}
        for w in req.with_:
            w.type_counts(one, 1)
        need: Dict[int, int] = {}
        for t, cnt in one.items():
            t_id = f.tmap.get(t)
            if t_id is None:
                need = {}
                self.tid = None     # some required type absent entirely
                break
            need[t_id] = need.get(t_id, 0) + cnt
        self.agg_need: List[Tuple[int, int]] = sorted(need.items())


# ---------------------------------------------------------------------- #
# the flat matcher
# ---------------------------------------------------------------------- #
class FlatMatcher:
    """Integer-index port of ``core/match.py``'s DFS.

    Same traversal order (stack DFS, children pushed in insertion
    order), same exclusive-claim semantics; per-trial set copies are
    replaced by one claim bitmap + undo journal, and subtree descent is
    additionally gated by the vectorized candidate prefilter — so it
    returns exactly what the dict matcher returns, faster.
    """

    def __init__(self, flat: FlatGraph):
        self.f = flat
        self.visited = 0

    def match(self, jobspec: Jobspec) -> Optional[List[str]]:
        f = self.f
        f.sync()
        self.visited = 0
        n = f.n
        claimed = bytearray(n)
        undo: List[int] = []
        # snapshot hot columns as python lists: scalar list indexing is
        # ~3x a numpy scalar read, and nothing mutates during a match
        self._children = f.children
        self._free = f.free[:n].tolist()
        self._type = f.type_id[:n].tolist()
        self._agg_col: Dict[int, List[int]] = {}
        matched: List[int] = []
        for req in jobspec.resources:
            c = f.compiled(req)
            if c.tid is None:
                return None
            cand_in = self._cand_counts(c)
            found = False
            for root in f.root_indices():
                got = self._match_count(root, c, claimed, undo, cand_in)
                if got is not None:
                    matched.extend(got)
                    found = True
                    break
            if not found:
                return None
        path = f.path
        return [path[i] for i in matched]

    # -- vectorized prefilter ------------------------------------------ #
    def _cand_counts(self, c: _CompiledReq) -> Optional[List[int]]:
        """Per-vertex count of feasible candidate roots for ``c`` in
        the subtree — the prefilter the DFS prunes on.  None when the
        graph is too small for vectorization to pay off."""
        f = self.f
        n = f.n
        if n < VECTOR_MIN_VERTICES:
            return None
        mask = candidate_mask(f.type_id[:n], f.free[:n], f.present[:n],
                              f.size[:n], f.prop_mask[:n], f.agg[:n],
                              c.tid, c.min_size, c.req_mask, c.agg_need)
        own = mask.astype(np.int32)[:, None]
        agg = aggregate_sweep(own, f._parent_dev, f._levels, f.device)
        return agg[:, 0].tolist()

    def _agg(self, tid: int) -> List[int]:
        col = self._agg_col.get(tid)
        if col is None:
            col = self._agg_col[tid] = \
                self.f.agg[:self.f.n, tid].tolist()
        return col

    # -- claim journal -------------------------------------------------- #
    @staticmethod
    def _unwind(claimed: bytearray, undo: List[int], mark: int) -> None:
        while len(undo) > mark:
            claimed[undo.pop()] = 0

    # -- the DFS (mirrors core/match.py exactly) ------------------------ #
    def _satisfies(self, i: int, c: _CompiledReq) -> bool:
        if self._type[i] != c.tid or not self._free[i]:
            return False
        f = self.f
        if c.min_size > 1 and f.size[i] < c.min_size:
            return False
        if c.props:
            vp = f.props[i]
            for k, val in c.props.items():
                if vp.get(k) != val:
                    return False
        return True

    def _feasible_here(self, i: int, c: _CompiledReq) -> bool:
        """Aggregate precheck before a trial rooted at ``i``: every
        nested type requirement must be covered by the subtree.  A
        failing trial the dict matcher would run and lose is skipped —
        the outcome (fall through to the children) is identical."""
        for t, need in c.agg_need:
            if self._agg(t)[i] < need:
                return False
        return True

    def _match_count(self, scope: int, c: _CompiledReq,
                     claimed: bytearray, undo: List[int],
                     cand_in: Optional[List[int]]) -> Optional[List[int]]:
        got: List[int] = []
        mark = len(undo)
        need = c.count
        children = self._children
        agg_t = self._agg(c.tid)
        stack = [scope]
        while stack and need > 0:
            i = stack.pop()
            if claimed[i]:
                continue
            self.visited += 1
            if cand_in is not None:
                if cand_in[i] == 0:
                    continue        # no feasible candidate below at all
            elif agg_t[i] < 1:
                continue            # classic pruning-filter skip
            if self._satisfies(i, c) and self._feasible_here(i, c):
                sub = self._match_one(i, c, claimed, undo)
                if sub is not None:
                    got.extend(sub)
                    need -= 1
                    continue        # exclusive: don't descend a match
            stack.extend(children[i])
        if need > 0:
            self._unwind(claimed, undo, mark)
            return None
        return got

    def _match_one(self, i: int, c: _CompiledReq, claimed: bytearray,
                   undo: List[int]) -> Optional[List[int]]:
        mark = len(undo)
        claimed[i] = 1
        undo.append(i)
        sub = [i]
        for cw in c.with_:
            got = self._match_count_under(i, cw, claimed, undo)
            if got is None:
                self._unwind(claimed, undo, mark)
                return None
            sub.extend(got)
        return sub

    def _match_count_under(self, scope: int, c: _CompiledReq,
                           claimed: bytearray,
                           undo: List[int]) -> Optional[List[int]]:
        got: List[int] = []
        mark = len(undo)
        need = c.count
        children = self._children
        agg_t = self._agg(c.tid)
        stack = list(children[scope])
        while stack and need > 0:
            i = stack.pop()
            if claimed[i]:
                continue
            self.visited += 1
            if agg_t[i] < 1:
                continue
            if self._satisfies(i, c) and self._feasible_here(i, c):
                sub = self._match_one(i, c, claimed, undo)
                if sub is not None:
                    got.extend(sub)
                    need -= 1
                    continue
            stack.extend(children[i])
        if need > 0:
            self._unwind(claimed, undo, mark)
            return None
        return got


def flat_enabled() -> bool:
    """Module-level default for the flat fast path; the
    ``CONVERGED_FLAT_MATCH`` env var ('0' disables) is the escape
    hatch benchmarks use to measure the dict path."""
    return os.environ.get("CONVERGED_FLAT_MATCH", "1") != "0"
