"""Pluggable scheduling policies for the job lifecycle queue.

The mechanism/policy split ("Design Principles of Dynamic Resource
Management for Heterogeneous Systems"): ``core/queue.py`` owns the job
lifecycle *mechanism* (states, clocks, timed release, MA/MG binding),
while everything that is a *decision* — queue order, which jobs may
jump a blocked head, and whether running work may be displaced — lives
here behind the :class:`SchedulingPolicy` interface ("Job Scheduling in
High Performance Computing" surveys exactly this policy space).

A policy sees the queue read-mostly: it inspects ``queue.pending`` /
``queue.running`` / the scheduler's pruning aggregates, and acts only
through two mechanism entry points — ``queue.start_if_fits(job)`` and
``queue.preempt(job)``.

Implementations:

* :class:`FCFS` — strict arrival order, no backfill, no preemption.
* :class:`PriorityFCFS` — priority first (higher wins), FCFS within a
  priority; no backfill.  (The old ``backfill=False`` behavior.)
* :class:`EasyBackfill` — PriorityFCFS order + EASY backfill: the
  blocked head gets a reservation at its shadow time (estimated from
  the pruning aggregates and running jobs' end times), and later jobs
  jump ahead if they finish before it — or, with the default
  ``spare_capacity`` refinement, if a one-job reservation profile
  proves they cannot touch the head's reservation at all.  The
  queue's default; ``EasyBackfill(spare_capacity=False)`` is the
  strict single-shadow (pre-refinement) rule.
* :class:`ConservativeBackfill` — every pending job ahead of a
  candidate keeps its reservation: the candidate is admitted only if a
  count-based reservation profile shows no reservation moving later.
  Admits long jobs on genuinely spare capacity (which EASY's
  single-shadow rule rejects) while never delaying anyone.
* :class:`FirstFit` — no reservations at all: anything in the queue
  that fits right now starts, arrival order otherwise.  Maximum
  utilization, unbounded head-of-line delay.
* :class:`PreemptivePriority` — EASY ordering/backfill, plus a blocked
  head may evict running preemptible jobs of strictly lower priority
  (newest first); victims are requeued PREEMPTED -> PENDING.  Also
  arms the hierarchy's revoke path (``preemptive = True``) so grows
  escalating out of this queue may displace sibling-subtree work.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, TYPE_CHECKING

import numpy as np

from .flatgraph import FLAT_MIN_VERTICES, flat_enabled

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .queue import Job, JobQueue


class SchedulingPolicy:
    """Order, backfill, and preemption decisions for a JobQueue."""

    name = "base"
    # when True, grows escalating from this queue carry preempt=True
    # through the hierarchy (the engine's revoke path)
    preemptive = False

    def sort_key(self, job: "Job") -> Tuple:
        """Pending-queue order; default: priority first, FCFS within."""
        return (-job.priority, job.seq)

    def backfill(self, queue: "JobQueue", head: "Job") -> int:
        """Called with the blocked head; may start jobs behind it via
        ``queue.start_if_fits``.  Returns the number started."""
        return 0

    def preempt_victims(self, queue: "JobQueue",
                        head: "Job") -> List["Job"]:
        """Running jobs to evict so the blocked ``head`` can start.
        Empty list = no preemption.  The mechanism releases the victims
        and requeues them before retrying the head."""
        return []


class FCFS(SchedulingPolicy):
    """Strict arrival order; priorities ignored."""

    name = "fcfs"

    def sort_key(self, job: "Job") -> Tuple:
        return (job.seq,)


class PriorityFCFS(SchedulingPolicy):
    """Priority + FCFS, no backfill (the old ``backfill=False``)."""

    name = "priority-fcfs"


class EasyBackfill(PriorityFCFS):
    """EASY: only the head holds a reservation (its shadow time).

    Refinement (``spare_capacity``, default on): a candidate that ends
    *after* the shadow time is still admitted when a one-job
    reservation profile proves it cannot touch the head's reservation
    — it runs on capacity the head's shadow-time credit never needs
    (the admission conservative backfill makes, restricted to the
    head).  A structurally blocked head (counts suffice but the match
    fails) keeps the strict rule: the count-based profile cannot see
    structural conflicts, so nothing may jump such a head."""

    name = "easy"

    def __init__(self, spare_capacity: bool = True,
                 max_candidates: Optional[int] = None,
                 ledger: bool = True):
        self.spare_capacity = spare_capacity
        # backfill window (Slurm's bf_max_job_test): at most this many
        # pending jobs are examined per pass.  None = unbounded — exact
        # EASY.  On a pure queue with the flat mirror active, exact
        # mode runs as a vectorized pass (_backfill_exact): per-SHAPE
        # admission verdicts + one boolean mask over the columnar
        # pending mirror, so a kick over a 100k backlog is a few array
        # ops instead of the seed's O(backlog x running) estimator
        # walks.
        self.max_candidates = max_candidates
        # ledger=False: the seed's O(running)-walk estimators and no
        # skip memos — kept as the decision-equivalence oracle for the
        # ledger property tests.
        self.ledger = ledger

    def backfill(self, queue: "JobQueue", head: "Job") -> int:
        now = queue.clock.now()
        fast = self.ledger and getattr(queue, "ledger", None) is not None
        if (self.max_candidates is None and fast and _sched_pure(queue)
                and type(self).sort_key is SchedulingPolicy.sort_key):
            g = queue.scheduler.graph
            mir = getattr(queue, "_pmirror", None)
            if mir is not None and (
                    g._flat is not None
                    or (flat_enabled()
                        and g.num_vertices >= FLAT_MIN_VERTICES)):
                return self._backfill_exact(queue, head, now, g.flat())
        shadow = shadow_time(queue, head, use_ledger=fast)
        structural = not _deficit(queue, head)
        started = 0
        stop = None if self.max_candidates is None \
            else 1 + self.max_candidates
        gv = queue.scheduler.graph.version
        # Skip memo, keyed (graph.version, head.seq): with the graph
        # and head unchanged, every "no start" decision below repeats —
        # the clock only moves forward and each test is monotone in
        # now, and a failed match is already version-memoized — so a
        # re-kick over a deep backlog pays one compare per job instead
        # of re-walking the estimators.  Only valid on a pure queue
        # (decisions a function of local graph state alone).
        memo = fast and _sched_pure(queue)
        hseq = head.seq
        for job in queue.pending[1:stop]:
            if memo and job._bf_version == gv and job._bf_head == hseq:
                continue
            if job.walltime is None:
                # unbounded jobs can never backfill
                if memo:
                    job._bf_version, job._bf_head = gv, hseq
                continue
            if _cannot_fit(queue, job):
                if memo:
                    job._bf_version, job._bf_head = gv, hseq
                continue
            if shadow is not None and now + job.walltime > shadow:
                # would overlap the head's reservation window: admit
                # only if provably on spare capacity
                if structural or not self.spare_capacity \
                        or self._delays_head(queue, head, job, shadow):
                    if memo:
                        job._bf_version, job._bf_head = gv, hseq
                    continue
            if queue.start_if_fits(job):
                queue._log(f"t={now:.3f} backfill {job.jobid} ahead of "
                           f"{head.jobid} (shadow={shadow})")
                started += 1
                # availability changed: the shadow may have moved
                shadow = shadow_time(queue, head, use_ledger=fast)
                structural = not _deficit(queue, head)
                gv = queue.scheduler.graph.version
            elif memo:
                job._bf_version, job._bf_head = gv, hseq
        return started

    def _backfill_exact(self, queue: "JobQueue", head: "Job",
                        now: float, flat) -> int:
        """Exact (unwindowed) EASY as a vectorized forward walk.

        Decision-for-decision equal to the sequential pass above, but
        the per-candidate work is hoisted into per-*shape* verdicts
        (``_sig_verdicts``) and one boolean mask over the pending
        mirror's columns — so a pass over a deep backlog costs a few
        numpy array ops plus a Python visit for only the handful of
        candidates actually admitted for a match attempt.  After every
        successful start the mask is recomputed against the new graph
        state with a sort-key floor at the started job, which is
        exactly "continue the walk from the next candidate".

        Only reached on a pure queue with the ledger on, the default
        sort order, and the flat mirror active (the dispatch above);
        everything else keeps the sequential walk."""
        mir: _PendingMirror = queue._pmirror
        started = 0
        shadow = shadow_time(queue, head, use_ledger=True)
        structural = not _deficit(queue, head)
        floor_p, floor_s = head.priority, head.seq
        while True:
            n = mir.n
            if n == 0:
                return started
            fit, delays = self._sig_verdicts(queue, head, shadow,
                                             structural, now, flat)
            wt = mir.wt[:n]
            sg = mir.sig[:n]
            prio = mir.prio[:n]
            seq = mir.seq[:n]
            # walltime-None and tombstoned rows are NaN: never admitted
            cand = np.isfinite(wt) & fit[sg]
            # strictly after the head / the last started job
            cand &= (prio < floor_p) | ((prio == floor_p)
                                        & (seq > floor_s))
            sliver = None
            if shadow is not None:
                direct = (now + wt) <= shadow
                if structural or not self.spare_capacity:
                    # nothing may jump a structurally blocked head (or
                    # strict single-shadow mode) unless it finishes
                    # before the shadow
                    cand &= direct
                else:
                    # the per-shape overlap verdict is exact except in
                    # the 1e-12 band around the shadow _later() uses —
                    # candidates there get the per-job what-if below
                    sliver = ~direct & ((now + wt) <= shadow + 1e-12)
                    cand &= direct | ~delays[sg] | sliver
            idxs = np.nonzero(cand)[0]
            if idxs.size == 0:
                return started
            order = np.lexsort((seq[idxs], -prio[idxs]))
            progressed = False
            matchfail: set = set()   # shapes whose match failed here
            for i in idxs[order]:
                job = mir.jobs[i]
                if job is None:
                    continue
                s = int(sg[i])
                if s in matchfail:
                    # a match is a pure function of (shape, graph) on
                    # this queue: same shape fails identically
                    continue
                if sliver is not None and sliver[i] \
                        and self._delays_head(queue, head, job, shadow):
                    continue
                if queue.start_if_fits(job):
                    queue._log(f"t={now:.3f} backfill {job.jobid} "
                               f"ahead of {head.jobid} "
                               f"(shadow={shadow})")
                    started += 1
                    shadow = shadow_time(queue, head, use_ledger=True)
                    structural = not _deficit(queue, head)
                    floor_p, floor_s = job.priority, job.seq
                    progressed = True
                    break
                matchfail.add(s)
            if not progressed:
                return started

    def _sig_verdicts(self, queue: "JobQueue", head: "Job",
                      shadow: Optional[float], structural: bool,
                      now: float, flat) -> Tuple[np.ndarray, np.ndarray]:
        """Per-shape admission verdicts for the exact pass.

        ``fit[s]`` is ``not _cannot_fit`` for the shape: every request
        root feasible under the pruning aggregates (one shared
        ``feasible_roots_batch`` scan over all registered shapes) and,
        for non-growing shapes, free counts covering the request.

        ``delays[s]`` is the shadow-overlap spare-capacity verdict.  It
        is independent of the candidate's walltime: in the overlap
        branch the hypothetical release at ``now + wt`` lands strictly
        past the shadow, so ``_ledger_head_reservation``'s per-type
        ``min(t_base, t_extra)`` beats the shadow iff the *base* curve
        alone does — i.e. iff ``cover_time`` of the raised deficit
        does.  (The 1e-12 band where ``now + wt`` straddles the
        shadow's comparison epsilon is excluded by the caller.)"""
        mir: _PendingMirror = queue._pmirror
        g = queue.scheduler.graph
        S = len(mir.sig_entries)
        allow = queue.allow_grow
        key_fit = (g.version, allow, S)
        cache = getattr(queue, "_sigv_fit", None)
        if cache is not None and cache[0] == key_fit:
            fit = cache[1]
        else:
            free = _free_counts(queue)
            reqs: List = []
            spans: List[int] = []
            for spec, _grow, _prio in mir.sig_entries:
                spans.append(len(spec.resources))
                reqs.extend(spec.resources)
            any_root = flat.feasible_roots_batch(reqs).any(axis=1)
            fit = np.empty(S, bool)
            k = 0
            for s, (spec, rgrow, _prio) in enumerate(mir.sig_entries):
                ok = bool(any_root[k:k + spans[s]].all())
                k += spans[s]
                if ok and not (allow if rgrow is None else rgrow):
                    ok = all(free.get(t, 0) >= c
                             for t, c in spec.type_counts().items())
                fit[s] = ok
            queue._sigv_fit = (key_fit, fit)
        if shadow is None or structural or not self.spare_capacity:
            return fit, fit          # delays unused by the caller
        key_d = (g.version, head.seq, shadow, now, S)
        cache = getattr(queue, "_sigv_delays", None)
        if cache is not None and cache[0] == key_d:
            return fit, cache[1]
        free = _free_counts(queue)
        head_tc = head.jobspec.type_counts()
        led = queue.ledger
        delays = np.empty(S, bool)
        for s, (spec, _grow, _prio) in enumerate(mir.sig_entries):
            need = spec.type_counts()
            dprime = {}
            for t, nh in head_tc.items():
                d = nh - (free.get(t, 0) - need.get(t, 0))
                if d > 0:
                    dprime[t] = d
            after = now if not dprime else led.cover_time(dprime)
            delays[s] = _later(after, shadow)
        queue._sigv_delays = (key_d, delays)
        return fit, delays

    def _delays_head(self, queue: "JobQueue", head: "Job", job: "Job",
                     shadow: float) -> bool:
        """Would hypothetically running ``job`` move the head's
        reservation past its shadow time?"""
        if self.ledger and getattr(queue, "ledger", None) is not None:
            after = _ledger_head_reservation(queue, head, job)
        else:
            prof = reservation_profile(queue, [head], hypothetical=job,
                                       use_ledger=False)
            after = prof.get(head.jobid)
        return _later(after, shadow)


class ConservativeBackfill(PriorityFCFS):
    """Every queued job keeps its reservation, not just the head.

    Reservations are estimated with a count-based profile over the
    pruning aggregates (free counts per type now, plus the typed
    releases of running and already-reserved jobs in end-time order).
    A candidate is admitted only if recomputing the profile with the
    candidate hypothetically running moves no reservation later.

    Like production schedulers (Slurm's ``bf_max_job_test``), the work
    per pass is bounded: only the first ``depth`` pending jobs carry
    protected reservations and at most ``max_candidates`` jobs are
    tested per pass — the profile is O(depth·|running|) per candidate,
    which must not scale with a deep backlog."""

    name = "conservative"

    def __init__(self, depth: int = 32, max_candidates: int = 64):
        self.depth = depth
        self.max_candidates = max_candidates

    def backfill(self, queue: "JobQueue", head: "Job") -> int:
        now = queue.clock.now()
        started = 0
        tested = 0
        snapshot = list(queue.pending)
        gone: set = set()           # ids started earlier this pass
        # the no-candidate profile only depends on the queue prefix: it
        # is computed once per pass (and refreshed after each start,
        # which changes availability); a prefix of it is the profile of
        # any shorter "ahead" list, since reservations are sequential
        before = None
        for idx, job in enumerate(snapshot):
            if job is head or job.walltime is None or id(job) in gone:
                continue
            if tested >= self.max_candidates:
                break
            if _cannot_fit(queue, job):
                continue            # cannot fit now: profiles pointless
            tested += 1
            ahead = [j for j in snapshot[:idx]
                     if id(j) not in gone][:self.depth]
            if before is None:
                before = reservation_profile(
                    queue, [j for j in snapshot
                            if id(j) not in gone][:self.depth])
            after = reservation_profile(queue, ahead, hypothetical=job)
            if any(_later(after.get(j.jobid), before.get(j.jobid))
                   for j in ahead):
                continue            # would push someone's reservation
            if queue.start_if_fits(job):
                queue._log(f"t={now:.3f} backfill {job.jobid} "
                           f"(conservative: no reservation delayed)")
                started += 1
                gone.add(id(job))
                before = None       # availability changed: recompute
        return started


class FirstFit(PriorityFCFS):
    """No reservations: start anything that fits, in queue order.

    ``max_candidates`` bounds the match attempts per pass (each failed
    fit runs the matcher) so a deep backlog cannot stall the clock."""

    name = "firstfit"

    def __init__(self, max_candidates: int = 256):
        self.max_candidates = max_candidates

    def backfill(self, queue: "JobQueue", head: "Job") -> int:
        now = queue.clock.now()
        started = 0
        tested = 0
        for job in list(queue.pending):
            if job is head:
                continue
            if tested >= self.max_candidates:
                break
            if _cannot_fit(queue, job):
                continue
            tested += 1
            if queue.start_if_fits(job):
                queue._log(f"t={now:.3f} backfill {job.jobid} (firstfit)")
                started += 1
        return started


class PreemptivePriority(EasyBackfill):
    """EASY + eviction: a blocked head may displace running preemptible
    jobs of strictly lower priority (lowest priority first, newest
    first within one) when the freed vertices would cover its deficit."""

    name = "preempt"
    preemptive = True

    def preempt_victims(self, queue: "JobQueue",
                        head: "Job") -> List["Job"]:
        deficit = _deficit(queue, head)
        if not deficit:
            return []               # structurally blocked, not capacity
        sched = queue.scheduler
        candidates = sorted(
            (j for j in queue.running
             if j.preemptible and j.priority < head.priority),
            key=lambda j: (j.priority, -j.seq))
        victims: List["Job"] = []
        for job in candidates:
            # only vertices that would return to the LOCAL free pool
            # count: spliced/external copies leave the graph on release
            # (they free at the ancestor), and a victim contributing
            # nothing toward the deficit must not be evicted at all
            contrib: Dict[str, int] = {}
            for p in job.paths:
                v = sched.graph.get(p)
                if v is None or p in sched.spliced_paths \
                        or p in sched.external_paths:
                    continue
                contrib[v.type] = contrib.get(v.type, 0) + 1
            if not any(t in deficit for t in contrib):
                continue            # evicting this one cannot help
            victims.append(job)
            for t, n in contrib.items():
                if t in deficit:
                    deficit[t] -= n
                    if deficit[t] <= 0:
                        del deficit[t]
            if not deficit:
                return victims
        return []                   # eviction alone cannot cover it


#: registry for CLI / benchmark selection by name
POLICIES: Dict[str, type] = {
    p.name: p for p in (FCFS, PriorityFCFS, EasyBackfill,
                        ConservativeBackfill, FirstFit,
                        PreemptivePriority)
}


def make_policy(name: str) -> SchedulingPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown scheduling policy {name!r}; "
            f"known: {', '.join(sorted(POLICIES))}") from None


# ---------------------------------------------------------------------- #
# the incremental reservation ledger
# ---------------------------------------------------------------------- #
class ReservationLedger:
    """Per-type release timelines of the running jobs, as sorted event
    arrays with prefix-sum free curves.

    The queue updates it with O(1) deltas on every lifecycle edge —
    start, finish, preempt, grow, shrink (all under ``_api_lock``) —
    and the estimators below answer "when are these per-type deficits
    covered?" with binary searches over curves that are materialized
    once per mutation generation.  That turns ``shadow_time`` and the
    EASY ``_delays_head`` what-if from per-candidate O(running) walks
    into O(types · log running) queries, which is what makes *exact*
    (unwindowed) EASY affordable on a deep backlog.
    """

    def __init__(self) -> None:
        # jobid -> (end_time, per-type vertex counts at release)
        self._entries: Dict[str, Tuple[float, Dict[str, int]]] = {}
        self._gen = 0               # bumped by every delta
        self._built = -1            # generation the curves reflect
        self._times: Dict[str, np.ndarray] = {}
        self._cum: Dict[str, np.ndarray] = {}
        self._timeline: List[Tuple[float, Dict[str, int]]] = []

    # -- deltas (called by JobQueue under _api_lock) -------------------- #
    def job_started(self, jobid: str, end_time: Optional[float],
                    counts: Dict[str, int]) -> None:
        if end_time is None:
            return                  # never releases: not an event
        self._entries[jobid] = (end_time, counts)
        self._gen += 1

    def job_departed(self, jobid: str) -> None:
        if self._entries.pop(jobid, None) is not None:
            self._gen += 1

    def job_resized(self, jobid: str, end_time: Optional[float],
                    counts: Dict[str, int]) -> None:
        """Grow/shrink: the job's eventual release changed shape."""
        if end_time is None:
            self.job_departed(jobid)
            return
        self._entries[jobid] = (end_time, counts)
        self._gen += 1

    # -- lazy materialization ------------------------------------------- #
    def _materialize(self) -> None:
        if self._built == self._gen:
            return
        events = sorted(self._entries.values(), key=lambda e: e[0])
        per: Dict[str, Tuple[List[float], List[int]]] = {}
        self._timeline = events
        for t, counts in events:
            for typ, k in counts.items():
                ts, ks = per.setdefault(typ, ([], []))
                ts.append(t)
                ks.append(k)
        self._times = {typ: np.asarray(ts, float)
                       for typ, (ts, _) in per.items()}
        self._cum = {typ: np.cumsum(ks)
                     for typ, (_, ks) in per.items()}
        self._built = self._gen

    def timeline(self) -> List[Tuple[float, Dict[str, int]]]:
        """The running jobs' (end_time, type counts) releases, sorted —
        what the seed rebuilt from ``queue.running`` per profile call."""
        self._materialize()
        return self._timeline

    # -- queries -------------------------------------------------------- #
    def cover_time(self, deficit: Dict[str, int],
                   extra_time: Optional[float] = None,
                   extra_counts: Optional[Dict[str, int]] = None
                   ) -> Optional[float]:
        """Earliest release-event time by which cumulative releases
        cover every per-type deficit; None if they never do.  ``extra_*``
        add one hypothetical release event (EASY's what-if candidate)
        without rebuilding the curves: per type, the cover time is the
        cheaper of covering from the base curve alone or from the base
        curve minus the extra contribution, floored at the extra event's
        time."""
        self._materialize()
        worst: Optional[float] = None
        for typ, d in deficit.items():
            t_cov = self._cover_one(typ, d, extra_time, extra_counts)
            if t_cov is None:
                return None
            if worst is None or t_cov > worst:
                worst = t_cov
        return worst

    def _cover_one(self, typ: str, d: int,
                   extra_time: Optional[float],
                   extra_counts: Optional[Dict[str, int]]
                   ) -> Optional[float]:
        times = self._times.get(typ)
        cum = self._cum.get(typ)
        t_base: Optional[float] = None
        if times is not None:
            i = int(np.searchsorted(cum, d, side="left"))
            if i < len(times):
                t_base = float(times[i])
        cx = extra_counts.get(typ, 0) if extra_counts else 0
        if extra_time is None or cx <= 0:
            return t_base
        rem = d - cx
        if rem <= 0:
            t_extra: Optional[float] = extra_time
        elif times is None:
            t_extra = None
        else:
            i = int(np.searchsorted(cum, rem, side="left"))
            t_extra = max(extra_time, float(times[i])) \
                if i < len(times) else None
        if t_base is None:
            return t_extra
        if t_extra is None:
            return t_base
        return min(t_base, t_extra)


class _PendingMirror:
    """Columnar mirror of a queue's pending list for the vectorized
    exact-EASY pass: per-job walltime / priority / seq / shape columns
    kept in numpy arrays, updated O(1) on every pending mutation
    (tombstones + amortized compaction), so a pass over a 100k-deep
    backlog is array ops instead of a Python walk.

    The ``sig`` column maps each job to a *shape signature* — one entry
    per distinct (jobspec identity, grow override, priority) — because
    every admission verdict EASY needs per candidate (feasibility,
    deficit, the shadow-overlap what-if) is a function of the shape
    alone, not the job.  The registry pins a reference to each jobspec
    so ``id()`` keys stay unique for its lifetime."""

    __slots__ = ("jobs", "wt", "prio", "seq", "sig", "slot", "holes",
                 "sig_entries", "_sig_ids")

    def __init__(self) -> None:
        self.jobs: List[Optional["Job"]] = []
        self.wt = np.empty(64, np.float64)
        self.prio = np.empty(64, np.int64)
        self.seq = np.empty(64, np.int64)
        self.sig = np.empty(64, np.int32)
        self.slot: Dict[str, int] = {}
        self.holes = 0
        # (jobspec, grow override, priority) per signature id
        self.sig_entries: List[Tuple[object, Optional[bool], int]] = []
        self._sig_ids: Dict[Tuple[int, Optional[bool], int], int] = {}

    @property
    def n(self) -> int:
        return len(self.jobs)

    def _sig_of(self, job: "Job") -> int:
        key = (id(job.jobspec), job.grow, job.priority)
        s = self._sig_ids.get(key)
        if s is None:
            s = len(self.sig_entries)
            self.sig_entries.append((job.jobspec, job.grow, job.priority))
            self._sig_ids[key] = s
        return s

    def add(self, job: "Job") -> None:
        i = len(self.jobs)
        if i == len(self.wt):
            cap = 2 * i
            self.wt = np.resize(self.wt, cap)
            self.prio = np.resize(self.prio, cap)
            self.seq = np.resize(self.seq, cap)
            self.sig = np.resize(self.sig, cap)
        self.jobs.append(job)
        self.wt[i] = np.nan if job.walltime is None else job.walltime
        self.prio[i] = job.priority
        self.seq[i] = job.seq
        self.sig[i] = self._sig_of(job)
        self.slot[job.jobid] = i

    def discard(self, job: "Job") -> None:
        i = self.slot.pop(job.jobid, None)
        if i is None:
            return
        self.jobs[i] = None
        self.wt[i] = np.nan      # NaN compares False: never a candidate
        self.holes += 1
        if self.holes > 32 and self.holes * 2 > len(self.jobs):
            live = [j for j in self.jobs if j is not None]
            self.jobs = []
            self.slot.clear()
            self.holes = 0
            for j in live:
                self.add(j)

    def resync(self, pending: List["Job"]) -> None:
        """Full rebuild — ``kick()``'s escape hatch for externally
        mutated pending Jobs (changed priority/walltime invalidate the
        columns the same way they invalidate the queue's memos)."""
        self.jobs = []
        self.slot.clear()
        self.holes = 0
        for j in pending:
            self.add(j)


# ---------------------------------------------------------------------- #
# reservation estimation over the pruning aggregates
# ---------------------------------------------------------------------- #
def _free_counts(queue: "JobQueue") -> Dict[str, int]:
    g = queue.scheduler.graph
    free: Dict[str, int] = {}
    for root in g.roots:
        for t, n in g.vertex(root).agg_free.items():
            free[t] = free.get(t, 0) + n
    return free


def _deficit(queue: "JobQueue", job: "Job") -> Dict[str, int]:
    """Per-type shortfall between ``job``'s request and current free
    counts; empty when counts suffice (a structural block)."""
    free = _free_counts(queue)
    return {t: n - free.get(t, 0)
            for t, n in job.jobspec.type_counts().items()
            if n - free.get(t, 0) > 0}


def _sched_pure(queue: "JobQueue") -> bool:
    """True when a match attempt is a pure function of the local graph
    (no parent, no external provider, non-preemptive policy) — the same
    condition under which ``_try_start`` memoizes failed matches."""
    s = queue.scheduler
    return (s.parent is None and s.external is None
            and not queue.policy.preemptive)


def _prefilter_ok(queue: "JobQueue", job: "Job") -> bool:
    """Shared-mask membership: False means every top-level request of
    the job has zero feasible roots at the current graph version, so
    the matcher is *guaranteed* to fail.  The verdicts come from one
    ``feasible_roots_batch`` scan over the whole pending window,
    memoized per job per graph version (``_batch_prefilter``).  True is
    the safe default: small graphs (batch scan not worth the mirror)
    and impure queues (escalation or preemption can beat the local
    mask) are never filtered."""
    g = queue.scheduler.graph
    if g._flat is None and (not flat_enabled()
                            or g.num_vertices < FLAT_MIN_VERTICES):
        return True
    if not _sched_pure(queue):
        return True
    gv = g.version
    if job._pf_version != gv:
        _batch_prefilter(queue, gv)
        if job._pf_version != gv:
            return True         # not in this queue's pending window
    return job._pf_ok


def _batch_prefilter(queue: "JobQueue", gv: int) -> None:
    """One vectorized feasibility scan classifying every pending job
    whose memo is stale at graph version ``gv`` — the shared mask all
    policies' ``_cannot_fit`` calls consume."""
    flat = queue.scheduler.graph.flat()
    # a windowed pass only consults the first ~max_candidates pending
    # jobs, so cap the refresh pool accordingly (with slack for the
    # head and skipped rows); a job beyond the cap keeps a stale memo
    # and _prefilter_ok treats it as "cannot rule out" — exactly the
    # seed behavior, so decisions are unchanged.  Exact mode (no
    # window) refreshes the whole backlog in the one batched scan.
    lim = getattr(queue.policy, "max_candidates", None)
    pool = queue.pending if lim is None else \
        list(queue.pending)[:2 * lim + 2]
    stale = [j for j in pool if j._pf_version != gv]
    if not stale:
        return
    queue.n_prefilter_batches += 1
    reqs = []
    spans: List[Tuple["Job", int]] = []
    for j in stale:
        rs = j.jobspec.resources
        spans.append((j, len(rs)))
        reqs.extend(rs)
    any_root = flat.feasible_roots_batch(reqs).any(axis=1)
    k = 0
    for j, n_r in spans:
        j._pf_ok = bool(any_root[k:k + n_r].all())
        j._pf_version = gv
        k += n_r


def _cannot_fit(queue: "JobQueue", job: "Job") -> bool:
    """Cheap prefilter: the matcher is guaranteed to fail, so skip it
    without running it.  Two layers: local free counts cannot cover the
    request (the seed check), then the shared batched feasibility mask
    (``_prefilter_ok``) — a job whose requests have no feasible root
    anywhere cannot match even when raw counts suffice.  Growing jobs
    on an impure queue always get their attempt (the hierarchy may
    cover the shortfall); on a pure queue escalation cannot add
    resources, so the mask applies to them too."""
    grow = queue.allow_grow if job.grow is None else job.grow
    if grow and not _sched_pure(queue):
        return False
    if not grow and _deficit(queue, job):
        return True
    return not _prefilter_ok(queue, job)


def _path_type_counts(queue: "JobQueue", job: "Job") -> Dict[str, int]:
    # memoized per job: every transition that changes a job's path set
    # (start, grow, shrink, requeue) changes len(paths), and a running
    # job's bound vertices stay in the graph until it releases them —
    # so the backfill passes that call this once per running job per
    # pass (reservation profiles, shadow time) reuse one computation
    cached = getattr(job, "_ptc_cache", None)
    if cached is not None and cached[0] == len(job.paths):
        return cached[1]
    g = queue.scheduler.graph
    out: Dict[str, int] = {}
    for p in job.paths:
        v = g.get(p)
        if v is not None:
            out[v.type] = out.get(v.type, 0) + 1
    job._ptc_cache = (len(job.paths), out)
    return out


def shadow_time(queue: "JobQueue", head: "Job",
                use_ledger: bool = True) -> Optional[float]:
    """EASY's reservation for the head: the earliest release time by
    which the running jobs' returned vertices cover the head's per-type
    deficit.  None = releases alone can never cover it (the head needs
    grow escalation), so backfill is unrestricted.

    Default path: binary searches over the reservation ledger's
    prefix-sum curves.  ``use_ledger=False`` is the seed's end-time-
    order walk over ``queue.running`` (the equivalence oracle)."""
    deficit = _deficit(queue, head)
    if not deficit:
        # structurally blocked despite sufficient counts: reserve
        # "now" — conservative, nothing may jump the head
        return queue.clock.now()
    led = getattr(queue, "ledger", None) if use_ledger else None
    if led is not None:
        return led.cover_time(deficit)
    g = queue.scheduler.graph
    for job in sorted((j for j in queue.running
                       if j.end_time is not None),
                      key=lambda j: j.end_time):
        for p in job.paths:
            v = g.get(p)
            if v is None:
                continue
            if v.type in deficit:
                deficit[v.type] -= 1
                if deficit[v.type] <= 0:
                    del deficit[v.type]
        if not deficit:
            return job.end_time
    return None


def _ledger_head_reservation(queue: "JobQueue", head: "Job",
                             job: "Job") -> Optional[float]:
    """``reservation_profile(queue, [head], hypothetical=job)[head]``
    by ledger binary search: the head's reservation with ``job``
    hypothetically running from now for its walltime.  The candidate's
    vertices leave availability immediately (raising the head's
    deficit) and come back as one extra release event at
    ``now + job.walltime``."""
    now = queue.clock.now()
    avail = _free_counts(queue)
    need_j = job.jobspec.type_counts()
    deficit: Dict[str, int] = {}
    for t, nh in head.jobspec.type_counts().items():
        d = nh - (avail.get(t, 0) - need_j.get(t, 0))
        if d > 0:
            deficit[t] = d
    if not deficit:
        return now
    return queue.ledger.cover_time(deficit,
                                   extra_time=now + job.walltime,
                                   extra_counts=need_j)


def reservation_profile(queue: "JobQueue", pending: List["Job"],
                        hypothetical: Optional["Job"] = None,
                        use_ledger: bool = True
                        ) -> Dict[str, Optional[float]]:
    """Count-based reservation times for ``pending`` (in order).

    Availability starts at the current free counts; running jobs return
    their typed vertices at their end times; each reserved job consumes
    its request at its reservation and returns it ``walltime`` later.
    With ``hypothetical`` set, that job is treated as running from now
    for its walltime (the conservative-backfill what-if).  None means
    the profile never covers the job (it needs grow escalation).

    The running jobs' release timeline comes from the reservation
    ledger (materialized once per queue mutation) instead of being
    rebuilt from ``queue.running`` per call; ``use_ledger=False`` keeps
    the seed rebuild as the oracle."""
    now = queue.clock.now()
    avail = _free_counts(queue)
    led = getattr(queue, "ledger", None) if use_ledger else None
    if led is not None:
        releases: List[Tuple[float, Dict[str, int]]] = list(led.timeline())
    else:
        releases = [
            (j.end_time, _path_type_counts(queue, j))
            for j in queue.running if j.end_time is not None]
    if hypothetical is not None:
        need = hypothetical.jobspec.type_counts()
        for t, n in need.items():
            avail[t] = avail.get(t, 0) - n
        releases.append((now + hypothetical.walltime, need))
    releases.sort(key=lambda e: e[0])
    out: Dict[str, Optional[float]] = {}
    for job in pending:
        need = job.jobspec.type_counts()
        t_res: Optional[float] = None
        if all(avail.get(t, 0) >= n for t, n in need.items()):
            t_res = now
        else:
            # scan a copy: a job the profile can never cover must not
            # leave future releases pre-credited into the pool, or
            # every later job would be misread as reservable "now"
            acc = dict(avail)
            for i, (t_rel, counts) in enumerate(releases):
                for t, n in counts.items():
                    acc[t] = acc.get(t, 0) + n
                if all(acc.get(t, 0) >= n for t, n in need.items()):
                    t_res = t_rel
                    avail = acc
                    releases = releases[i + 1:]
                    break
        out[job.jobid] = t_res
        if t_res is not None:
            for t, n in need.items():
                avail[t] = avail.get(t, 0) - n
            if job.walltime is not None:
                releases.append((t_res + job.walltime, need))
                releases.sort(key=lambda e: e[0])
    return out


def _later(after: Optional[float], before: Optional[float]) -> bool:
    """Did a reservation move later (None = never/unbounded)?"""
    if before is None:
        return False                # was already unbounded
    if after is None:
        return True
    return after > before + 1e-12
