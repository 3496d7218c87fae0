"""Job lifecycle *mechanism* over the hierarchical scheduler.

Threading contract: every public verb takes ``self._api_lock`` — the
invariants (and the lint/witness machinery that enforces them) are
documented in ``docs/CONCURRENCY.md``.

This module is the mechanism half of the queue's mechanism/policy split
("Design Principles of Dynamic Resource Management ..."): it owns job
state, time, and resource binding, and delegates every scheduling
*decision* to a pluggable :class:`~repro_torch.core.policy.SchedulingPolicy`
(``core/policy.py`` — FCFS, priority+EASY, conservative, firstfit,
preemptive-priority; "Job Scheduling in High Performance Computing"
surveys the space).

Mechanism, in this file:

* **Clocks** — ``SimClock`` (manually advanced virtual time, for trace
  replay) and ``WallClock`` share one ``now()`` interface, so the same
  queue drives both simulations and live orchestration.
* **Job states** — PENDING → RUNNING → COMPLETED (or CANCELLED), plus
  PREEMPTED: a running job displaced by a revoke or a preemptive
  policy is requeued (PREEMPTED behaves like PENDING for scheduling)
  with preemption-count and requeue-wait accounting in ``QueueStats``.
* **Timed release** — a RUNNING job with a walltime is completed
  automatically once its end time passes; its resources go back through
  ``release``/``match_shrink`` (the bottom-up subtractive transform),
  removing spliced-in vertices at the leaf and returning them to the
  parent's free pool.  ``_finish`` is idempotent: a cancel racing a
  passed walltime deadline cannot double-release a path.
* **Grow escalation** — with ``allow_grow=True`` a job that does not
  fit locally escalates through the scheduler hierarchy (and, at the
  top, to the External API) via the shared MATCHGROW engine; a
  preemptive policy additionally arms the engine's revoke path, so the
  grow may displace lower-priority sibling-subtree allocations.
* **Revocation** — the queue registers itself on its scheduler's
  ``revoke_listeners``; when the hierarchy evicts one of its
  allocations, every affected job is requeued PREEMPTED → PENDING and
  rescheduled on the next step.
* **Malleable grow/shrink** — ``grow_job``/``shrink_job`` resize a
  RUNNING job's allocation through the same MATCHGROW / release paths,
  keeping job paths, scheduler allocations, and utilization integrals
  in exact agreement (this is how ``ElasticRuntime`` resizes training
  jobs, so training and batch work share one lifecycle).
* **Typed events** — every transition is appended to the queue's
  ``EventLog`` (``core/events.py``); the scheduler and the MATCHGROW
  engine emit into the same log (RELEASE, GROW, REVOKE), so consumers
  of the ``Instance`` facade (``core/api.py``) observe the whole story
  by live subscription or cursor replay instead of polling state.

Policy, delegated (see ``core/policy.py``):

* pending-queue **order** (``policy.sort_key``),
* **backfill** behind a blocked head (``policy.backfill``), including
  any reservation semantics (EASY's shadow time, conservative's full
  reservation profile, firstfit's none),
* **preemption decisions** (``policy.preempt_victims`` for intra-queue
  eviction; ``policy.preemptive`` arming cross-tenant revokes).
"""
from __future__ import annotations

import bisect
import enum
import itertools
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_rlock
from .events import EventLog, EventType
from .jobspec import Jobspec
from .policy import (EasyBackfill, PriorityFCFS, ReservationLedger,
                     SchedulingPolicy, _path_type_counts, _PendingMirror)
from .scheduler import SchedulerInstance


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    COMPLETED = "completed"
    CANCELLED = "cancelled"
    PREEMPTED = "preempted"     # displaced, back in the pending queue


# ---------------------------------------------------------------------- #
# clocks
# ---------------------------------------------------------------------- #
class Clock:
    """Minimal time source: ``now() -> float`` seconds."""

    def now(self) -> float:
        raise NotImplementedError


class WallClock(Clock):
    """Monotonic wall time, zeroed at construction."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0


class SimClock(Clock):
    """Virtual time for trace replay; only ``advance``/``set`` move it."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        assert dt >= 0, "time cannot run backwards"
        self._now += dt
        return self._now

    def set(self, t: float) -> float:
        assert t >= self._now, "time cannot run backwards"
        self._now = t
        return self._now


# ---------------------------------------------------------------------- #
# jobs
# ---------------------------------------------------------------------- #
@dataclass
class Job:
    """One queue entry.  ``alloc_id`` is the *scheduler* allocation the
    job's resources are bound to; several jobs may share one alloc_id
    (the orchestrator's replicas grow a single allocation), each owning
    its own ``paths`` slice."""

    jobid: str
    jobspec: Jobspec
    alloc_id: str
    walltime: Optional[float] = None    # None = runs until cancelled
    priority: int = 0
    preemptible: bool = False           # may a revoke displace it?
    submit_time: float = 0.0
    start_time: Optional[float] = None
    end_time: Optional[float] = None    # scheduled completion
    state: JobState = JobState.PENDING
    paths: List[str] = field(default_factory=list)
    via: Optional[str] = None           # where MG sourced the resources
    grow: Optional[bool] = None         # per-job override of allow_grow
    seq: int = 0
    preemptions: int = 0                # times displaced and requeued
    requeue_wait: float = 0.0           # time spent PREEMPTED, total
    preempted_at: Optional[float] = None
    # queue-internal memo: graph.version at which this job last failed
    # to match.  While the graph is unchanged the same DFS would fail
    # identically, so _try_start skips it (deep-backlog replays would
    # otherwise re-run every pending job's failing match per kick).
    nogo_version: Optional[int] = None
    # batched-prefilter memo: graph.version of the shared-mask scan
    # that last classified this job, and its verdict (policy.py's
    # _batch_prefilter writes these, _prefilter_ok reads them)
    _pf_version: Optional[int] = None
    _pf_ok: bool = True
    # EASY skip memo: (graph.version, head.seq) under which every
    # backfill test already decided "no start" for this job
    _bf_version: Optional[int] = None
    _bf_head: Optional[int] = None

    @property
    def wait_time(self) -> Optional[float]:
        if self.start_time is None:
            return None
        return self.start_time - self.submit_time


@dataclass
class QueueStats:
    submitted: int
    started: int
    completed: int
    pending: int
    mean_wait: float
    p50_wait: float
    max_wait: float
    utilization: float       # busy vertex-seconds / capacity vertex-seconds
    makespan: float
    preemptions: int = 0            # eviction events, total
    preempted_jobs: int = 0         # distinct jobs ever displaced
    mean_requeue_wait: float = 0.0  # mean PREEMPTED->restart gap per event


# ---------------------------------------------------------------------- #
# the queue
# ---------------------------------------------------------------------- #
class JobQueue:
    """Pending-job queue + lifecycle engine over one scheduler instance.

    ``policy`` selects the scheduling policy (default:
    :class:`~repro_torch.core.policy.EasyBackfill`, the historical
    priority+EASY behavior; ``backfill=False`` is shorthand for
    :class:`~repro_torch.core.policy.PriorityFCFS`).  ``allow_grow`` lets
    jobs that fail local MA escalate through the hierarchy / External
    API via MATCHGROW.
    """

    def __init__(self, scheduler: SchedulerInstance,
                 clock: Optional[Clock] = None,
                 backfill: bool = True,
                 allow_grow: bool = False,
                 policy: Optional[SchedulingPolicy] = None,
                 eventlog: Optional[EventLog] = None):
        self.scheduler = scheduler
        # one queue, one time base: a caller-supplied event log that
        # already has a clock defines it (unless the caller also passed
        # an explicit clock, which then wins below)
        if clock is None and eventlog is not None \
                and eventlog.clock is not None:
            clock = eventlog.clock
        self.clock = clock or WallClock()
        if policy is None:
            policy = EasyBackfill() if backfill else PriorityFCFS()
        self.policy = policy
        self.backfill = backfill        # legacy flag; policy governs
        self.allow_grow = allow_grow
        self.pending: List[Job] = []
        self.running: List[Job] = []
        self.completed: List[Job] = []
        self.events: List[str] = []
        self.max_events = 10_000        # bounded history for long runs
        # typed event surface (core/events.py): the queue, the engine,
        # and the scheduler all emit into one log per queue, so every
        # consumer observes the same total order
        self.eventlog = eventlog if eventlog is not None \
            else EventLog(clock=self.clock)
        if self.eventlog.clock is not self.clock:
            # clock coherence: every JobEvent must be stamped with the
            # owning queue's clock (sim or wall) — a caller-supplied
            # log with no clock would stamp t=0.0 forever, and one with
            # a different clock would skew every latency metric derived
            # from the stream
            self.eventlog.clock = self.clock
        if scheduler.eventlog is None:
            scheduler.eventlog = self.eventlog
        self.n_preemptions = 0
        # incremental reservation ledger (core/policy.py): per-type
        # release timelines of the running jobs, delta-updated by the
        # lifecycle edges below (all under _api_lock) and consumed by
        # the policies' shadow/reservation estimators
        self.ledger = ReservationLedger()
        self.n_prefilter_batches = 0    # vectorized prefilter scans run
        # columnar mirror of self.pending (core/policy.py): the
        # vectorized exact-EASY pass reads it; every pending mutation
        # below keeps it in sync O(1)
        self._pmirror = _PendingMirror()
        # one lock serializes EVERY mutation of the queue's lists: the
        # public verbs below take it themselves, so every driver —
        # Instance verbs on RPC session threads, MultiTenantTree's
        # joint step/advance, direct callers — is covered, as is the
        # hierarchy's revoke listener (which fires on whatever thread
        # ran the preemptive grow).  Re-entrant, so the in-proc
        # escalation path (step under the lock -> engine revoke ->
        # _on_revoked on the same thread) cannot self-deadlock.
        # Ordering caveat: a cross-tenant revoke acquires the VICTIM
        # queue's lock while the grower's is held, so two mutually
        # preemptive tenants driven from two threads could deadlock
        # AB-BA; drive mutually preemptive trees from one thread (the
        # MultiTenantTree pattern) or make preemption one-directional.
        # allow_transport: this is the ONE lock deliberately held
        # across transport calls (the escalation design) — see
        # docs/CONCURRENCY.md.
        self._api_lock = named_rlock(
            f"jobqueue:{getattr(scheduler, 'name', 'q')}",
            allow_transport=True)
        self._seq = itertools.count()
        self._by_id: Dict[str, Job] = {}
        # scheduling memo: a blocked head is not re-escalated through
        # the hierarchy (one RPC per level per attempt) until queue or
        # resource state actually changed
        self._version = 0
        self._sched_version = -1
        # anti-thrash: a head whose eviction round did NOT let it start
        # (structural fragmentation despite covering counts) must not
        # evict again until resource state really changes (a finish)
        self._preempt_blocked: set = set()
        # time-weighted utilization accounting
        self._last_t = self.clock.now()
        self._busy_integral = 0.0
        self._cap_integral = 0.0
        # requeue victims the hierarchy revokes out from under us
        scheduler.revoke_listeners.append(self._on_revoked)

    # ------------------------------------------------------------------ #
    # submission / cancellation
    # ------------------------------------------------------------------ #
    def submit(self, jobspec: Jobspec, walltime: Optional[float] = None,
               priority: int = 0, alloc_id: Optional[str] = None,
               jobid: Optional[str] = None,
               grow: Optional[bool] = None,
               preemptible: bool = False) -> Job:
        """Enqueue a job.  ``grow`` overrides the queue's ``allow_grow``
        for this job only (True: may escalate via MATCHGROW; False:
        strictly local MATCHALLOCATE; None: queue default).
        ``preemptible`` marks the job's allocation as revocable by
        higher-priority work (cross-tenant revokes and preemptive
        policies only ever displace preemptible jobs)."""
        with self._api_lock:
            self._accrue()
            seq = next(self._seq)
            jobid = jobid or f"q{seq}-{self.scheduler.name}"
            job = Job(jobid=jobid, jobspec=jobspec,
                      alloc_id=alloc_id or jobid, walltime=walltime,
                      priority=priority, submit_time=self.clock.now(),
                      grow=grow, seq=seq, preemptible=preemptible)
            self._by_id[jobid] = job
            self._version += 1
            # insort_right == append + stable sort, without the O(n)
            # key calls per submit a 100k-deep backlog would pay
            bisect.insort(self.pending, job, key=self.policy.sort_key)
            self._pmirror.add(job)
            self._log(f"t={job.submit_time:.3f} submit {jobid}")
            self.eventlog.emit(EventType.SUBMIT, jobid,
                               alloc_id=job.alloc_id,
                               priority=priority, walltime=walltime)
            return job

    def dispatch(self, jobspec: Jobspec, walltime: Optional[float] = None,
                 priority: int = 0, alloc_id: Optional[str] = None,
                 jobid: Optional[str] = None,
                 grow: Optional[bool] = None,
                 preemptible: bool = False) -> Job:
        """Controller path: submit + try to start *this* job right now,
        regardless of the queue's head-of-line state (a reconciler like
        the orchestrator must not be wedged behind an unrelated blocked
        batch job).  The job stays PENDING if it cannot start."""
        with self._api_lock:
            job = self.submit(jobspec, walltime=walltime,
                              priority=priority, alloc_id=alloc_id,
                              jobid=jobid, grow=grow,
                              preemptible=preemptible)
            self._complete_due()
            if self._try_start(job):
                self._activate(job)
            return job

    def get(self, jobid: str) -> Optional[Job]:
        return self._by_id.get(jobid)

    def cancel(self, jobid: str) -> bool:
        with self._api_lock:
            job = self._by_id.get(jobid)
            if job is None:
                return False
            if job.state in (JobState.PENDING, JobState.PREEMPTED):
                # a job that never ran leaves no trace: controllers
                # retry blocked submissions every reconcile tick, and
                # retaining each attempt would grow _by_id (and stats)
                # without bound
                self.pending.remove(job)
                self._pmirror.discard(job)
                self._by_id.pop(jobid, None)
                self._version += 1
                job.state = JobState.CANCELLED
                self.eventlog.emit(EventType.FREE, jobid,
                                   state=JobState.CANCELLED.value,
                                   alloc_id=job.alloc_id)
                return True
            if job.state is JobState.RUNNING:
                self._accrue()
                self._finish(job, JobState.CANCELLED)
                return True
            return False

    def running_for(self, alloc_id: str) -> List[Job]:
        """RUNNING jobs bound to one scheduler allocation, oldest first."""
        with self._api_lock:
            return [j for j in self.running if j.alloc_id == alloc_id]

    # ------------------------------------------------------------------ #
    # lifecycle engine
    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """Complete due jobs, then schedule from the queue.  Returns the
        number of jobs started."""
        with self._api_lock:
            self._accrue()
            self._complete_due()
            return self._schedule()

    def advance(self, dt: float) -> int:
        """Advance a SimClock by ``dt``, stopping at every completion
        event on the way so releases and starts interleave in order."""
        clock = self.clock
        assert isinstance(clock, SimClock), "advance() needs a SimClock"
        with self._api_lock:
            target = clock.now() + dt
            started = 0
            while True:
                due = [j.end_time for j in self.running
                       if j.end_time is not None and j.end_time <= target]
                if not due:
                    break
                self._accrue()
                clock.set(min(due))
                started += self.step()
            self._accrue()
            clock.set(target)
            started += self.step()
            return started

    def drain(self, max_events: int = 100_000) -> List[Job]:
        """Run a SimClock queue until nothing is running and nothing
        more can start.  Returns the completed jobs."""
        clock = self.clock
        assert isinstance(clock, SimClock), "drain() needs a SimClock"
        with self._api_lock:
            for _ in range(max_events):
                self.step()
                nxt = [j.end_time for j in self.running
                       if j.end_time is not None]
                if nxt:
                    self._accrue()
                    clock.set(max(min(nxt), clock.now()))
                    continue
                if not self.pending:
                    break
                # pending but nothing running, nothing startable: stuck
                if self.step() == 0:
                    break
            return list(self.completed)

    # -- internals ----------------------------------------------------- #
    def _log(self, line: str) -> None:
        self.events.append(line)
        if len(self.events) > self.max_events:
            del self.events[:len(self.events) - self.max_events]

    def _accrue(self) -> None:
        now = self.clock.now()
        dt = now - self._last_t
        if dt > 0:
            busy = sum(len(j.paths) for j in self.running)
            self._busy_integral += busy * dt
            self._cap_integral += self.scheduler.graph.num_vertices * dt
            self._last_t = now

    def _complete_due(self) -> None:
        now = self.clock.now()
        due = sorted((j for j in self.running
                      if j.end_time is not None and j.end_time <= now),
                     key=lambda j: j.end_time)
        for job in due:
            self._finish(job, JobState.COMPLETED)

    def _finish(self, job: Job, state: JobState) -> None:
        """Timed release: hand the job's resources back bottom-up.
        ``release`` frees local vertices in place, evicts external and
        spliced-in copies, and propagates up the hierarchy, so one call
        covers every ``via`` a grow can have.  Idempotent: finishing a
        job that already left ``running`` (cancel racing a passed
        walltime deadline, a double cancel) is a no-op — the paths were
        released exactly once."""
        if job not in self.running:
            return
        self.scheduler.release(job.alloc_id, job.paths)
        self.running.remove(job)
        self.ledger.job_departed(job.jobid)
        self._preempt_blocked.clear()   # resource state really changed
        job.state = state
        job.end_time = min(job.end_time, self.clock.now()) \
            if job.end_time is not None else self.clock.now()
        if state is JobState.COMPLETED:
            self.completed.append(job)
        else:
            # cancelled jobs leave no trace: a controller churning
            # replicas up and down (the orchestrator autoscaler) must
            # not grow queue history and stats without bound
            self._by_id.pop(job.jobid, None)
        # the departing job must stop pinning the shared allocation's
        # revocability (e.g. a finished priority-9 job leaving only a
        # priority-0 one behind)
        self._sync_alloc_meta(job.alloc_id)
        self._version += 1
        self._log(f"t={self.clock.now():.3f} {state.value} {job.jobid}")
        self.eventlog.emit(EventType.FREE, job.jobid, state=state.value,
                           alloc_id=job.alloc_id)

    def _try_start(self, job: Job) -> bool:
        sched = self.scheduler
        grow = self.allow_grow if job.grow is None else job.grow
        # With no parent, no external provider, and a non-preemptive
        # policy, a match attempt is a pure function of the local
        # graph: a job that failed at this graph version fails again
        # until something mutates it.  (A parent, cloud bursting, or
        # preemption makes the outcome depend on remote state or revoke
        # side effects, so no memo; kick() clears memos for the
        # mutate-a-Job-from-outside contract.)
        pure = (sched.parent is None and sched.external is None
                and not self.policy.preemptive)
        if pure and job.nogo_version == sched.graph.version:
            return False
        if grow:
            res = sched.match_grow(job.jobspec, job.alloc_id,
                                   priority=job.priority,
                                   preempt=self.policy.preemptive)
            if not res:
                if pure:
                    job.nogo_version = sched.graph.version
                return False
            job.paths = res.paths()
            job.via = res.via
            if res.victims:
                self._log(f"t={self.clock.now():.3f} {job.jobid} "
                          f"revoked {','.join(res.victims)}")
        else:
            # strictly local MA; several jobs may share one alloc_id,
            # so record only the delta this job contributed
            prev = sched.allocations.get(job.alloc_id)
            n_prev = len(prev.paths) if prev is not None else 0
            alloc = sched.match_allocate(job.jobspec, jobid=job.alloc_id)
            if alloc is None:
                if pure:
                    job.nogo_version = sched.graph.version
                return False
            job.paths = list(alloc.paths[n_prev:])
            job.via = "local"
        self.eventlog.emit(EventType.ALLOC, job.jobid, via=job.via,
                           n_paths=len(job.paths), alloc_id=job.alloc_id)
        return True

    def _activate(self, job: Job) -> None:
        now = self.clock.now()
        self.pending.remove(job)
        self._pmirror.discard(job)
        job.state = JobState.RUNNING
        job.start_time = now
        job.end_time = now + job.walltime if job.walltime is not None \
            else None
        if job.preempted_at is not None:
            job.requeue_wait += now - job.preempted_at
            job.preempted_at = None
        self.running.append(job)
        self.ledger.job_started(job.jobid, job.end_time,
                                _path_type_counts(self, job))
        self._sync_alloc_meta(job.alloc_id)
        self._version += 1
        self._log(f"t={now:.3f} start {job.jobid} via={job.via} "
                  f"wait={job.wait_time:.3f}")
        self.eventlog.emit(EventType.START, job.jobid, via=job.via,
                           wait=job.wait_time, alloc_id=job.alloc_id)

    def start_if_fits(self, job: Job) -> bool:
        """Policy entry point: try to start one pending job now."""
        with self._api_lock:
            if self._try_start(job):
                self._activate(job)
                return True
            return False

    # ------------------------------------------------------------------ #
    # malleable operations: grow/shrink a RUNNING job's allocation
    # ------------------------------------------------------------------ #
    def grow_job(self, jobid: str, jobspec: Jobspec) -> bool:
        """Grow a RUNNING job's allocation by ``jobspec`` (MATCHGROW
        through the hierarchy; the engine emits the GROW event).  The
        grown vertices join the job's ``paths``, so utilization and
        release accounting stay exact."""
        with self._api_lock:
            job = self._by_id.get(jobid)
            if job is None or job.state is not JobState.RUNNING:
                self.eventlog.emit(EventType.EXCEPTION, jobid, op="grow",
                                   reason="job not running")
                return False
            self._accrue()
            res = self.scheduler.match_grow(jobspec, job.alloc_id,
                                            priority=job.priority,
                                            preempt=self.policy.preemptive)
            if not res:
                return False
            job.paths.extend(res.paths())
            if res.victims:
                self._log(f"t={self.clock.now():.3f} {job.jobid} "
                          f"revoked {','.join(res.victims)}")
            self.ledger.job_resized(job.jobid, job.end_time,
                                    _path_type_counts(self, job))
            self._sync_alloc_meta(job.alloc_id)
            self._version += 1
            self._log(f"t={self.clock.now():.3f} grow {job.jobid} "
                      f"+{len(res.new_paths)} via={res.via}")
            # queue-level GROW keyed by the JOB (the engine's GROW is
            # keyed by the allocation): ``malleable`` marks a mid-run
            # resize, which is the delta metrics consumers add to the
            # job's busy-vertex ledger (start-time grows are already
            # covered by ALLOC's n_paths)
            self.eventlog.emit(EventType.GROW, job.jobid,
                               n_paths=len(res.new_paths), via=res.via,
                               alloc_id=job.alloc_id, malleable=True)
            return True

    def shrink_job(self, jobid: str, paths: Optional[List[str]] = None,
                   count: Optional[int] = None) -> bool:
        """Shrink a RUNNING job's allocation: release ``paths`` (or the
        newest ``count`` of the job's paths) back through the scheduler
        — local vertices return to the free pool, spliced-in/external
        copies leave bottom-up — and keep the job running on the rest.
        The queue's accounting (``paths``, utilization integrals, the
        scheduler allocation) stays consistent; shrinking a job to
        nothing is refused (cancel it instead)."""
        with self._api_lock:
            job = self._by_id.get(jobid)
            if job is None or job.state is not JobState.RUNNING:
                self.eventlog.emit(EventType.EXCEPTION, jobid,
                                   op="shrink",
                                   reason="job not running")
                return False
            if paths is None:
                # validate before slicing: a negative count would slice
                # from the FRONT (paths[-count:] keeps the tail),
                # silently releasing most of the allocation — and this
                # surface is remotely reachable via the RPC ``shrink``
                # verb
                if count is None or count <= 0:
                    self.eventlog.emit(EventType.EXCEPTION, jobid,
                                       op="shrink",
                                       reason="invalid shrink count")
                    return False
                paths = job.paths[-count:]
            doomed = [p for p in paths if p in job.paths]
            if not doomed or len(doomed) >= len(job.paths):
                self.eventlog.emit(EventType.EXCEPTION, jobid,
                                   op="shrink",
                                   reason="would shrink to nothing"
                                   if doomed else "no owned paths given")
                return False
            self._accrue()
            self.scheduler.release(job.alloc_id, doomed)
            gone = set(doomed)
            job.paths = [p for p in job.paths if p not in gone]
            self.ledger.job_resized(job.jobid, job.end_time,
                                    _path_type_counts(self, job))
            self._sync_alloc_meta(job.alloc_id)
            self._version += 1
            self._log(f"t={self.clock.now():.3f} shrink {job.jobid} "
                      f"-{len(doomed)}")
            self.eventlog.emit(EventType.SHRINK, job.jobid,
                               n_paths=len(doomed), alloc_id=job.alloc_id)
            return True

    def _sync_alloc_meta(self, alloc_id: str) -> None:
        """Propagate job priorities to the scheduler allocation so the
        hierarchy's revoke path sees them: an allocation is revocable
        only if *every* job bound to it is preemptible, and carries the
        highest priority among them."""
        alloc = self.scheduler.allocations.get(alloc_id)
        if alloc is None:
            return
        mine = [j for j in self.running if j.alloc_id == alloc_id]
        if mine:
            alloc.priority = max(j.priority for j in mine)
            alloc.preemptible = all(j.preemptible for j in mine)

    # ------------------------------------------------------------------ #
    # preemption mechanism (decisions live in the policy / the engine)
    # ------------------------------------------------------------------ #
    def preempt(self, job: Job) -> None:
        """Evict one RUNNING job of this queue: release its resources
        and requeue it (PREEMPTED, scheduled like PENDING)."""
        with self._api_lock:
            if job not in self.running:
                return
            self._accrue()
            self.scheduler.release(job.alloc_id, job.paths)
            self._requeue(job)

    def _on_revoked(self, alloc_id: str, paths: List[str]) -> None:
        """revoke_listener: the hierarchy already released the
        allocation out from under us — requeue every job bound to it
        (resources are gone; do NOT release again).  Runs on whatever
        thread performed the preemptive grow (an RPC session thread
        when a sibling grew through the parent), so it must take the
        queue's API lock before touching running/pending."""
        with self._api_lock:
            for job in [j for j in self.running
                        if j.alloc_id == alloc_id]:
                self._accrue()
                self._requeue(job)

    def _requeue(self, job: Job) -> None:
        now = self.clock.now()
        if job in self.running:
            self.running.remove(job)
        job.state = JobState.PREEMPTED
        job.paths = []
        job.via = None
        job.start_time = None
        job.end_time = None
        job.preemptions += 1
        job.preempted_at = now
        self.n_preemptions += 1
        self.ledger.job_departed(job.jobid)
        self._sync_alloc_meta(job.alloc_id)
        bisect.insort(self.pending, job, key=self.policy.sort_key)
        self._pmirror.add(job)
        self._version += 1
        self._log(f"t={now:.3f} preempt {job.jobid} "
                  f"(n={job.preemptions})")
        self.eventlog.emit(EventType.PREEMPT, job.jobid,
                           alloc_id=job.alloc_id, n=job.preemptions)

    def kick(self) -> None:
        """Force the next step() to re-attempt scheduling even though
        the queue saw no event — call after mutating scheduler state or
        a pending Job from outside the queue's own API."""
        with self._api_lock:
            self._version += 1
            for job in self.pending:
                job.nogo_version = None
                job._pf_version = None
                job._bf_version = None
            # externally mutated Job fields (priority, walltime)
            # invalidate the pending mirror's columns the same way
            self._pmirror.resync(self.pending)
            self._sigv_fit = None
            self._sigv_delays = None

    def _schedule(self) -> int:
        # nothing changed since the last full pass ended blocked: a
        # retry would re-run the same failing matches and hierarchy
        # RPCs (and append a failure MGTiming per level) for nothing
        if self._version == self._sched_version:
            return 0
        started = 0
        while self.pending:
            head = self.pending[0]
            if self._try_start(head):
                self._activate(head)
                started += 1
                continue
            victims = [] if head.jobid in self._preempt_blocked \
                else self.policy.preempt_victims(self, head)
            if victims:
                for victim in victims:
                    self.preempt(victim)
                if self._try_start(head):
                    self._activate(head)
                    started += 1
                    continue
                self._preempt_blocked.add(head.jobid)
            started += self.policy.backfill(self, head)
            break
        self._sched_version = self._version
        return started

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def stats(self) -> QueueStats:
        with self._api_lock:
            self._accrue()
            waits = sorted(j.wait_time
                           for j in self.completed + self.running
                           if j.wait_time is not None)
            done = [j for j in self.completed
                    if j.state is JobState.COMPLETED]
            util = (self._busy_integral / self._cap_integral
                    if self._cap_integral > 0 else 0.0)
            displaced = [j for j in
                         self.completed + self.running + self.pending
                         if j.preemptions > 0]
            n_events = sum(j.preemptions for j in displaced)
            rq_wait = sum(j.requeue_wait for j in displaced)
            return QueueStats(
                submitted=len(self._by_id),
                started=len(waits),
                completed=len(done),
                pending=len(self.pending),
                mean_wait=sum(waits) / len(waits) if waits else 0.0,
                p50_wait=waits[len(waits) // 2] if waits else 0.0,
                max_wait=waits[-1] if waits else 0.0,
                utilization=util,
                makespan=self.clock.now(),
                preemptions=self.n_preemptions,
                preempted_jobs=len(displaced),
                mean_requeue_wait=rq_wait / n_events if n_events else 0.0,
            )


def _req_type_counts(jobspec: Jobspec) -> Dict[str, int]:
    """Back-compat alias; see :meth:`Jobspec.type_counts`."""
    return jobspec.type_counts()
