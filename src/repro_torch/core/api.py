"""`Instance`: the one public service surface over the whole hierarchy.

The paper's core claim is that one dynamic graph model plus fully
hierarchical scheduling serves batch jobs, cloud bursting, and
orchestration-framework tasks through a *single* interface.  This
module is that interface.  Every consumer — the orchestrator, the
elastic training runtime, tenancy, benchmarks, examples, and remote
clients — talks to an :class:`Instance` and holds :class:`JobHandle`\\ s;
none of them touch ``JobQueue`` internals, call ``match_grow``
directly, or poll scheduler state (the Flux-Operator lesson: converged
consumers need a uniform instance API plus an event journal, not
internals access).

The surface:

* ``submit(jobspec, ...) -> JobHandle`` — enqueue work; the handle
  exposes ``wait()``, ``result()``, ``cancel()``, ``grow()``,
  ``shrink()``.  Grow/shrink are *malleable requests through the
  queue* — first-class, observable operations with GROW/SHRINK events
  flowing back — not direct engine calls.
* a typed event journal (``core/events.py``): ``subscribe`` for live
  callbacks, ``events_since(cursor)`` for replay, so simulated and
  wall-clock consumers observe identically.
* the **same API served remotely**: ``Instance`` registers ``submit`` /
  ``cancel`` / ``wait`` / ``events_since`` / ``job`` / ``grow`` /
  ``shrink`` / ``step`` / ``advance`` on the scheduler's
  :class:`~repro_torch.core.rpc.MethodRegistry` (joining the ``usage`` the
  scheduler already serves), so a :class:`RemoteInstance` over
  ``SocketTransport`` drives a tree it doesn't own with the identical
  verbs — the paper's nested-instance story.

Time: with a ``SimClock``, ``wait`` *drives* the queue (step + advance
to each completion) until the job is terminal or nothing can progress;
with a ``WallClock`` it polls.  ``step`` / ``advance`` / ``drain`` are
exposed for consumers that drive time explicitly.
"""
from __future__ import annotations

import threading
import time as _time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from ..analysis.lockwitness import named_lock
from .events import EventLog, EventType, JobEvent
from .external import ExternalProvider
from .graph import ResourceGraph
from .jobspec import Jobspec
from .policy import SchedulingPolicy
from .queue import Clock, Job, JobQueue, JobState, QueueStats, SimClock
from .rpc import Transport, pack_json, unpack_json
from .scheduler import SchedulerInstance

_TERMINAL = (JobState.COMPLETED, JobState.CANCELLED)


class JobHandle:
    """A submitted job, as seen by its owner.

    Thin and live: state reads through to the queue's Job record, and
    every verb routes back through the owning :class:`Instance` (so the
    same handle class fronts local and — via :class:`RemoteJobHandle` —
    remote jobs)."""

    def __init__(self, api: "Instance", job: Job):
        self._api = api
        self._job = job
        self.jobid = job.jobid

    # -- observation -------------------------------------------------- #
    @property
    def job(self) -> Job:
        """The live queue record (read it, don't mutate it)."""
        return self._job

    @property
    def state(self) -> JobState:
        return self._job.state

    @property
    def via(self) -> Optional[str]:
        return self._job.via

    @property
    def paths(self) -> List[str]:
        return list(self._job.paths)

    @property
    def start_time(self) -> Optional[float]:
        return self._job.start_time

    @property
    def wait_time(self) -> Optional[float]:
        return self._job.wait_time

    @property
    def preemptions(self) -> int:
        return self._job.preemptions

    @property
    def requeue_wait(self) -> float:
        return self._job.requeue_wait

    def events(self) -> List[JobEvent]:
        """Every event this job emitted, in order."""
        return self._api.events.for_job(self.jobid)

    # -- verbs -------------------------------------------------------- #
    def wait(self, timeout: Optional[float] = None) -> JobState:
        return self._api.wait(self.jobid, timeout=timeout)

    def result(self, timeout: Optional[float] = None) -> Dict:
        """Wait, then return the job's summary record."""
        self.wait(timeout=timeout)
        return self._api.job(self.jobid)

    def cancel(self) -> bool:
        return self._api.cancel(self.jobid)

    def grow(self, jobspec: Jobspec) -> bool:
        """Malleable grow: MATCHGROW more resources onto this job."""
        return self._api.grow(self.jobid, jobspec)

    def shrink(self, paths: Optional[List[str]] = None,
               count: Optional[int] = None) -> bool:
        """Malleable shrink: give ``paths`` (or the newest ``count``
        paths) back while the job keeps running."""
        return self._api.shrink(self.jobid, paths=paths, count=count)

    def __repr__(self) -> str:   # pragma: no cover - debugging aid
        return f"JobHandle({self.jobid!r}, {self._job.state.value})"


class Instance:
    """The facade: one submit/handle/event surface over a scheduler
    (and, through grow escalation, the whole hierarchy above it).

    Build it from a graph (it makes the ``SchedulerInstance``), from an
    existing scheduler, or around an existing ``JobQueue`` (the queue's
    clock/policy/event log are adopted, so one queue never ends up with
    two logs)."""

    def __init__(self, scheduler: Optional[SchedulerInstance] = None, *,
                 graph: Optional[ResourceGraph] = None,
                 name: str = "instance",
                 clock: Optional[Clock] = None,
                 policy: Optional[SchedulingPolicy] = None,
                 backfill: bool = True,
                 allow_grow: bool = False,
                 external: Optional[ExternalProvider] = None,
                 queue: Optional[JobQueue] = None):
        if queue is not None:
            self.queue = queue
            self.scheduler = queue.scheduler
        else:
            if scheduler is None:
                if graph is None:
                    raise ValueError(
                        "Instance needs a scheduler, a queue, or a graph")
                scheduler = SchedulerInstance(name, graph,
                                              external=external)
            self.scheduler = scheduler
            self.queue = JobQueue(scheduler, clock=clock,
                                  backfill=backfill,
                                  allow_grow=allow_grow, policy=policy)
        self.clock = self.queue.clock
        self.events: EventLog = self.queue.eventlog
        # the served surface runs in RPCServer session threads while
        # the owner drives the same queue from its own thread; the
        # JobQueue owns the lock and its public verbs (and the revoke
        # listener) take it themselves, so Instance only re-enters it
        # here to make composite operations (submit+step in wait,
        # list+wrap in running/pending) atomic.  Two Instances
        # wrapping one queue therefore share one lock.
        self._lock = self.queue._api_lock
        # wall-clock waiters park on this condition and are woken by
        # terminal events (FREE / EXCEPTION) instead of spinning on a
        # fixed 2ms sleep; the timed wait below is only the fallback
        self._wait_cond = threading.Condition()
        self.events.subscribe(self._on_terminal_event)
        self._register_methods()
        self._broadcaster = _EventStreamBroadcaster(self.events)
        self.scheduler.register_stream("subscribe", self._broadcaster.open)

    def _on_terminal_event(self, ev: JobEvent) -> None:
        if ev.type is EventType.FREE or ev.type is EventType.EXCEPTION:
            with self._wait_cond:
                self._wait_cond.notify_all()

    # ------------------------------------------------------------------ #
    # the local surface
    # ------------------------------------------------------------------ #
    def submit(self, jobspec: Jobspec, *, walltime: Optional[float] = None,
               priority: int = 0, preemptible: bool = False,
               grow: Optional[bool] = None,
               alloc_id: Optional[str] = None,
               jobid: Optional[str] = None,
               dispatch: bool = False) -> JobHandle:
        """Enqueue a job and return its handle.  ``dispatch=True`` is
        the controller path: try to start *this* job immediately,
        regardless of the queue's head-of-line state."""
        fn = self.queue.dispatch if dispatch else self.queue.submit
        job = fn(jobspec, walltime=walltime, priority=priority,
                 alloc_id=alloc_id, jobid=jobid, grow=grow,
                 preemptible=preemptible)
        return JobHandle(self, job)

    def cancel(self, jobid: str) -> bool:
        return self.queue.cancel(jobid)

    def grow(self, jobid: str, jobspec: Jobspec) -> bool:
        return self.queue.grow_job(jobid, jobspec)

    def shrink(self, jobid: str, paths: Optional[List[str]] = None,
               count: Optional[int] = None) -> bool:
        return self.queue.shrink_job(jobid, paths=paths, count=count)

    def submit_many(self, jobspecs: Iterable[Jobspec], *,
                    walltime: Optional[float] = None, priority: int = 0,
                    preemptible: bool = False,
                    grow: Optional[bool] = None,
                    alloc_id: Optional[str] = None,
                    dispatch: bool = False) -> List[JobHandle]:
        """Batched submit: one atomic enqueue of many jobs (and, for
        :class:`RemoteInstance`, one round-trip instead of N)."""
        with self._lock:
            return [self.submit(js, walltime=walltime, priority=priority,
                                preemptible=preemptible, grow=grow,
                                alloc_id=alloc_id, dispatch=dispatch)
                    for js in jobspecs]

    def grow_many(self, grows: Iterable[Tuple[str, Jobspec]]
                  ) -> List[bool]:
        """Batched malleable grow: ``[(jobid, jobspec), ...]`` applied
        in order; returns per-request success."""
        with self._lock:
            return [self.grow(jobid, js) for jobid, js in grows]

    def wait(self, jobid: str, timeout: Optional[float] = None
             ) -> Optional[JobState]:
        """Block (wall clock) or drive (sim clock) until ``jobid`` is
        terminal.  Returns the final observed state, or the current one
        on timeout / when the queue can no longer progress."""
        job = self.queue.get(jobid)
        if job is None:
            return None
        if isinstance(self.clock, SimClock):
            for _ in range(100_000):
                if job.state in _TERMINAL:
                    break
                # lock per iteration, not across the whole wait: other
                # clients keep submitting while this one drives time
                with self._lock:
                    if job.state not in _TERMINAL:
                        self.queue.step()
                    if job.state in _TERMINAL:
                        break
                    nxt = [j.end_time for j in self.queue.running
                           if j.end_time is not None]
                    if not nxt:
                        break           # stuck: nothing will complete
                    self.clock.set(max(min(nxt), self.clock.now()))
        else:
            deadline = (_time.monotonic() + timeout
                        if timeout is not None else None)
            while job.state not in _TERMINAL:
                with self._lock:
                    self.queue.step()
                if job.state in _TERMINAL:
                    break
                if deadline is not None and _time.monotonic() > deadline:
                    break
                # park until a terminal event wakes us (the notifier
                # may hold the queue lock, so never step() while
                # holding the condition); the timed wait is only the
                # WallClock fallback for completions that happen with
                # no event — e.g. a walltime expiring between steps
                with self._wait_cond:
                    if job.state in _TERMINAL:
                        break
                    remaining = (deadline - _time.monotonic()
                                 if deadline is not None else None)
                    if remaining is not None and remaining <= 0:
                        break
                    self._wait_cond.wait(
                        timeout=min(0.05, remaining)
                        if remaining is not None else 0.05)
        return job.state

    def job(self, jobid: str) -> Optional[Dict]:
        """Summary record for one job (JSON-serializable)."""
        job = self.queue.get(jobid)
        if job is None:
            return None
        return {
            "jobid": job.jobid, "state": job.state.value,
            "alloc_id": job.alloc_id, "priority": job.priority,
            "preemptible": job.preemptible,
            "submit_time": job.submit_time,
            "start_time": job.start_time, "end_time": job.end_time,
            "n_paths": len(job.paths), "via": job.via,
            "preemptions": job.preemptions,
        }

    def running(self, alloc_id: Optional[str] = None) -> List[JobHandle]:
        """Handles for RUNNING jobs, optionally restricted to one
        scheduler allocation, oldest first."""
        with self._lock:
            return [JobHandle(self, j) for j in self.queue.running
                    if alloc_id is None or j.alloc_id == alloc_id]

    def pending(self, alloc_id: Optional[str] = None) -> List[JobHandle]:
        """Handles for queued (PENDING / PREEMPTED) jobs, optionally
        restricted to one scheduler allocation, in policy order."""
        with self._lock:
            return [JobHandle(self, j) for j in self.queue.pending
                    if alloc_id is None or j.alloc_id == alloc_id]

    def events_since(self, cursor: int = 0
                     ) -> Tuple[List[JobEvent], int]:
        return self.events.since(cursor)

    def subscribe(self, cb: Callable[[JobEvent], None]
                  ) -> Callable[[], None]:
        return self.events.subscribe(cb)

    def usage(self) -> Dict[str, int]:
        return self.scheduler.usage()

    def stats(self) -> QueueStats:
        return self.queue.stats()

    # -- time driving -------------------------------------------------- #
    def step(self) -> int:
        return self.queue.step()

    def advance(self, dt: float) -> int:
        return self.queue.advance(dt)

    def drain(self) -> List[Job]:
        return self.queue.drain()

    # -- serving ------------------------------------------------------- #
    def serve(self) -> Tuple[str, int]:
        """Expose this instance (scheduler RPC + the API surface) over
        a loopback socket; returns the address for RemoteInstance."""
        return self.scheduler.serve()

    def close(self) -> None:
        self.scheduler.close()

    # ------------------------------------------------------------------ #
    # the served surface (same verbs, over MethodRegistry)
    # ------------------------------------------------------------------ #
    def _register_methods(self) -> None:
        reg = self.scheduler.register_method
        reg("submit", self._rpc_submit)
        reg("submit_many", self._rpc_submit_many)
        reg("grow_many", self._rpc_grow_many)
        reg("cancel", self._rpc_cancel)
        reg("wait", self._rpc_wait)
        reg("job", self._rpc_job)
        reg("grow", self._rpc_grow)
        reg("shrink", self._rpc_shrink)
        reg("events_since", self._rpc_events_since)
        reg("step", self._rpc_step)
        reg("advance", self._rpc_advance)
        # ``usage`` is already served by the SchedulerInstance itself,
        # completing the remote surface.

    def _rpc_submit(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        try:
            h = self.submit(Jobspec.from_dict(req["jobspec"]),
                            walltime=req.get("walltime"),
                            priority=req.get("priority", 0),
                            preemptible=bool(req.get("preemptible",
                                                     False)),
                            grow=req.get("grow"),
                            alloc_id=req.get("alloc_id"),
                            jobid=req.get("jobid"),
                            dispatch=bool(req.get("dispatch", False)))
        except Exception as exc:
            self.events.emit(EventType.EXCEPTION,
                             req.get("jobid") or "?", op="submit",
                             reason=str(exc))
            return pack_json({"error": str(exc)})
        return pack_json({"jobid": h.jobid, "state": h.state.value})

    def _rpc_submit_many(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        with self._lock:
            out = [unpack_json(self._rpc_submit(pack_json(j)))
                   for j in req.get("jobs", [])]
        return pack_json({"jobs": out})

    def _rpc_grow_many(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        with self._lock:
            oks = [bool(self.grow(g["jobid"],
                                  Jobspec.from_dict(g["jobspec"])))
                   for g in req.get("grows", [])]
        return pack_json({"ok": oks})

    def _rpc_cancel(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        return pack_json({"ok": self.cancel(req["jobid"])})

    def _rpc_wait(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        state = self.wait(req["jobid"], timeout=req.get("timeout"))
        return pack_json({"state": state.value if state else None})

    def _rpc_job(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        return pack_json({"job": self.job(req["jobid"])})

    def _rpc_grow(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        ok = self.grow(req["jobid"], Jobspec.from_dict(req["jobspec"]))
        return pack_json({"ok": ok})

    def _rpc_shrink(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        ok = self.shrink(req["jobid"], paths=req.get("paths"),
                         count=req.get("count"))
        return pack_json({"ok": ok})

    def _rpc_events_since(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        events, cursor = self.events_since(req.get("cursor", 0))
        return pack_json({"events": [e.to_dict() for e in events],
                          "cursor": cursor})

    def _rpc_step(self, payload: bytes) -> bytes:
        return pack_json({"started": self.step()})

    def _rpc_advance(self, payload: bytes) -> bytes:
        req = unpack_json(payload)
        return pack_json({"started": self.advance(req.get("dt", 0.0))})


# ---------------------------------------------------------------------- #
# server-push event streaming
# ---------------------------------------------------------------------- #
def _encode_events(events: List[JobEvent]) -> bytes:
    return pack_json({"events": [e.to_dict() for e in events]})


class _EventStreamBroadcaster:
    """Feeds the ``subscribe`` stream verb from the event log.

    One batch sink on the :class:`EventLog` (attached lazily, detached
    when the last subscriber leaves) fans each delivery chunk out to
    every remote subscriber: the chunk is JSON-encoded *once* and the
    same bytes object is enqueued on every connection — per-event cost
    is independent of the subscriber count.

    ``open`` (the stream verb) first replays the journal from the
    requested cursor in 4096-event frames, then splices the stream into
    live delivery with no gap and no duplicate: replay is capped at the
    last seq the sink has delivered, and registration re-checks that
    watermark under the lock, so an event is pushed by exactly one of
    the two paths.  A cursor older than the journal's retained window
    resumes from the oldest retained event — the same semantics as
    ``events_since`` replay.
    """

    CHUNK = 4096

    def __init__(self, events: EventLog):
        self._events = events
        self._block = named_lock("broadcaster")
        self._streams: List[Dict] = []
        self._unsub: Optional[Callable[[], None]] = None
        self._delivered = 0     # seq just past the sink's last batch
        # replay chunks are immutable once appended (seq identifies an
        # event forever), so a fleet of subscribers replaying the same
        # journal encodes each chunk once, not once per subscriber
        self._replay_cache: Dict[Tuple[int, int], bytes] = {}

    def open(self, payload: bytes, push: Callable[[int, bytes], None]
             ) -> Tuple[bytes, Callable[[], None]]:
        req = unpack_json(payload)
        cursor = req.get("cursor")
        with self._block:
            if self._unsub is None:
                # the sink's join cursor is the log cursor at attach,
                # so everything at or past it arrives via _on_batch
                self._delivered = self._events.cursor
                self._unsub = self._events.add_sink(self._on_batch)
            nxt = self._delivered if cursor is None else cursor
        entry = {"push": push, "next": nxt, "open": True}
        while True:
            with self._block:
                target = self._delivered
                if entry["next"] >= target:
                    self._streams.append(entry)
                    ack = entry["next"]
                    break
            # catch up outside the lock (live delivery to existing
            # subscribers keeps flowing while this one replays)
            events, _ = self._events.since(entry["next"])
            chunk = [e for e in events if e.seq < target]
            if not chunk:
                entry["next"] = target      # window truncated: skip
                continue
            for i in range(0, len(chunk), self.CHUNK):
                part = chunk[i:i + self.CHUNK]
                key = (part[0].seq, len(part))
                enc = self._replay_cache.get(key)
                if enc is None:
                    enc = _encode_events(part)
                    if len(self._replay_cache) >= 64:
                        self._replay_cache.clear()
                    self._replay_cache[key] = enc
                push(len(part), enc)
            entry["next"] = chunk[-1].seq + 1

        def close() -> None:
            with self._block:
                entry["open"] = False
                if entry in self._streams:
                    self._streams.remove(entry)
                if not self._streams and self._unsub is not None:
                    self._unsub()
                    self._unsub = None
        return pack_json({"cursor": ack}), close

    def _on_batch(self, events: List[JobEvent]) -> None:
        with self._block:
            self._delivered = events[-1].seq + 1
            streams = list(self._streams)
        if not streams:
            return
        shared = None
        first = events[0].seq
        for s in streams:
            if not s["open"]:
                continue
            if s["next"] <= first:
                if shared is None:
                    shared = _encode_events(events)
                s["push"](len(events), shared)
                s["next"] = events[-1].seq + 1
            else:
                # a subscriber that just spliced in mid-chunk: slice
                # off what its replay already covered
                part = [e for e in events if e.seq >= s["next"]]
                if part:
                    s["push"](len(part), _encode_events(part))
                    s["next"] = part[-1].seq + 1


# ---------------------------------------------------------------------- #
# the remote client: identical verbs over a Transport
# ---------------------------------------------------------------------- #
class RemoteJobHandle:
    """Handle to a job living in an instance this process doesn't own."""

    def __init__(self, api: "RemoteInstance", jobid: str):
        self._api = api
        self.jobid = jobid

    @property
    def state(self) -> Optional[JobState]:
        info = self._api.job(self.jobid)
        return JobState(info["state"]) if info else None

    def wait(self, timeout: Optional[float] = None
             ) -> Optional[JobState]:
        return self._api.wait(self.jobid, timeout=timeout)

    def result(self, timeout: Optional[float] = None) -> Optional[Dict]:
        self.wait(timeout=timeout)
        return self._api.job(self.jobid)

    def cancel(self) -> bool:
        return self._api.cancel(self.jobid)

    def grow(self, jobspec: Jobspec) -> bool:
        return self._api.grow(self.jobid, jobspec)

    def shrink(self, paths: Optional[List[str]] = None,
               count: Optional[int] = None) -> bool:
        return self._api.shrink(self.jobid, paths=paths, count=count)

    def events(self) -> List[JobEvent]:
        events, _ = self._api.events_since(0)
        return [e for e in events if e.jobid == self.jobid]


class RemoteInstance:
    """Client side of the served surface: the same submit / cancel /
    wait / events_since / usage verbs, spoken over any ``Transport``
    (in-proc or socket) to an :class:`Instance` another process or
    level owns — the nested-instance consumer of the paper."""

    def __init__(self, transport: Transport):
        self.transport = transport

    def _call(self, method: str, **req) -> Dict:
        return unpack_json(self.transport.call(method, pack_json(req)))

    def submit(self, jobspec: Jobspec, *,
               walltime: Optional[float] = None, priority: int = 0,
               preemptible: bool = False, grow: Optional[bool] = None,
               alloc_id: Optional[str] = None,
               jobid: Optional[str] = None,
               dispatch: bool = False) -> RemoteJobHandle:
        resp = self._call("submit", jobspec=jobspec.to_dict(),
                          walltime=walltime, priority=priority,
                          preemptible=preemptible, grow=grow,
                          alloc_id=alloc_id, jobid=jobid,
                          dispatch=dispatch)
        if "error" in resp:
            raise ValueError(f"remote submit failed: {resp['error']}")
        return RemoteJobHandle(self, resp["jobid"])

    def submit_many(self, jobspecs: Iterable[Jobspec], *,
                    walltime: Optional[float] = None, priority: int = 0,
                    preemptible: bool = False,
                    grow: Optional[bool] = None,
                    alloc_id: Optional[str] = None,
                    dispatch: bool = False) -> List[RemoteJobHandle]:
        """Batched submit: the whole batch rides one RPC round-trip
        (a deep queue pays one link latency, not N)."""
        jobs = [{"jobspec": js.to_dict(), "walltime": walltime,
                 "priority": priority, "preemptible": preemptible,
                 "grow": grow, "alloc_id": alloc_id,
                 "dispatch": dispatch} for js in jobspecs]
        resp = self._call("submit_many", jobs=jobs)
        handles = []
        for r in resp.get("jobs", []):
            if "error" in r:
                raise ValueError(f"remote submit failed: {r['error']}")
            handles.append(RemoteJobHandle(self, r["jobid"]))
        return handles

    def grow_many(self, grows: Iterable[Tuple[str, Jobspec]]
                  ) -> List[bool]:
        """Batched grow in one round-trip; per-request success."""
        resp = self._call("grow_many",
                          grows=[{"jobid": j, "jobspec": js.to_dict()}
                                 for j, js in grows])
        return [bool(ok) for ok in resp.get("ok", [])]

    def subscribe(self, cb: Optional[Callable[[JobEvent], None]] = None,
                  cursor: Optional[int] = None) -> "RemoteSubscription":
        """Open a server-push event stream (requires a multiplexed
        transport): ``cb`` receives each :class:`JobEvent` as it is
        emitted — no ``events_since`` polling.  ``cursor`` replays the
        journal from there first (``None`` = live only)."""
        if not hasattr(self.transport, "subscribe"):
            raise TypeError(
                "push subscription needs a MuxTransport (got "
                f"{type(self.transport).__name__}); use events_since "
                "polling on legacy transports")
        return RemoteSubscription(self.transport, cb, cursor)

    def cancel(self, jobid: str) -> bool:
        return bool(self._call("cancel", jobid=jobid).get("ok"))

    def wait(self, jobid: str, timeout: Optional[float] = None
             ) -> Optional[JobState]:
        resp = self._call("wait", jobid=jobid, timeout=timeout)
        return JobState(resp["state"]) if resp.get("state") else None

    def job(self, jobid: str) -> Optional[Dict]:
        return self._call("job", jobid=jobid).get("job")

    def grow(self, jobid: str, jobspec: Jobspec) -> bool:
        return bool(self._call("grow", jobid=jobid,
                               jobspec=jobspec.to_dict()).get("ok"))

    def shrink(self, jobid: str, paths: Optional[List[str]] = None,
               count: Optional[int] = None) -> bool:
        return bool(self._call("shrink", jobid=jobid, paths=paths,
                               count=count).get("ok"))

    def events_since(self, cursor: int = 0
                     ) -> Tuple[List[JobEvent], int]:
        resp = self._call("events_since", cursor=cursor)
        return ([JobEvent.from_dict(d) for d in resp["events"]],
                resp["cursor"])

    def usage(self) -> Dict[str, int]:
        return unpack_json(self.transport.call("usage", b""))

    def call_many(self, calls: List[Tuple[str, Dict]]) -> List[Dict]:
        """Pipelined batch of arbitrary verbs: ``[(method, request)]``
        goes out in one write; responses return in order."""
        raw = self.transport.call_many(
            [(m, pack_json(req)) for m, req in calls])
        return [unpack_json(r) for r in raw]

    def step(self) -> int:
        return self._call("step").get("started", 0)

    def advance(self, dt: float) -> int:
        return self._call("advance", dt=dt).get("started", 0)

    # -- fleet observability (served by runtime/dashboard.py when a
    # ClusterHealth consumer is registered on the target) ------------- #
    def status(self) -> Dict:
        """Compact fleet-health snapshot: utilization, wait
        percentiles, churn, lease debt."""
        return self._call("status")

    def metrics(self) -> Dict:
        """Full derived-metrics dump (per tenant + fleet rollup)."""
        return self._call("metrics")

    def tenants(self) -> Dict:
        """Per-tenant usage / weight / burn / lease rows."""
        return self._call("tenants")

    def close(self) -> None:
        self.transport.close()


class RemoteSubscription:
    """Client side of a remote event stream: decodes pushed frames
    into :class:`JobEvent`\\ s, tracks a resume cursor, and dedups the
    replay/live splice — so after a disconnect, ``reattach`` on a fresh
    transport resumes from ``self.cursor`` with no gaps (within the
    journal's retained window) and no duplicates."""

    def __init__(self, transport, cb: Optional[Callable[[JobEvent],
                                                        None]],
                 cursor: Optional[int] = None):
        self._cb = cb
        self.cursor = 0 if cursor is None else cursor
        self.events_received = 0
        self._sub = None
        self._attach(transport, cursor)

    def _attach(self, transport, cursor: Optional[int]) -> None:
        payload = pack_json({} if cursor is None else {"cursor": cursor})
        self._sub = transport.subscribe(payload,
                                        on_batch=self._on_batch)
        ack = unpack_json(self._sub.ack)
        self.cursor = max(self.cursor, ack.get("cursor", 0))

    def _on_batch(self, count: int, payload: Optional[bytes]) -> None:
        for d in unpack_json(payload).get("events", []):
            ev = JobEvent.from_dict(d)
            if ev.seq < self.cursor:
                continue        # overlap from a reattach replay
            self.cursor = ev.seq + 1
            self.events_received += 1
            if self._cb is not None:
                try:
                    self._cb(ev)
                except Exception:
                    pass

    def reattach(self, transport) -> None:
        """Resubscribe on a (new) transport, resuming from the cursor
        — the reconnect path after a server restart."""
        self.close()
        self._attach(transport, self.cursor)

    def close(self) -> None:
        if self._sub is not None:
            self._sub.close()
            self._sub = None
