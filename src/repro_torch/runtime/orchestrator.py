"""KubeFlux-style orchestrator: replica sets over the Instance API.

The paper's third capability — scheduling cloud-orchestration-framework
tasks — as a first-class controller, reconciled entirely through the
:class:`~repro_torch.core.api.Instance` facade (submit/handle/event surface);
it never touches ``JobQueue`` internals or the scheduler directly:

* a ``ReplicaSet`` declares a pod-sized jobspec and a desired replica
  count; every replica is a submitted job bound to the replica set's
  single scheduler allocation (``alloc_id``), so scale-up is a
  ``submit(dispatch=True)`` (MATCHALLOCATE for the first replica,
  MATCHGROW after) and scale-down cancels the newest handle (the
  queue's timed-release path),
* replica jobs are **preemptible**: a higher-priority tenant's grow may
  revoke the replica set's allocation through the hierarchy.  The
  reconciler observes the loss from the *event journal* — it reads
  PREEMPT events since its cursor (cursor-based replay, so nothing is
  missed between reconcile ticks), drops the requeued retries, and
  re-dispatches against current state — revocation looks exactly like
  any other drift, and there is no state polling,
* a ``BurstPolicy`` decides when scaling may spill to the External API
  (the paper notes Slurm/LSF gate bursting behind static cluster-wide
  config; here it is a per-replica-set policy object) — the
  external-burst path rides the queue's grow escalation,
* utilization-driven autoscaling (scale on a load signal between
  min/max replicas).
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Union

from ..core.api import Instance
from ..core.events import EventType
from ..core.jobspec import Jobspec
from ..core.queue import JobQueue, JobState
from ..core.scheduler import SchedulerInstance


@dataclass
class BurstPolicy:
    """When may a replica set consume external (cloud) resources?"""

    allow_burst: bool = True
    max_external_fraction: float = 0.5     # cap on cloud share
    min_local_free: int = 0                # keep this many local cores free

    def may_burst(self, n_local: int, n_external: int) -> bool:
        if not self.allow_burst:
            return False
        total = n_local + n_external + 1
        return (n_external + 1) / total <= self.max_external_fraction


@dataclass
class ReplicaSet:
    name: str
    pod_spec: Jobspec
    desired: int
    policy: BurstPolicy = field(default_factory=BurstPolicy)
    replicas: int = 0
    external_replicas: int = 0
    events: List[str] = field(default_factory=list)

    @property
    def jobid(self) -> str:
        return f"rs-{self.name}"


class Orchestrator:
    """Reconciles replica sets against an :class:`Instance`.

    Accepts an ``Instance`` directly, or (back-compat) a bare
    ``SchedulerInstance`` / ``JobQueue`` which it wraps in one.
    """

    def __init__(self, api: Union[Instance, SchedulerInstance],
                 queue: Optional[JobQueue] = None, follow: bool = True):
        if isinstance(api, Instance):
            self.api = api
        elif queue is not None:
            self.api = Instance(queue=queue)
        else:
            self.api = Instance(api, allow_grow=True)
        self.scheduler = self.api.scheduler
        self.replica_sets: Dict[str, ReplicaSet] = {}
        self._replica_seq = itertools.count()
        # event-journal cursor: revocations are observed from the
        # event stream, never by polling queue state.  With
        # ``follow=True`` (default) the orchestrator rides the push
        # stream — PREEMPTs are buffered as they are emitted and each
        # reconcile just drains the buffer; ``follow=False`` (or a
        # detached follower) falls back to cursor replay, retaining
        # the journal-truncation resync for the reconnect path.
        self._cursor = self.api.events.cursor
        self._watermark = self._cursor     # seq just past newest pushed
        self._pushed: Deque = collections.deque()   # buffered PREEMPTs
        self._follow = follow
        self._unsub = None
        if follow:
            self._unsub = self.api.subscribe(self._on_event)
        self._revoked: Dict[str, List[str]] = {}   # alloc_id -> jobids
        # journal-truncation resyncs taken (observability: a nonzero
        # count means derived state was rebuilt from live handles
        # rather than a complete event replay)
        self.resyncs = 0

    def _on_event(self, ev) -> None:
        # runs on the event log's single-drainer thread: buffer only,
        # reconciliation stays on the reconcile() caller's thread
        if ev.type is EventType.PREEMPT:
            self._pushed.append(ev)
        if ev.seq >= self._watermark:
            self._watermark = ev.seq + 1

    @property
    def queue(self) -> JobQueue:
        """The underlying queue (shared-queue consumers inspect it)."""
        return self.api.queue

    def create(self, rs: ReplicaSet) -> ReplicaSet:
        self.replica_sets[rs.name] = rs
        self.reconcile(rs.name)
        return rs

    # ------------------------------------------------------------ #
    def reconcile(self, name: str) -> int:
        """Drive actual replicas toward desired.  Returns the delta
        applied.  Scale-up submits one job per missing replica (local
        resources preferred; external bursting gated by the policy).
        Scale-down cancels the newest replica handles first (external
        ones before local, so cloud cost drains first)."""
        rs = self.replica_sets[name]
        applied = 0
        self._observe_revocations(rs)
        # scale up: one job per replica, sharing rs.jobid's allocation;
        # the queue runs MA for the first and MG after
        while rs.replicas < rs.desired:
            external_before = len(self.scheduler.external_paths)
            # the first replica is pure MATCHALLOCATE (grow=False:
            # strictly local); later replicas MATCHGROW the allocation
            first = rs.replicas == 0
            # bursting allowed? temporarily detach the provider if not
            provider = self.scheduler.external
            if provider is not None and not first and \
                    not rs.policy.may_burst(
                        rs.replicas - rs.external_replicas,
                        rs.external_replicas):
                self.scheduler.external = None
            try:
                # dispatch, not head-of-line submit: the reconciler must
                # not be wedged behind an unrelated blocked job at the
                # head of a shared queue
                handle = self.api.submit(
                    rs.pod_spec, walltime=None, alloc_id=rs.jobid,
                    jobid=f"{rs.jobid}-r{next(self._replica_seq)}",
                    grow=not first, preemptible=True, dispatch=True)
            finally:
                self.scheduler.external = provider
            if handle.state is not JobState.RUNNING:
                handle.cancel()
                rs.events.append(f"scale-up blocked at {rs.replicas}")
                break
            burst = len(self.scheduler.external_paths) > external_before
            rs.replicas += 1
            rs.external_replicas += 1 if burst else 0
            rs.events.append(
                f"scaled to {rs.replicas}" + (" (burst)" if burst else ""))
            applied += 1
        # scale down: cancel the newest replica handles (external last
        # in, first out — cloud cost drains before local capacity)
        while rs.replicas > rs.desired:
            handles = self.api.running(rs.jobid)
            if not handles:
                break
            victim = handles[-1]
            was_external = any(p in self.scheduler.external_paths
                               for p in victim.paths)
            victim.cancel()
            rs.replicas -= 1
            if was_external:
                rs.external_replicas = max(rs.external_replicas - 1, 0)
            rs.events.append(f"scaled down to {rs.replicas}")
            applied -= 1
        return applied

    # ------------------------------------------------------------ #
    def detach(self) -> None:
        """Stop following the push stream (the disconnect half of the
        reconnect story); observation falls back to cursor replay."""
        if self._unsub is not None:
            self._unsub()
            self._unsub = None

    def reattach(self) -> None:
        """Resume following after :meth:`detach`: resubscribe first,
        then replay the gap from the saved cursor — the replay carries
        the truncation resync, and ``_revoked``'s seen-lists make the
        replay/push overlap idempotent."""
        if self._follow and self._unsub is None:
            self._unsub = self.api.subscribe(self._on_event)
        self._replay_events()

    def _drain_events(self) -> None:
        """Collect which replica-set allocations lost replicas to
        PREEMPT (hierarchy revokes and policy preemptions look
        identical here).  Events for allocations this orchestrator
        doesn't manage are skipped, so a shared queue's unrelated
        churn can't grow state here.

        Following the push stream, this just drains the buffer the
        live subscription filled — no journal scan at all.  Otherwise
        it replays the journal since the last cursor."""
        mine = {rs.jobid for rs in self.replica_sets.values()}
        for alloc in [a for a in self._revoked if a not in mine]:
            del self._revoked[alloc]
        if self._unsub is not None:
            while self._pushed:
                ev = self._pushed.popleft()
                alloc = ev.detail.get("alloc_id", ev.jobid)
                if alloc in mine:
                    seen = self._revoked.setdefault(alloc, [])
                    if ev.jobid not in seen:
                        seen.append(ev.jobid)
            if self._watermark > self._cursor:
                self._cursor = self._watermark
            return
        self._replay_events(mine)

    def _replay_events(self, mine: Optional[set] = None) -> None:
        """Cursor replay with the truncation safety valve: if the
        bounded journal dropped events between our cursor and its
        retained window (we fell > maxlen events behind), the replay
        can no longer be trusted to contain every PREEMPT — so fall
        back to a full state resync: any of our replicas still
        sitting requeued in the pending queue is treated as revoked."""
        if mine is None:
            mine = {rs.jobid for rs in self.replica_sets.values()}
        cursor = self._cursor
        events, self._cursor = self.api.events_since(cursor)
        if events and events[0].seq > cursor:
            self.resyncs += 1
            for alloc in mine:
                for h in self.api.pending(alloc):
                    if h.state is not JobState.PREEMPTED:
                        continue
                    seen = self._revoked.setdefault(alloc, [])
                    if h.jobid not in seen:
                        seen.append(h.jobid)
        for ev in events:
            if ev.type is EventType.PREEMPT:
                alloc = ev.detail.get("alloc_id", ev.jobid)
                if alloc in mine:
                    seen = self._revoked.setdefault(alloc, [])
                    if ev.jobid not in seen:
                        seen.append(ev.jobid)

    def _observe_revocations(self, rs: ReplicaSet) -> None:
        """Reconcile the replica count with reality after the hierarchy
        revoked (part of) the replica set's allocation.  Requeued
        PREEMPTED replicas (found via event replay) are dropped —
        re-dispatching fresh jobs lets the burst policy re-evaluate
        against the post-revoke state — and the actual/external
        counters resync from the live handles."""
        self._drain_events()
        requeued = []
        for jobid in self._revoked.pop(rs.jobid, []):
            info = self.api.job(jobid)
            # drop only replicas still waiting in the queue — one that
            # already restarted on its own is a live replica, not drift
            if info and info["state"] == JobState.PREEMPTED.value:
                self.api.cancel(jobid)
                requeued.append(jobid)
        alive = self.api.running(rs.jobid)
        if requeued or len(alive) != rs.replicas:
            rs.events.append(
                f"revoked: {rs.replicas} -> {len(alive)} replicas")
        rs.replicas = len(alive)
        rs.external_replicas = sum(
            1 for h in alive
            if any(p in self.scheduler.external_paths for p in h.paths))

    # ------------------------------------------------------------ #
    def autoscale(self, name: str, load: float,
                  target_load: float = 0.7,
                  min_replicas: int = 1, max_replicas: int = 64) -> int:
        """Utilization-driven desired-count update + reconcile.
        ``load`` is the replica-set's current utilization in [0, inf)."""
        rs = self.replica_sets[name]
        want = max(min_replicas,
                   min(max_replicas,
                       int(-(-rs.replicas * load // target_load))
                       if rs.replicas else min_replicas))
        rs.desired = want
        return self.reconcile(name)
