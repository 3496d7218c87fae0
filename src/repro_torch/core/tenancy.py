"""Multi-tenant trees: per-tenant job queues over sibling subtrees.

The paper's Fig. 2 multi-user topology made operational: every tenant
owns a sibling subtree of one parent instance (delegated down, so the
parent's own free pool is empty) and fronts it with its own
:class:`~repro.core.api.Instance` — with its own scheduling policy and
its own event journal — so tenants submit, observe, and (when policy
allows) preempt through the one public API, locally or remotely.  Resource flow between tenants goes through the
parent's MATCHGROW sibling routing: free resources move via ``reclaim``,
and, when a tenant's policy is preemptive, busy lower-priority resources
move via ``revoke`` (the victim's queue requeues it PREEMPTED→PENDING).

The :class:`FairShareArbiter` sits on the parent instance and gates the
revoke path: a tenant may preempt a sibling only while its own weighted
usage share is strictly below the sibling's, so a heavy tenant cannot
churn a light one off its fair share.  Usage is sampled through the
``usage`` RPC (vertices held by real jobs; delegation markers do not
count), so the arbiter works across socket links too.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

from ..analysis.lockwitness import named_lock
from .api import Instance
from .graph import ResourceGraph
from .policy import SchedulingPolicy
from .queue import Clock, Job, JobQueue, SimClock
from .scheduler import Hierarchy, TreeSpec, build_tree
from .transform import add_subgraph, update_metadata


@dataclass
class Lease:
    """One sibling donation: ``donor``'s vertices now serve
    ``borrower``'s job ``jobid``.  Active until the return-home policy
    settles it (``returned_t``)."""

    donor: str
    borrower: str
    jobid: str
    paths: List[str] = field(default_factory=list)
    t: float = 0.0
    preempt: bool = False           # came through the revoke path
    n_victims: int = 0
    returned_t: Optional[float] = None


class LeaseLedger:
    """Accounting for donated capacity (the ROADMAP's donated-capacity
    gap): every sibling reclaim/revoke records (donor, borrower,
    vertices, t); the return-home policy settles a lease once the
    vertices are free again and the borrower's pressure dropped.

    ``debt()`` is the first-class metric: per-donor count of vertices
    currently leased out.  Conservation holds by construction — every
    active lease is simultaneously one donor's debt and one borrower's
    credit — and the metrics surface exposes both sides so consumers
    can assert it fleet-wide.  Thread-safe; ``record`` never calls out
    (R2/R3: it may run while a jobqueue API lock is held)."""

    def __init__(self, clock: Optional[Clock] = None,
                 history: int = 1024):
        self.clock = clock
        self._lock = named_lock("leaseledger")
        self._active: List[Lease] = []
        self._returned: Deque[Lease] = collections.deque(maxlen=history)
        self.n_recorded = 0
        self.n_returned = 0

    def _now(self, t: Optional[float]) -> float:
        if t is not None:
            return t
        return self.clock.now() if self.clock is not None else 0.0

    def record(self, *, donor: str, borrower: str, jobid: str,
               paths: List[str], t: Optional[float] = None,
               preempt: bool = False, n_victims: int = 0) -> Lease:
        lease = Lease(donor=donor, borrower=borrower, jobid=jobid,
                      paths=list(paths), t=self._now(t),
                      preempt=preempt, n_victims=n_victims)
        with self._lock:
            self._active.append(lease)
            self.n_recorded += 1
        return lease

    def settle(self, lease: Lease, t: Optional[float] = None) -> None:
        with self._lock:
            if lease in self._active:
                self._active.remove(lease)
                lease.returned_t = self._now(t)
                self._returned.append(lease)
                self.n_returned += 1

    def active(self) -> List[Lease]:
        with self._lock:
            return list(self._active)

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    def debt(self) -> Dict[str, int]:
        """Per-donor vertices currently leased out."""
        out: Dict[str, int] = {}
        with self._lock:
            for le in self._active:
                out[le.donor] = out.get(le.donor, 0) + len(le.paths)
        return out

    def credit(self) -> Dict[str, int]:
        """Per-borrower vertices currently leased in."""
        out: Dict[str, int] = {}
        with self._lock:
            for le in self._active:
                out[le.borrower] = out.get(le.borrower, 0) \
                    + len(le.paths)
        return out

    def summary(self) -> Dict:
        """JSON-able metric view (what the ``status`` verb serves)."""
        with self._lock:
            debt: Dict[str, int] = {}
            credit: Dict[str, int] = {}
            for le in self._active:
                debt[le.donor] = debt.get(le.donor, 0) + len(le.paths)
                credit[le.borrower] = \
                    credit.get(le.borrower, 0) + len(le.paths)
            return {"active": len(self._active),
                    "outstanding_vertices": sum(debt.values()),
                    "debt": debt, "credit": credit,
                    "recorded": self.n_recorded,
                    "returned": self.n_returned}


class FairShareArbiter:
    """Weighted fair-share gate for cross-tenant preemption.

    ``weights`` maps tenant (child-instance) names to their entitled
    share.  :meth:`may_preempt` compares weight-normalized usage: the
    requester may displace the donor's work only while the requester is
    strictly under-served relative to the donor.  Unknown tenants get
    weight 1.

    The arbiter also owns the :class:`LeaseLedger`: the engine records
    every sibling donation (reclaim or revoke) that happens at the host
    the arbiter sits on, so donated capacity is visible as lease debt
    instead of silently never returning home.
    """

    def __init__(self, weights: Dict[str, float]):
        self.weights = dict(weights)
        self.ledger = LeaseLedger()

    def _normalized(self, name: str, usage: Dict[str, Dict]) -> float:
        u = usage.get(name)
        if u is None:
            return 0.0
        frac = u.get("allocated", 0) / max(u.get("capacity", 1), 1)
        return frac / max(self.weights.get(name, 1.0), 1e-9)

    def may_preempt(self, requester: str, donor: str,
                    usage: Dict[str, Dict]) -> bool:
        return self._normalized(requester, usage) \
            < self._normalized(donor, usage)


@dataclass
class TenantSpec:
    """One tenant: a subtree graph plus its queue configuration."""

    name: str
    graph: ResourceGraph
    weight: float = 1.0
    policy: Optional[SchedulingPolicy] = None
    allow_grow: bool = True
    socket: bool = False        # link to the parent over loopback TCP
    link_latency_s: float = 0.0  # simulated internode latency per RPC


class MultiTenantTree:
    """A parent instance with one delegated subtree + JobQueue per
    tenant and a :class:`FairShareArbiter` deciding preemption.

    The parent marks every vertex present in a tenant's subtree as
    ``delegated-to-<tenant>`` so its own pool is empty: all growth is
    sibling routing (reclaim/revoke) between tenants, exactly the
    multi-tenant scenario the ROADMAP names.
    """

    def __init__(self, root_graph: ResourceGraph,
                 tenants: List[TenantSpec],
                 clock: Optional[Clock] = None,
                 name: str = "root",
                 actors: bool = False):
        self.clock = clock or SimClock()
        spec = TreeSpec(root_graph, name=name, children=[
            TreeSpec(t.graph, name=t.name, socket=t.socket,
                     link_latency_s=t.link_latency_s)
            for t in tenants])
        self.hierarchy: Hierarchy = build_tree(spec)
        self.root = self.hierarchy[name]
        for t in tenants:
            delegated = [p for p in t.graph.paths()
                         if p in self.root.graph]
            self.root.graph.set_allocated(delegated,
                                          f"delegated-to-{t.name}")
        self.root.arbiter = FairShareArbiter(
            {t.name: t.weight for t in tenants})
        self.root.arbiter.ledger.clock = self.clock
        # every tenant fronts its subtree through the Instance facade:
        # tenants submit and observe events through the one public API,
        # and each tenant's surface is remotable (serve()) unchanged
        self.instances: Dict[str, Instance] = {
            t.name: Instance(self.hierarchy[t.name], clock=self.clock,
                             allow_grow=t.allow_grow, policy=t.policy)
            for t in tenants}
        self.queues: Dict[str, JobQueue] = {
            name: inst.queue for name, inst in self.instances.items()}
        # actor mode: one worker + mailbox per tenant queue, so sibling
        # subtrees schedule concurrently (their reclaim/grow RPC waits
        # overlap).  check_actor_safe refuses mutually preemptive
        # tenant sets — those must use the single-driver loop below
        # (see the AB-BA caveat in core/queue.py).
        self.actors = None
        if actors:
            from .actor import ActorGroup
            self.actors = ActorGroup(self.queues)

    def instance(self, tenant: str) -> Instance:
        return self.instances[tenant]

    def queue(self, tenant: str) -> JobQueue:
        return self.queues[tenant]

    # ------------------------------------------------------------------ #
    # lease return-home policy
    # ------------------------------------------------------------------ #
    def return_leases(self) -> int:
        """Settle leases whose pressure dropped: when the borrowing
        tenant has no queued demand and the leased vertices sit free at
        the parent again (the borrower's job released them), the
        capacity is re-delegated to the donor — extracted from the
        parent's pool, marked ``delegated-to-<donor>`` there, and
        spliced back into the donor's subtree graph.  Without this, a
        donor's revoked subtree never returns home (the ROADMAP's
        donated-capacity gap).  Returns the number of leases settled.

        Locking: the parent's and the donor's scheduler locks are taken
        sequentially, never nested, and no transport call happens under
        either."""
        ledger = self.root.arbiter.ledger
        if not ledger.active_count:
            return 0
        returned = 0
        for lease in ledger.active():
            q = self.queues.get(lease.borrower)
            if q is not None and q.pending:
                continue            # borrower pressure still on
            with self.root.lock:
                vs = [self.root.graph.get(p) for p in lease.paths]
                if any(v is None or not v.free for v in vs):
                    continue        # still allocated (or re-leased)
                sub = self.root.graph.extract(lease.paths)
                self.root.graph.set_allocated(
                    lease.paths, f"delegated-to-{lease.donor}")
            donor = self.hierarchy[lease.donor]
            with donor.lock:
                tres = add_subgraph(donor.graph, sub)
                update_metadata(donor.graph, tres)
            ledger.settle(lease)
            dq = self.queues.get(lease.donor)
            if dq is not None:
                dq.kick()           # the donor can schedule onto it now
            returned += 1
        return returned

    # ------------------------------------------------------------------ #
    # joint lifecycle driving (one shared SimClock, many queues)
    # ------------------------------------------------------------------ #
    def step(self) -> int:
        """Run every tenant queue's scheduling pass to fixpoint.  One
        tenant's release or revoke changes sibling-visible state the
        other queues' memo cannot see, so each round kicks all queues
        first; the loop ends when a full round starts nothing.  With
        ``actors=True`` the rounds run concurrently, one per tenant."""
        if self.actors is not None:
            started = self.actors.step()
            if self.return_leases() \
                    and any(q.pending for q in self.queues.values()):
                started += self.actors.step()
            return started
        total = 0
        while True:
            for q in self.queues.values():
                q.kick()
            started = sum(q.step() for q in self.queues.values())
            total += started
            if started == 0:
                # fixpoint reached: settle any leases whose pressure
                # dropped; returned capacity may unblock a donor's
                # pending work, so run one more round when it does
                if self.return_leases() \
                        and any(q.pending for q in self.queues.values()):
                    continue
                return total

    def advance(self, dt: float) -> int:
        """Advance the shared SimClock by ``dt``, stopping at every
        completion event across all tenant queues."""
        clock = self.clock
        assert isinstance(clock, SimClock), "advance() needs a SimClock"
        if self.actors is not None:
            return self.actors.advance(dt)
        target = clock.now() + dt
        started = 0
        while True:
            due = [j.end_time
                   for q in self.queues.values() for j in q.running
                   if j.end_time is not None and j.end_time <= target]
            if not due:
                break
            clock.set(min(due))
            started += self.step()
        clock.set(target)
        started += self.step()
        return started

    def drain(self, max_events: int = 100_000) -> List[Job]:
        """Run until no tenant has running or startable work.  Returns
        all completed jobs across tenants."""
        if self.actors is not None:
            return self.actors.drain(max_events)
        for _ in range(max_events):
            self.step()
            nxt = [j.end_time
                   for q in self.queues.values() for j in q.running
                   if j.end_time is not None]
            if nxt:
                self.clock.set(max(min(nxt), self.clock.now()))
                continue
            if not any(q.pending for q in self.queues.values()):
                break
            if self.step() == 0:
                break
        return [j for q in self.queues.values() for j in q.completed]

    def close(self) -> None:
        if self.actors is not None:
            self.actors.close()
        self.hierarchy.close()
