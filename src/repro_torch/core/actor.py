"""Per-instance actor loops: one worker + mailbox per JobQueue.

``MultiTenantTree.step`` and ``Hierarchy`` drivers serialize every
tenant queue on the calling thread, so a tenant blocked in a grow RPC
(sibling reclaim over a socket link, External API latency) stalls its
siblings' scheduling passes too.  :class:`QueueActor` gives each queue
its own worker thread and mailbox; :class:`ActorGroup` runs one
scheduling round across all actors concurrently and repeats to fixpoint
— the same semantics as the single-driver loop (a round that starts
nothing ends the pass), with sibling subtrees overlapping their RPC
wait time.

Locking: the actors add NO new locks.  Every message body runs a public
``JobQueue`` verb, and those all take the queue-owned ``_api_lock``
(see core/queue.py) — the actor merely moves the call onto a dedicated
thread.  The documented AB-BA caveat therefore still applies: a
cross-tenant revoke acquires the victim queue's lock while the grower's
is held, so two *mutually preemptive* tenants stepped from two threads
could deadlock.  :func:`check_actor_safe` enforces the safe shapes —
at most one preemptive tenant per group (preemption is then
one-directional); groups of non-preemptive tenants (free-resource
reclaim only, the common replay shape) are always safe because reclaim
never touches a sibling queue's lock.
"""
from __future__ import annotations

import queue as _mailbox
import threading
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional

from ..analysis import lockwitness
from .queue import JobQueue, SimClock

_STOP = object()


def check_actor_safe(queues: Dict[str, JobQueue]) -> None:
    """Refuse actor driving for queue sets that could deadlock AB-BA:
    more than one tenant with a preemptive policy means two queues can
    revoke each other's work from two threads at once.  Drive those
    from a single thread (``MultiTenantTree.step``) instead.

    With the lock-order witness active (``REPRO_LOCK_WITNESS=1``) the
    policy-flag heuristic is backed by *observed* orders: if the
    witness graph already contains API-lock edges in both directions
    between any pair of this group's queues, the pair has demonstrably
    revoked into each other and is refused even when the policy flags
    would pass (e.g. a custom policy that preempts without setting
    ``preemptive``).  See docs/CONCURRENCY.md.
    """
    preemptive = [name for name, q in queues.items()
                  if getattr(q.policy, "preemptive", False)]
    if len(preemptive) > 1:
        raise ValueError(
            "actor loops cannot drive mutually preemptive tenants "
            f"({', '.join(sorted(preemptive))}): cross-revokes from two "
            "threads can deadlock AB-BA on the queue API locks; use the "
            "single-driver step or make preemption one-directional")
    witness = lockwitness.active_witness()
    if witness is None:
        return
    named = [(name, q._api_lock.witness_name) for name, q in queues.items()
             if hasattr(q._api_lock, "witness_name")]
    for i, (na, la) in enumerate(named):
        for nb, lb in named[i + 1:]:
            if witness.has_edge(la, lb) and witness.has_edge(lb, la):
                raise ValueError(
                    f"actor loops cannot drive tenants {na!r} and {nb!r}: "
                    f"the lock-order witness has observed their API locks "
                    f"taken in BOTH orders ({la} <-> {lb}), so stepping "
                    "them from two threads can deadlock AB-BA; use the "
                    "single-driver step")


class QueueActor:
    """One worker thread + mailbox bound to one :class:`JobQueue`.

    ``tell`` enqueues a callable for the worker and returns a Future;
    the queue's own ``_api_lock`` still guards every mutation, so work
    submitted here interleaves safely with direct callers on other
    threads.
    """

    def __init__(self, queue_: JobQueue, name: str = "queue"):
        self.queue = queue_
        self.name = name
        self._inbox: _mailbox.Queue = _mailbox.Queue()
        self._thread = threading.Thread(
            target=self._run, name=f"actor-{name}", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            msg = self._inbox.get()
            if msg is _STOP:
                break
            fn, fut = msg
            if fut.set_running_or_notify_cancel():
                try:
                    fut.set_result(fn())
                except BaseException as e:   # surface on the caller
                    fut.set_exception(e)

    def tell(self, fn: Callable[[], object]) -> Future:
        fut: Future = Future()
        self._inbox.put((fn, fut))
        return fut

    def step(self) -> Future:
        """Kick + one scheduling pass, on the actor's thread."""
        q = self.queue

        def pass_():
            q.kick()
            return q.step()
        return self.tell(pass_)

    def close(self, timeout: Optional[float] = 5.0) -> None:
        self._inbox.put(_STOP)
        self._thread.join(timeout)


class ActorGroup:
    """Drive a set of sibling tenant queues concurrently.

    :meth:`step` has the same fixpoint contract as
    ``MultiTenantTree.step`` — rounds of (kick + step) across all
    queues until a full round starts nothing — but each round runs all
    tenants' passes at once, one per actor, so their hierarchy RPCs
    overlap instead of serializing.
    """

    def __init__(self, queues: Dict[str, JobQueue]):
        check_actor_safe(queues)
        self.queues = dict(queues)
        self.actors = {name: QueueActor(q, name)
                       for name, q in self.queues.items()}
        self.rounds = 0

    # -- the concurrent fixpoint round ---------------------------------- #
    def step(self) -> int:
        total = 0
        while True:
            futs = [a.step() for a in self.actors.values()]
            started = sum(f.result() for f in futs)
            self.rounds += 1
            total += started
            if started == 0:
                return total

    # -- SimClock driving (same contract as MultiTenantTree) ------------ #
    def _running_due(self, target: Optional[float] = None) -> List[float]:
        # only called between rounds, when every actor is idle — the
        # queue lists are quiescent, so reading them lock-free is safe
        return [j.end_time
                for q in self.queues.values() for j in q.running
                if j.end_time is not None
                and (target is None or j.end_time <= target)]

    def _clock(self) -> SimClock:
        clock = next(iter(self.queues.values())).clock
        assert isinstance(clock, SimClock), "actor driving needs a SimClock"
        return clock

    def advance(self, dt: float) -> int:
        clock = self._clock()
        target = clock.now() + dt
        started = 0
        while True:
            due = self._running_due(target)
            if not due:
                break
            clock.set(min(due))
            started += self.step()
        clock.set(target)
        started += self.step()
        return started

    def drain(self, max_events: int = 100_000) -> List:
        clock = self._clock()
        for _ in range(max_events):
            self.step()
            nxt = self._running_due()
            if nxt:
                clock.set(max(min(nxt), clock.now()))
                continue
            if not any(q.pending for q in self.queues.values()):
                break
            if self.step() == 0:
                break
        return [j for q in self.queues.values() for j in q.completed]

    def close(self) -> None:
        for a in self.actors.values():
            a.close()
