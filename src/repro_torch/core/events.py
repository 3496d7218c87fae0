"""Typed job-event log: the observable surface of the dynamic model.

"Design Principles of Dynamic Resource Management" argues that dynamic
resource changes (grow/shrink/preempt) must be first-class, observable
operations of the API — not side effects a consumer infers by polling
state.  This module is that surface: every lifecycle transition the
queue, the MATCHGROW engine, or a scheduler instance performs is
appended to an :class:`EventLog` as a typed :class:`JobEvent`, and
consumers observe it two ways:

* **callback subscription** (``subscribe``) — live push, for wall-clock
  consumers (orchestrators, autoscalers) that react as events happen;
* **cursor-based replay** (``since``) — pull, for simulated consumers
  and remote clients: read everything after a cursor, remember the new
  cursor, repeat.  Replay returns exactly the same sequence a live
  subscriber saw (bounded by ``maxlen``), so the two modes are
  interchangeable and events ride transports as plain dicts.

Events carry a global monotonic ``seq``; appends are serialized under a
lock, so the log is a total order — in particular a total order per
job, which is what consumers reason about (SUBMIT < ALLOC < START <
... < FREE for one jobid).

Emission map (who appends what):

* ``JobQueue`` — SUBMIT, ALLOC (resources bound), START, PREEMPT
  (requeued), SHRINK (malleable shrink through the queue), FREE
  (terminal: completed or cancelled), EXCEPTION (rejected operation).
* ``GrowEngine`` — GROW on every successful MATCHGROW at the emitting
  instance (detail carries ``via``: local / sibling / parent /
  external), REVOKE per evicted victim on the donor.
* ``SchedulerInstance`` — RELEASE when an allocation (or a slice of
  one) is handed back.  Scheduler-level events are keyed by the
  *allocation* id; queue-level events by the *job* id (several jobs
  may share one allocation).
"""
from __future__ import annotations

import collections
import enum
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..analysis.lockwitness import named_rlock


class EventType(enum.Enum):
    SUBMIT = "submit"        # job entered the queue
    ALLOC = "alloc"          # resources bound to the job
    START = "start"          # job began running
    GROW = "grow"            # allocation grew (MATCHGROW succeeded)
    SHRINK = "shrink"        # allocation shrank (subtractive transform)
    PREEMPT = "preempt"      # job displaced and requeued
    REVOKE = "revoke"        # hierarchy evicted an allocation
    RELEASE = "release"      # resources handed back to the pool
    FREE = "free"            # job reached a terminal state
    EXCEPTION = "exception"  # operation rejected / failed


@dataclass(frozen=True)
class JobEvent:
    """One typed lifecycle event.  ``detail`` must stay JSON-serializable
    so events ride ``SocketTransport`` unchanged."""

    seq: int
    t: float
    type: EventType
    jobid: str
    detail: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {"seq": self.seq, "t": self.t, "type": self.type.value,
                "jobid": self.jobid, "detail": dict(self.detail)}

    @classmethod
    def from_dict(cls, d: Dict) -> "JobEvent":
        return cls(seq=d["seq"], t=d["t"], type=EventType(d["type"]),
                   jobid=d["jobid"], detail=dict(d.get("detail", {})))


class EventLog:
    """Append-only, bounded, thread-safe event log with live
    subscription and cursor-based replay.

    A cursor is simply "the seq after the last event I saw": ``since(c)``
    returns every retained event with ``seq >= c`` plus the next cursor.
    ``maxlen`` bounds retention; a cursor older than the retained window
    resumes from the oldest retained event (consumers that must never
    miss events should subscribe, or poll faster than they fall behind).
    """

    def __init__(self, clock=None, maxlen: int = 100_000):
        self.clock = clock              # optional: stamps emit(t=None)
        self.maxlen = maxlen
        self._events: List[JobEvent] = []
        self._base = 0                  # seq of _events[0]
        self._next = 0                  # next seq to assign
        # monotonic count of head events trimmed past maxlen: replay
        # consumers compare it (or the `oldest` watermark in stats())
        # across polls to detect that a gap opened between reads, and
        # mark their derived metrics as resynced instead of silently
        # folding a truncated stream
        self._dropped = 0
        self._lock = named_rlock("eventlog")
        # (callback, join cursor): a subscriber only receives events
        # with seq >= its join cursor, so a since()-then-subscribe
        # handoff never sees an event both via replay and live (a
        # concurrent emitter's parked events would otherwise be
        # delivered to subscribers registered after the emit)
        self._subscribers: List[Tuple[Callable[[JobEvent], None],
                                      int]] = []
        # live delivery runs OUTSIDE the lock: holding it across
        # arbitrary subscriber code invites lock-order inversions (a
        # subscriber calling back into an Instance verb while an
        # Instance-verb thread emits) and lets one bad/slow subscriber
        # wedge every emitter.  Appends park the event here and exactly
        # one thread at a time drains, so delivery order still equals
        # seq/replay order.  Which thread runs a callback is
        # UNSPECIFIED: any emitter may end up draining another
        # emitter's parked events, so subscribers must not assume the
        # emitting operation's locks are held.
        self._delivery: Deque[JobEvent] = collections.deque()
        self._delivering = False
        # batch sinks ride the same single-drainer path but receive a
        # LIST of events per call — the server-push hook: one encode of
        # a whole chunk fans out to every remote subscriber, instead of
        # one callback (and one frame) per event
        self._sinks: List[Tuple[Callable[[List[JobEvent]], None],
                                int]] = []

    # ------------------------------------------------------------------ #
    def emit(self, type: EventType, jobid: str,
             t: Optional[float] = None, **detail) -> JobEvent:
        """Append one event (stamped with ``t``, or the log's clock, or
        0.0) and push it to live subscribers."""
        if t is None:
            t = self.clock.now() if self.clock is not None else 0.0
        claimed = False
        try:
            with self._lock:
                ev = JobEvent(seq=self._next, t=t, type=type,
                              jobid=jobid, detail=detail)
                self._next += 1
                self._events.append(ev)
                if len(self._events) > self.maxlen:
                    drop = len(self._events) - self.maxlen
                    del self._events[:drop]
                    self._base += drop
                    self._dropped += drop
                self._delivery.append(ev)
                if not self._delivering:
                    # this frame becomes the drainer; any frame that
                    # sees the flag set (an outer emit on this thread,
                    # a concurrent emitter) just parks its event and
                    # trusts the drainer to deliver it in seq order
                    self._delivering = True
                    claimed = True
            if claimed:
                self._drain_delivery()
        except BaseException:
            # a KeyboardInterrupt/SystemExit anywhere between claiming
            # the flag and the drain finishing must not leave it stuck
            # (delivery would silently stop forever); _drain_delivery
            # itself only resets on normal return, so this is the one
            # reset point for the abnormal path and cannot clear a flag
            # some other thread has since claimed
            if claimed:
                with self._lock:
                    self._delivering = False
            raise
        return ev

    def _drain_delivery(self) -> None:
        """Deliver parked events to subscribers, one event at a time,
        without holding the lock across callbacks.  Exactly one thread
        drains at a time (``_delivering``), so live delivery order
        equals seq order; a subscriber that raises is skipped so it
        cannot abort the emitting scheduler/queue operation.  On
        BaseException the flag is left set — the claiming ``emit``
        frame resets it."""
        while True:
            with self._lock:
                if not self._delivery:
                    self._delivering = False
                    return
                # batch sinks amortize per-delivery overhead: take up
                # to 256 parked events in one chunk (bounded so a flood
                # can't starve the replay lock)
                chunk = [self._delivery.popleft()
                         for _ in range(min(len(self._delivery), 256))]
                subs = list(self._subscribers)
                sinks = list(self._sinks)
            for ev in chunk:
                for cb, joined in subs:
                    if ev.seq < joined:
                        continue    # predates this subscriber
                    try:
                        cb(ev)
                    except Exception:
                        pass
            for scb, joined in sinks:
                batch = [e for e in chunk if e.seq >= joined]
                if not batch:
                    continue
                try:
                    scb(batch)
                except Exception:
                    pass

    # ------------------------------------------------------------------ #
    def since(self, cursor: int = 0) -> Tuple[List[JobEvent], int]:
        """Replay: events with ``seq >= cursor`` (oldest retained if the
        cursor fell behind) and the cursor to pass next time.

        Gap detection: when the cursor fell behind the retained window,
        the first returned event has ``seq > cursor`` — the caller lost
        ``events[0].seq - cursor`` events to truncation (see
        :meth:`stats` for the monotonic ``dropped`` count and the
        ``oldest`` watermark)."""
        with self._lock:
            lo = max(cursor - self._base, 0)
            out = list(self._events[lo:])
            return out, self._next

    @property
    def dropped(self) -> int:
        """Monotonic count of events trimmed past ``maxlen``."""
        with self._lock:
            return self._dropped

    def stats(self) -> Dict[str, int]:
        """Truncation accounting for gap-aware replay consumers:
        ``next`` (the live cursor), ``oldest`` (the truncation
        watermark — seq of the oldest retained event; a replay cursor
        below it has lost events), ``retained``, the monotonic
        ``dropped`` count, and ``maxlen``."""
        with self._lock:
            return {"next": self._next, "oldest": self._base,
                    "retained": len(self._events),
                    "dropped": self._dropped, "maxlen": self.maxlen}

    def for_job(self, jobid: str) -> List[JobEvent]:
        with self._lock:
            return [e for e in self._events if e.jobid == jobid]

    def subscribe(self, cb: Callable[[JobEvent], None]
                  ) -> Callable[[], None]:
        """Register a live callback for events emitted from now on
        (events already emitted — even if still queued for delivery —
        are the replay side's job); returns an unsubscribe function."""
        with self._lock:
            entry = (cb, self._next)
            self._subscribers.append(entry)

        def unsubscribe() -> None:
            with self._lock:
                if entry in self._subscribers:
                    self._subscribers.remove(entry)
        return unsubscribe

    def add_sink(self, cb: Callable[[List[JobEvent]], None]
                 ) -> Callable[[], None]:
        """Register a *batch* sink: like ``subscribe`` but the callback
        receives a list of consecutive events per delivery chunk (same
        single-drainer ordering guarantees, same join-cursor semantics).
        This is the server-push hook — a remote-streaming broadcaster
        encodes each chunk once and fans the bytes out to every
        subscriber connection.  Returns an unsubscribe function."""
        with self._lock:
            entry = (cb, self._next)
            self._sinks.append(entry)

        def remove() -> None:
            with self._lock:
                if entry in self._sinks:
                    self._sinks.remove(entry)
        return remove

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        with self._lock:
            return self._next

    def __bool__(self) -> bool:
        # a log is an identity, not a container: an EMPTY log must not
        # be falsy (``eventlog or EventLog()`` would silently replace a
        # caller-supplied log before its first emit)
        return True

    @property
    def cursor(self) -> int:
        """The cursor pointing just past the newest event."""
        with self._lock:
            return self._next
