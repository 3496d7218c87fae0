"""Tests for the concurrency-correctness subsystem (analysis/).

Layer 1: each lint rule R1-R5 catches its deliberate-violation fixture
and the pragma escape hatch suppresses with (and only with) a reason.
Layer 2: the lock-order witness detects a manufactured AB-BA cycle,
classifies single-thread cycles as benign, and records transport calls
made under non-exempt locks.  Plus the witness-backed extension of
``check_actor_safe`` and a two-thread regression for the MuxServer
send-outside-lock hoist.

The twin of tests/test_analysis.py on ``repro_torch``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror);
the tenants' parent cluster is named "fleet" where the original names it
"root"."""
import functools
import json
import textwrap
import threading

import pytest

from repro_torch.analysis import lint, lockwitness
from repro_torch.core import (Jobspec, MuxServer, MuxTransport, SimClock,
                              build_cluster, check_actor_safe, make_policy)
from repro_torch.core.queue import JobQueue
from repro_torch.core.scheduler import SchedulerInstance
from repro_torch.core.tenancy import MultiTenantTree, TenantSpec

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")


def _lint(src: str, path: str = "mod.py"):
    return lint.lint_source(textwrap.dedent(src), path)


def _rules(findings):
    return {f.rule for f in findings}


# ------------------------------------------------------------------ #
# layer 1: static lint fixtures
# ------------------------------------------------------------------ #
def test_r1_catches_unlocked_mutator():
    findings = _lint("""
        class JobQueue:
            def submit(self, jobspec):
                job = object()
                self.pending.append(job)
                self._version += 1
                return job
    """)
    assert _rules(findings) == {"R1"}
    assert len(findings) == 2      # the append and the augassign


def test_r1_passes_locked_mutator_and_readonly_verb():
    findings = _lint("""
        class JobQueue:
            def submit(self, jobspec):
                with self._api_lock:
                    self.pending.append(jobspec)
                    return self._mk_handle(jobspec)

            def get(self, jobid):
                return self._by_id.get(jobid)
    """)
    # get() only reads (a .get() call is not in the mutator set) and
    # submit() mutates under the lock: both clean
    assert findings == []


def test_r2_catches_transport_call_under_lock():
    findings = _lint("""
        class SchedulerInstance:
            def match_grow(self, jobid, req):
                with self.lock:
                    resp = self.parent.call("match_grow", req)
                return resp
    """)
    assert _rules(findings) == {"R2"}


def test_r2_allows_transport_under_api_lock():
    findings = _lint("""
        class JobQueue:
            def step(self):
                with self._api_lock:
                    self.running.append(self.transport.call("ma", b""))
    """)
    # held-across-transport under _api_lock is the documented design
    assert findings == []


def test_r3_catches_callback_and_emit_under_lock():
    findings = _lint("""
        class EventLog:
            def emit(self, ev):
                with self._lock:
                    for cb, cursor in self._subs:
                        cb(ev)

        class GrowEngine:
            def grow(self, jobid):
                with self.host.lock:
                    self.host.eventlog.emit(jobid)
    """)
    assert _rules(findings) == {"R3"}
    assert len(findings) == 2


def test_r4_catches_raw_lock_construction():
    findings = _lint("""
        import threading

        class RPCServer:
            def __init__(self):
                self._lock = threading.Lock()
                self._state = threading.RLock()
    """)
    assert [f.rule for f in findings] == ["R4", "R4"]


def test_r5_catches_wall_clock_in_core_files_only():
    src = """
        import time

        class GrowEngine:
            def grow(self):
                t = time.time()
                time.sleep(0.1)
                return time.monotonic() - t
    """
    # scoped by basename: queue.py is Clock-abstracted core...
    findings = _lint(src, path="queue.py")
    assert [f.rule for f in findings] == ["R5", "R5"]   # monotonic is fine
    # ...rpc.py (simulated link latency) is out of scope by design
    assert _lint(src, path="rpc.py") == []


def test_pragma_with_reason_suppresses():
    findings = _lint("""
        import threading
        lock = threading.Lock()  # lint: allow(R4) fixture lock, not a core lock
    """)
    assert findings == []


def test_pragma_without_reason_does_not_suppress():
    findings = _lint("""
        import threading
        lock = threading.Lock()  # lint: allow(R4)
    """)
    assert _rules(findings) == {"R4"}


def test_pragma_for_wrong_rule_does_not_suppress():
    findings = _lint("""
        import threading
        lock = threading.Lock()  # lint: allow(R2) wrong rule cited
    """)
    assert _rules(findings) == {"R4"}


def test_repo_tree_is_clean():
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    findings = lint.lint_paths([
        os.path.join(root, "src", "repro_torch", "core"),
        os.path.join(root, "src", "repro_torch", "runtime"),
    ])
    assert findings == [], "\n".join(str(f) for f in findings)


# ------------------------------------------------------------------ #
# layer 2: lock-order witness
# ------------------------------------------------------------------ #
def test_witness_detects_ab_ba_cycle_across_threads():
    with lockwitness.scoped_witness() as w:
        a = lockwitness.named_lock("wa")
        b = lockwitness.named_lock("wb")
        na, nb = a.witness_name, b.witness_name

        with a:
            with b:
                pass

        def other():
            with b:
                with a:
                    pass

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=5)

        fatal = w.fatal_cycles()
        assert len(fatal) == 1
        assert set(fatal[0]["locks"]) == {na, nb}
        assert len(fatal[0]["threads"]) >= 2


def test_witness_single_thread_cycle_is_benign():
    # one driver stepping two mutually preemptive queues takes the
    # locks in both orders from ONE thread — a cycle, but not a
    # deadlock; must not fail the CI lane (MultiTenantTree pattern)
    with lockwitness.scoped_witness() as w:
        a = lockwitness.named_lock("sa")
        b = lockwitness.named_lock("sb")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        cycles = w.cycles()
        assert len(cycles) == 1
        assert not cycles[0]["fatal"]
        assert w.fatal_cycles() == []


def test_witness_reentrant_acquire_adds_no_edge():
    with lockwitness.scoped_witness() as w:
        a = lockwitness.named_rlock("ra")
        with a:
            with a:
                pass
        assert w.cycles() == []
        assert w.snapshot()["edges"] == []


def test_witness_transport_call_under_lock_is_violation():
    with lockwitness.scoped_witness() as w:
        guard = lockwitness.named_lock("guard")
        with guard:
            lockwitness.note_transport_call("match_grow")
        lockwitness.note_transport_call("match_grow")   # lock-free: fine
        snap = w.snapshot()
        assert len(snap["transport_violations"]) == 1
        assert snap["transport_violations"][0]["method"] == "match_grow"
        assert snap["transport_violations"][0]["held"] == [guard.witness_name]


def test_witness_api_lock_exempt_from_transport_check():
    with lockwitness.scoped_witness() as w:
        api = lockwitness.named_rlock("jobqueue:t", allow_transport=True)
        with api:
            lockwitness.note_transport_call("match_allocate")
        assert w.snapshot()["transport_violations"] == []


def test_witness_dump_roundtrips_json(tmp_path):
    with lockwitness.scoped_witness() as w:
        a = lockwitness.named_lock("da")
        b = lockwitness.named_lock("db")
        with a:
            with b:
                pass
        out = tmp_path / "graph.json"
        w.dump(str(out))
        snap = json.loads(out.read_text())
        assert [e["from"] for e in snap["edges"]] == [a.witness_name]
        assert [e["to"] for e in snap["edges"]] == [b.witness_name]
        assert snap["fatal_cycles"] == []


def test_named_locks_pass_through_when_inactive():
    assert lockwitness.active_witness() is None or True  # env-dependent
    with lockwitness.scoped_witness():
        pass
    # outside any scope and without the env var, factories hand back
    # raw threading primitives (zero overhead)
    if lockwitness.active_witness() is None:
        lk = lockwitness.named_lock("plain")
        assert not hasattr(lk, "witness_name")
        rk = lockwitness.named_rlock("plain_r")
        assert rk.acquire()
        rk.release()


# ------------------------------------------------------------------ #
# check_actor_safe: witness-backed refusal
# ------------------------------------------------------------------ #
def _two_queues():
    queues = {}
    for name in ("ta", "tb"):
        g = build_cluster(name=name, nodes=2)
        sched = SchedulerInstance(name, g)
        queues[name] = JobQueue(sched, clock=SimClock())
    return queues


def test_actor_safe_consults_witness_order_graph():
    with lockwitness.scoped_witness():
        queues = _two_queues()          # locks created under the witness
        check_actor_safe(queues)        # no cross orders observed yet: ok
        qa, qb = queues["ta"], queues["tb"]
        # manufacture observed cross-revokes: each queue's API lock
        # taken while holding the other's
        with qa._api_lock:
            with qb._api_lock:
                pass
        with qb._api_lock:
            with qa._api_lock:
                pass
        with pytest.raises(ValueError, match="BOTH orders"):
            check_actor_safe(queues)
    # outside the witness scope the policy-flag heuristic still governs
    check_actor_safe(_two_queues())


def test_actor_safe_witness_one_directional_order_passes():
    with lockwitness.scoped_witness():
        queues = _two_queues()
        qa, qb = queues["ta"], queues["tb"]
        with qa._api_lock:
            with qb._api_lock:
                pass                    # one direction only: no AB-BA
        check_actor_safe(queues)


def test_mutually_preemptive_actor_group_still_refused():
    # regression for the shape heuristic alongside the witness path
    root = build_cluster(name="fleet", nodes=4)
    tenants = []
    for i in range(2):
        keep = [p for k in (2 * i, 2 * i + 1)
                for p in root.subtree(f"/fleet/node{k}")]
        sub = root.extract(keep)
        tenants.append(TenantSpec(
            f"t{i}", sub, policy=make_policy("preempt"),
            allow_grow=True))
    with pytest.raises(ValueError, match="mutually preemptive"):
        MultiTenantTree(root, tenants, clock=SimClock(), actors=True)


# ------------------------------------------------------------------ #
# MuxServer hoist regression: sends happen outside the server lock
# ------------------------------------------------------------------ #
def test_mux_server_concurrent_big_responses_two_threads():
    """Two client threads stream large pipelined batches at once; the
    per-connection drain (> the 1 MiB per-wakeup budget, so multiple
    partial sends) must not corrupt frames or starve the other
    connection's handler threads."""
    big = bytes(512 * 1024)

    def handler(method, payload):
        return method.encode() + b"|" + big

    srv = MuxServer(handler, workers=4)
    results = {}

    def client(tag):
        t = MuxTransport(srv.address)
        try:
            out = t.call_many([(f"{tag}-{i}", b"x") for i in range(6)])
            results[tag] = out
        finally:
            t.close()

    try:
        threads = [threading.Thread(target=client, args=(tag,))
                   for tag in ("c1", "c2")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert set(results) == {"c1", "c2"}
        for tag, out in results.items():
            assert out == [f"{tag}-{i}".encode() + b"|" + big
                           for i in range(6)]
    finally:
        srv.close()


def test_mux_server_hoist_under_witness_records_no_violation():
    """The hoisted send path run under a fresh witness: the server's
    internal locks must never be held across the socket send (no
    transport violations, no multi-thread cycles)."""
    with lockwitness.scoped_witness() as w:
        srv = MuxServer(lambda m, p: p * 2, workers=2)
        try:
            t = MuxTransport(srv.address)
            try:
                out = t.call_many([("m", bytes([i]) * 4096)
                                   for i in range(32)])
                assert out == [bytes([i]) * 8192 for i in range(32)]
            finally:
                t.close()
        finally:
            srv.close()
        assert w.fatal_cycles() == []


def test_jobqueue_locks_register_with_names():
    with lockwitness.scoped_witness():
        g = build_cluster(name="reg", nodes=2)
        q = JobQueue(SchedulerInstance("reg", g), clock=SimClock())
        assert q._api_lock.witness_name.startswith("jobqueue:reg")
        assert q._api_lock.allow_transport
        h = q.submit(Jobspec.hpc(nodes=1, sockets=1, cores=1),
                     walltime=1.0)
        assert h is not None
