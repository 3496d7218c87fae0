"""Actor-loop tests: per-instance workers over sibling tenant queues.

The actor layer must preserve the single-driver contract — every
submitted job completes, fixpoint rounds end when a round starts
nothing — while running sibling tenants' scheduling passes
concurrently.  Interleavings may differ between the two modes (both
are valid schedules); completion counts may not.

The twin of tests/test_actor.py on ``repro_torch``, the port's copy
of the control plane: only the imports are rewritten, and the graphs are built
with ``device="cpu"`` (the port's graphs take the device of their flat mirror);
the tenants' parent cluster is named "fleet" where the original names it
"root"."""
import functools
import pytest

from repro_torch.core import (Jobspec, QueueActor, SimClock, build_cluster,
                              check_actor_safe, make_policy)
from repro_torch.core.tenancy import MultiTenantTree, TenantSpec

# the port's graphs take the device of their flat mirror; these run on the CPU
build_cluster = functools.partial(build_cluster, device="cpu")


def _make_tree(actors: bool, n_tenants: int = 2,
               policies=None) -> MultiTenantTree:
    root = build_cluster(name="fleet", nodes=2 * n_tenants)
    tenants = []
    for i in range(n_tenants):
        keep = [p for k in (2 * i, 2 * i + 1)
                for p in root.subtree(f"/fleet/node{k}")]
        sub = root.extract(keep)
        pol = policies[i] if policies else None
        tenants.append(TenantSpec(f"t{i}", sub, policy=pol,
                                  allow_grow=True))
    return MultiTenantTree(root, tenants, clock=SimClock(),
                           actors=actors)


def test_actor_group_completes_same_job_set():
    jobs = [(i % 2, Jobspec.hpc(nodes=1, sockets=2, cores=32), 2.0)
            for i in range(12)]
    results = {}
    for actors in (False, True):
        mt = _make_tree(actors)
        try:
            for tenant, js, wall in jobs:
                mt.queue(f"t{tenant}").submit(js, walltime=wall)
            done = mt.drain()
            stats = [q.stats() for q in mt.queues.values()]
            assert sum(s.completed for s in stats) == len(jobs)
            results[actors] = len(done)
        finally:
            mt.close()
    assert results[False] == results[True] == len(jobs)


def test_actor_step_reaches_fixpoint():
    mt = _make_tree(actors=True)
    try:
        for i in range(4):
            mt.queue(f"t{i % 2}").submit(
                Jobspec.hpc(nodes=1, sockets=2, cores=32), walltime=1.0)
        started = mt.step()
        assert started == 4
        # a second pass with nothing new starts nothing and returns
        assert mt.step() == 0
        assert mt.actors.rounds >= 2
    finally:
        mt.close()


def test_actor_advance_stops_at_completions():
    mt = _make_tree(actors=True)
    try:
        q = mt.queue("t0")
        q.submit(Jobspec.hpc(nodes=1, sockets=2, cores=32), walltime=1.0)
        q.submit(Jobspec.hpc(nodes=1, sockets=2, cores=32), walltime=1.0)
        mt.step()
        mt.advance(5.0)
        assert q.stats().completed == 2
        assert mt.clock.now() == pytest.approx(5.0)
    finally:
        mt.close()


def test_mutually_preemptive_tenants_refused():
    pre = make_policy("preempt")
    with pytest.raises(ValueError, match="mutually preemptive"):
        _make_tree(actors=True, policies=[pre, make_policy("preempt")])
    # one preemptive tenant is one-directional and allowed
    mt = _make_tree(actors=True, policies=[pre, None])
    mt.close()


def test_check_actor_safe_direct():
    mt = _make_tree(actors=False)
    try:
        check_actor_safe(mt.queues)   # non-preemptive: fine
    finally:
        mt.close()


def test_queue_actor_surfaces_exceptions():
    mt = _make_tree(actors=False)
    try:
        actor = QueueActor(mt.queue("t0"), "t0")
        def boom():
            raise RuntimeError("kaboom")
        fut = actor.tell(boom)
        with pytest.raises(RuntimeError, match="kaboom"):
            fut.result(timeout=5)
        # the worker survives a failed message
        assert actor.tell(lambda: 42).result(timeout=5) == 42
        actor.close()
    finally:
        mt.close()
