"""The port's control plane: the dynamic, hierarchical resource graph
(``graph.py``), its transforms (``transform.py``), its flat-array mirror
(``flatgraph.py``), the matcher (``match.py``), and the closure that the
training runtime drives: the MATCHGROW engine (``engine.py``), scheduler
instances and hierarchies (``scheduler.py``), the job queue and its
policies (``queue.py``, ``policy.py``), typed events (``events.py``), the
transport (``rpc.py``), external providers (``external.py``), the
``Instance`` facade (``api.py``) and multi-tenant trees (``tenancy.py``).
Copies of ``repro/core``'s modules of the same names; actors and metrics
are not ported."""
from .graph import CONTAINMENT, ResourceGraph, Vertex, build_cluster, build_tpu_fleet
from .jobspec import Jobspec, ResourceReq
from .match import Matcher
from .flatgraph import FlatGraph, FlatMatcher, aggregate_sweep, flat_enabled
from .transform import (TransformKind, TransformResult, add_subgraph,
                        remove_subgraph, splice_jgf, update_metadata)
from .engine import Allocation, GrowEngine, GrowResult, MGTiming
from .scheduler import (Hierarchy, SchedulerInstance, TreeSpec, build_chain,
                        build_tree)
from .queue import (Clock, Job, JobQueue, JobState, QueueStats, SimClock,
                    WallClock)
from .policy import (POLICIES, ConservativeBackfill, EasyBackfill, FCFS,
                     FirstFit, PreemptivePriority, PriorityFCFS,
                     SchedulingPolicy, make_policy)
from .events import EventLog, EventType, JobEvent
from .api import (Instance, JobHandle, RemoteInstance, RemoteJobHandle,
                  RemoteSubscription)
from .tenancy import (FairShareArbiter, Lease, LeaseLedger, MultiTenantTree,
                      TenantSpec)
from .external import (AWS_ZONES, TABLE3_CATALOG, ExternalProvider,
                       InstanceType, ProvisionResult, SimulatedEC2Provider,
                       TPUSliceProvider, fleet_catalog)
from .rpc import (ClientReactor, MethodRegistry, MuxServer, MuxTransport,
                  ProtocolError, RPCError, RPCServer, SocketTransport)

__all__ = [
    "CONTAINMENT", "ResourceGraph", "Vertex", "build_cluster",
    "build_tpu_fleet", "Jobspec", "ResourceReq", "Matcher",
    "FlatGraph", "FlatMatcher", "aggregate_sweep", "flat_enabled",
    "TransformKind", "TransformResult", "add_subgraph", "remove_subgraph",
    "splice_jgf", "update_metadata",
    "Allocation", "GrowEngine", "GrowResult", "Hierarchy", "MGTiming",
    "SchedulerInstance", "TreeSpec", "build_chain", "build_tree",
    "Clock", "Job", "JobQueue", "JobState", "QueueStats", "SimClock",
    "WallClock", "MethodRegistry", "MuxServer", "MuxTransport",
    "ClientReactor", "ProtocolError", "RPCError", "RPCServer",
    "SocketTransport",
    "EventLog", "EventType", "JobEvent",
    "Instance", "JobHandle", "RemoteInstance", "RemoteJobHandle",
    "RemoteSubscription",
    "FairShareArbiter", "Lease", "LeaseLedger", "MultiTenantTree", "TenantSpec",
    "POLICIES", "ConservativeBackfill", "EasyBackfill", "FCFS",
    "FirstFit", "PreemptivePriority", "PriorityFCFS", "SchedulingPolicy",
    "make_policy",
    "AWS_ZONES", "TABLE3_CATALOG", "ExternalProvider", "InstanceType",
    "ProvisionResult", "SimulatedEC2Provider", "TPUSliceProvider",
    "fleet_catalog",
]
