"""The scheduler slice of the port: the dynamic, hierarchical resource
graph (``graph.py``), its transforms (``transform.py``), its flat-array
mirror (``flatgraph.py``) and the matcher (``match.py``). Copies of
``repro/core``'s modules of the same names; the control plane (queue,
policies, engine, transport, API) is not ported."""
from .flatgraph import FlatGraph, FlatMatcher, aggregate_sweep, flat_enabled
from .graph import CONTAINMENT, ResourceGraph, Vertex, build_cluster, build_tpu_fleet
from .jobspec import Jobspec, ResourceReq
from .match import Matcher
from .transform import (TransformKind, TransformResult, add_subgraph,
                        remove_subgraph, splice_jgf, update_metadata)

__all__ = [
    "CONTAINMENT", "ResourceGraph", "Vertex", "build_cluster", "build_tpu_fleet",
    "Jobspec", "ResourceReq", "Matcher", "FlatGraph", "FlatMatcher",
    "aggregate_sweep", "flat_enabled", "TransformKind", "TransformResult",
    "add_subgraph", "remove_subgraph", "splice_jgf", "update_metadata",
]
