"""Serving with elastic replica scheduling (KubeFlux-style), on the
PyTorch/CUDA port: the twin of ``burst_serve.py``.

A batch of requests is served from a prefill+decode loop while the
scheduler scales the replica set through MATCHGROW — the paper's
"cloud orchestration framework tasks" capability.

Run:  PYTHONPATH=src python examples/torch_burst_serve.py [--device cpu]
"""
import argparse

from repro_torch.core import (Jobspec, ResourceReq, SchedulerInstance,
                              SimulatedEC2Provider, build_cluster)
from repro_torch.launch.serve import run_serving


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # control plane: schedule serving replicas via MA, scale via MG, burst
    # to the cloud when the local cluster saturates
    g = build_cluster(nodes=2, sockets_per_node=2, cores_per_socket=8, device=args.device)
    sched = SchedulerInstance("orchestrator", g, external=SimulatedEC2Provider(seed=11))
    pod = Jobspec(resources=[ResourceReq("core", 4)])
    sched.match_allocate(pod, jobid="replicaset")
    for _ in range(12):                       # exceeds the 32 local cores
        assert sched.match_grow(pod, "replicaset")
    ext = list(sched.external_paths)
    print(f"replicaset: {len(sched.allocations['replicaset'].paths)} vertices, "
          f"{len(ext)} from the cloud provider")

    # data plane: each replica runs prefill+decode on its shard of requests
    out = run_serving("llama3.2-3b", batch=4, prompt_len=16, gen=16, smoke=True,
                      device=args.device)
    assert out["logits_finite"]
    print(f"served {out['tokens'].shape[0]} sequences x "
          f"{out['tokens'].shape[1]} tokens")


if __name__ == "__main__":
    main()
