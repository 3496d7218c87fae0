"""External provider tests (paper Section 5.3, Table 3).

The twin of tests/test_external.py on ``repro_torch.core``, the port's copy
of the control plane: only the imports are rewritten."""
import pytest

from repro_torch.core import (Jobspec, SimulatedEC2Provider, TABLE3_CATALOG,
                              TPUSliceProvider, fleet_catalog)


def test_table3_subgraph_sizes():
    """The paper's Table 3: instance type -> subgraph size.

    The six t2.* sizes match exactly under the vertex-per-resource
    encoding (node + per-vCPU core + per-GiB memory, 2 graph elements
    each).  The paper's GPU-instance sizes (g2: 42, g3: 282) do not back
    out to any consistent encoding of the real AWS specs (g2.2xlarge =
    8 vCPU/15 GiB/1 GPU, g3.4xlarge = 16 vCPU/122 GiB/4 GPU); we encode
    the real hardware and record the deviation in EXPERIMENTS.md."""
    want = {"t2.micro": 6, "t2.small": 8, "t2.medium": 14, "t2.large": 22,
            "t2.xlarge": 42, "t2.2xlarge": 82}
    for name, size in want.items():
        assert TABLE3_CATALOG[name].subgraph_size() == size, name
    # GPU instances: honest-hardware encoding, linear in resource count
    assert TABLE3_CATALOG["g2.2xlarge"].subgraph_size() == 2 * (1 + 8 + 15 + 1)
    assert TABLE3_CATALOG["g3.4xlarge"].subgraph_size() == 2 * (1 + 16 + 128 + 4)


def test_fleet_catalog_size():
    assert len(fleet_catalog(300)) == 300


def test_specific_instance_provision():
    ec2 = SimulatedEC2Provider()
    res = ec2.provision(Jobspec.instances("g3.4xlarge", 2), "/hpc")
    assert res is not None
    g = res.subgraph
    assert len(g.by_type("gpu")) == 8
    assert len(g.by_type("core")) == 32
    assert len(g.by_type("zone")) >= 1
    assert res.modeled_latency_s > 0 and res.encode_latency_s >= 0


def test_generic_request_maps_to_smallest_instance():
    ec2 = SimulatedEC2Provider(catalog=dict(TABLE3_CATALOG))
    js = Jobspec.hpc(nodes=1, sockets=1, cores=4, mem=8)
    res = ec2.provision(js, "/hpc")
    assert res is not None
    node = next(iter(res.subgraph.by_type("node")))
    assert res.subgraph.vertex(node).properties["instance_type"] == "t2.xlarge"


def test_fleet_request_provider_choice():
    ec2 = SimulatedEC2Provider(seed=7)
    res = ec2.provision(Jobspec.fleet(10), "/hpc")
    assert res is not None
    assert len(res.subgraph.by_type("node")) == 10
    types = {res.subgraph.vertex(n).properties["instance_type"]
             for n in res.subgraph.by_type("node")}
    assert len(types) > 1  # the provider chose a mix


def test_fleet_over_300_types_rejected():
    """The AWS API errors if >300 instance types are specified."""
    ec2 = SimulatedEC2Provider(catalog=fleet_catalog(300), max_fleet_types=299)
    with pytest.raises(ValueError):
        ec2.provision(Jobspec.fleet(1, allowed_types=list(fleet_catalog(300))),
                      "/hpc")


def test_tpu_slice_provider():
    tpu = TPUSliceProvider()
    res = tpu.provision(Jobspec.tpu(nodes=2), "/fleet")
    assert res is not None
    assert len(res.subgraph.by_type("chip")) == 8
