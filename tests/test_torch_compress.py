"""The port's int8-compressed all-reduce (``repro_torch.parallel.compress``)
against ``repro.parallel.compress``: ``quantize_int8`` given JAX's own
uniform draws equals JAX's q and scale bit for bit, and the twin of
tests/test_elastic.py's ``test_compressed_psum_accuracy`` (slow there, a
JAX subprocess of 4 host devices) runs on a gloo world of 4 ranks as a
("pod", "data") mesh of 2 x 2: the same bounds, and the same output as
JAX's ``compressed_psum`` fed JAX's per-leaf draws."""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.parallel.compress import dequantize_int8 as jax_dequantize, quantize_int8 as jax_quantize
from repro_torch.parallel import compress
from torch_dist_harness import run_jax_oracle, run_world


@pytest.mark.parametrize("shape,seed", [((64, 64), 0), ((3, 5, 17), 1), ((1, 1), 2),
                                        ((8, 256), 3)])
def test_quantize_matches_jax_bitwise(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    x[..., 0] = 0.0                      # a zero column; and a row of zeros below
    if shape[0] > 1:
        x[0] = 0.0
    key = jax.random.key(seed + 10)
    jq, js = jax_quantize(jax.numpy.asarray(x), key)
    u = np.array(jax.random.uniform(key, shape))
    q, s = compress._quantize(torch.from_numpy(x), torch.from_numpy(u))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(compress.dequantize_int8(q, s).numpy(),
                                  np.asarray(jax_dequantize(jq, js)))


def test_quantize_roundtrip_bounded_by_scale():
    """The twin's second half: the round trip is within one step (the
    largest scale) of the input; the generator's draws are reproducible."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    q, s = compress.quantize_int8(x, torch.Generator().manual_seed(2))
    err = (compress.dequantize_int8(q, s) - x).abs().max().item()
    assert err <= s.max().item() + 1e-6
    q2, _ = compress.quantize_int8(x, torch.Generator().manual_seed(2))
    assert torch.equal(q, q2)


def _jax_inputs():
    """The leaves and JAX's per-leaf draws: the key split once a leaf, in
    JAX's sorted order ("b", then "w")."""
    g = {"w": jax.random.normal(jax.random.key(0), (64, 64)),
         "b": jax.random.normal(jax.random.key(3), (8, 16)) * 0.01}
    keys = jax.random.split(jax.random.key(1), 2)
    return {"w": np.array(g["w"]), "b": np.array(g["b"]),
            "u_b": np.array(jax.random.uniform(keys[0], g["b"].shape)),
            "u_w": np.array(jax.random.uniform(keys[1], g["w"].shape))}


ORACLE = """
from repro.parallel.compress import compressed_psum
mesh = auto_mesh((2, 2), ("pod", "data"))
g = {"w": jax.random.normal(jax.random.key(0), (64, 64)),
     "b": jax.random.normal(jax.random.key(3), (8, 16)) * 0.01}
out = compressed_psum(g, jax.random.key(1), mesh, axis="pod")
save(w=g["w"], b=g["b"], out_w=out["w"], out_b=out["b"])
"""


def _port_psum(rank, world, arrays):
    """On a ("pod", "data") mesh of 2 x 2: the replicated leaves through
    JAX's draws; through the rank's own generator, seeded alike on every
    rank; different leaves on the two pods; an axis of one rank."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("pod", "data"))
    flat = [torch.from_numpy(arrays["b"]), torch.from_numpy(arrays["w"])]
    draws = [torch.from_numpy(arrays["u_b"]), torch.from_numpy(arrays["u_w"])]
    pod = mesh.get_coordinate()[0]
    fed = compress._reduce_leaves(flat, draws, mesh.get_group("pod"), 2)
    grads = {"w": flat[1], "b": flat[0]}
    own = compress.compressed_psum(grads, torch.Generator().manual_seed(7), mesh, axis="pod")
    mine = {"w": flat[1] * (1.0 + pod)}                # pod p holds (1 + p) w
    mixed = compress.compressed_psum(mine, torch.Generator().manual_seed(8), mesh, axis="pod")
    one = DeviceMesh("cpu", torch.arange(4).reshape(4, 1), mesh_dim_names=("data", "pod"))
    same = compress.compressed_psum(grads, torch.Generator().manual_seed(9), one, axis="pod")
    gathered = [None] * world
    dist.all_gather_object(gathered, own["w"].numpy())
    return dict(fed_b=fed[0].numpy(), fed_w=fed[1].numpy(), own_w=own["w"].numpy(),
                own_b=own["b"].numpy(), own_all=gathered, mixed=mixed["w"].numpy(),
                untouched=same is grads)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """JAX's subprocess and the gloo world side by side, on the same leaves."""
    inputs = _jax_inputs()
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, ORACLE, tmp_path_factory.mktemp("compress"))
        ranks = run_world(_port_psum, 4, tmp_path_factory.mktemp("world"), args=(inputs,))
        oracle = oracle.result()
    for k in ("w", "b"):
        np.testing.assert_array_equal(oracle[k], inputs[k])
    return oracle, ranks


def test_compressed_psum_matches_jax_bitwise(results):
    """Fed JAX's per-leaf draws (the key split once a leaf, in JAX's
    sorted order), every rank returns JAX's output bit for bit."""
    oracle, ranks = results
    for r in ranks:
        np.testing.assert_array_equal(r["fed_w"], oracle["out_w"])
        np.testing.assert_array_equal(r["fed_b"], oracle["out_b"])


def test_compressed_psum_accuracy(results):
    """The twin of tests/test_elastic.py's test: a replicated input comes
    back within 0.02 of its range; every rank seeded alike returns the same."""
    oracle, ranks = results
    w = oracle["w"]
    for r in ranks:
        err = np.abs(r["own_w"] - w).max()
        assert err < 0.02 * np.abs(w).max(), err
        assert np.abs(r["own_b"] - oracle["b"]).max() < 0.02 * np.abs(oracle["b"]).max()
        for other in r["own_all"]:
            np.testing.assert_array_equal(other, ranks[0]["own_w"])


def test_compressed_psum_means_different_pods(results):
    """Pods holding w and 2w: the mean 1.5 w within two quantization steps
    of the larger pod's rows (one for each pod's rounding to the shared
    scale), and an axis of one rank returns the gradients untouched."""
    oracle, ranks = results
    w = oracle["w"]
    step = 2 * np.abs(w).max(axis=-1, keepdims=True) / 127.0
    for r in ranks:
        assert (np.abs(r["mixed"] - 1.5 * w) <= 2 * step + 1e-6).all()
        assert r["untouched"]
