"""The port's model against ``repro.models.model`` at the reduced llama3.2-3b,
qwen3-moe and llama4-maverick configs (fp32), on JAX's weights copied
through ``params_from_jax``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import get_config as jax_get_config
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.model import make_model as jax_make_model
from repro.parallel.sharding import Rules, ShardingCtx
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.config import ArchConfig, ShapeConfig
from repro_torch.models.model import make_model

ARCH = "llama3.2-3b"


@pytest.fixture(scope="module")
def pair():
    jcfg = jax_get_config(ARCH).reduced()
    jmodel = jax_make_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(get_config(ARCH).reduced(), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


def test_params_from_jax_round_trips_every_leaf(pair):
    jmodel, jparams, model = pair
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jax_leaves = {".".join(p.key for p in path): np.asarray(v) for path, v in flat}
    state = model.state_dict()
    assert list(jax_leaves) == list(model.param_specs())
    assert sorted(state) == sorted(jax_leaves)
    for name, want in jax_leaves.items():
        got = state[name]
        assert tuple(got.shape) == want.shape and str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_jax_keeps_bf16():
    a = jnp.arange(6, dtype=jnp.float32).reshape(2, 3).astype(jnp.bfloat16) / 7
    got = params_from_jax({"w": jax.device_get(a)})["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(a, np.float32))


def test_init_rule_matches_jax_distribution():
    """fan_in = shape[-2] (V for the embedding), x0.1 for "small", zeros
    for norms; drawn from the torch generator."""
    model = make_model(get_config(ARCH).reduced(), device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    state = model.state_dict()
    for name, spec in model.param_specs().items():
        w = state[name]
        if spec.init == "zeros":
            assert not w.any(), name
            continue
        fan_in = spec.shape[-2]
        want = (0.1 if spec.init == "small" else 1.0) / np.sqrt(fan_in)
        assert abs(w.std().item() / want - 1) < 0.1, name
        assert abs(w.mean().item()) < 0.1 * want, name


def test_prefill_matches_jax(pair):
    jmodel, jparams, model = pair
    toks = _tokens(2, 16, model.cfg.vocab)
    jlog, jcache = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill_step(torch.from_numpy(toks).long())
    assert log.shape == (2, 1, model.cfg.vocab)
    _close(log, jlog, 1e-4)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], 1e-4)


def test_serve_step_matches_jax(pair):
    """Prefill spliced into bf16 max_len buffers, then one decode step."""
    jmodel, jparams, model = pair
    b, s, S = 2, 12, 20
    toks = _tokens(b, s + 1, model.cfg.vocab, seed=2)
    shape = ShapeConfig("serve", S, b, "decode")
    _, jpc = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks[:, :s])})
    jcache = {k: jnp.zeros_like(v).at[:, :, :s].set(jpc[k].astype(v.dtype))
              for k, v in jmodel.init_cache(JaxShapeConfig("serve", S, b, "decode")).items()}
    jlog, jnew = jax.jit(jmodel.serve_step)(jparams, jcache,
                                            {"tokens": jnp.asarray(toks[:, s:])},
                                            jnp.int32(s))
    _, pc = model.prefill_step(torch.from_numpy(toks[:, :s]).long())
    cache = model.init_cache(shape)
    assert all(c.dtype == torch.bfloat16 for c in cache.values())
    for k in cache:
        cache[k][:, :, :s].copy_(pc[k])
    log, new = model.serve_step(cache, torch.from_numpy(toks[:, s:]).long(), s)
    assert new["k"] is cache["k"]
    _close(log, jlog, 1e-4)
    for k in ("k", "v"):
        _close(new[k], jnew[k].astype(jnp.float32), 2e-2)   # bf16 entries


def test_decode_consistent_with_forward(pair):
    """The port's twin of tests/test_models_smoke.py: prefill(s tokens) +
    decode(token s) equals a full forward over s+1 tokens at the last
    position (fp32 cache grown by one slot, atol 2e-3)."""
    _, _, model = pair
    s = 16
    toks = torch.from_numpy(_tokens(2, s + 1, model.cfg.vocab, seed=3)).long()
    full = model.forward_logits(toks)
    _, cache = model.prefill_step(toks[:, :s])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
    log, _ = model.serve_step(cache, toks[:, s:], s)
    np.testing.assert_allclose(log[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------- #
# MoE: qwen3-moe (every layer) and llama4-maverick (a dense and a MoE layer
# a group, a shared expert), reduced, fp32, capacity dispatch (drops some
# pairs at these sizes: the same ones on both sides)
# ---------------------------------------------------------------------- #
MOE_ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"]


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    jcfg = jax_get_config(request.param).reduced()
    jmodel = jax_make_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(get_config(request.param).reduced(), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


def _seq_axis(cache):
    """The sequence axis of a k/v cache: [..., s, kvh, d]."""
    return cache.ndim - 3


def test_moe_params_from_jax_round_trip(moe_pair):
    jmodel, jparams, model = moe_pair
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jax_leaves = {".".join(p.key for p in path): np.asarray(v) for path, v in flat}
    assert list(jax_leaves) == list(model.param_specs())
    state = model.state_dict()
    for name, want in jax_leaves.items():
        np.testing.assert_array_equal(state[name].numpy(), want)


def test_moe_serving_cast_keeps_router_fp32():
    """The serving copy casts what JAX casts at each use: the expert and
    shared-expert matrices to bf16; the router and norms stay fp32."""
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b").reduced(), dtype="bfloat16")
    model = make_model(cfg, device="cpu")
    ffn = model.compute_params()["blocks"]["moe"]["ffn"]
    assert {k: str(v.dtype) for k, v in ffn.items()} == {
        "router": "torch.float32", "norm": "torch.float32",
        **{k: "torch.bfloat16" for k in ("w_up", "w_gate", "w_down",
                                         "shared_up", "shared_gate", "shared_down")}}


def test_moe_forward_matches_jax(moe_pair):
    jmodel, jparams, model = moe_pair
    toks = _tokens(2, 16, model.cfg.vocab, seed=4)
    from repro.models.transformer import forward as jax_forward
    jlog, _ = jax_forward(jparams, jmodel.cfg, jmodel.ctx, tokens=jnp.asarray(toks))
    _close(model.forward_logits(torch.from_numpy(toks).long()), jlog, 1e-4)


def test_moe_prefill_matches_jax(moe_pair):
    jmodel, jparams, model = moe_pair
    toks = _tokens(2, 16, model.cfg.vocab, seed=5)
    jlog, jcache = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill_step(torch.from_numpy(toks).long())
    _close(log, jlog, 1e-4)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], 1e-4)


def test_moe_serve_step_matches_jax(moe_pair):
    """Prefill spliced into bf16 max_len buffers, then one decode step."""
    jmodel, jparams, model = moe_pair
    b, s, S = 2, 12, 20
    toks = _tokens(b, s + 1, model.cfg.vocab, seed=6)
    _, jpc = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks[:, :s])})
    jcache = {}
    for k, v in jmodel.init_cache(JaxShapeConfig("serve", S, b, "decode")).items():
        idx = (slice(None),) * _seq_axis(v) + (slice(0, s),)
        jcache[k] = jnp.zeros_like(v).at[idx].set(jpc[k].astype(v.dtype))
    jlog, jnew = jax.jit(jmodel.serve_step)(jparams, jcache,
                                            {"tokens": jnp.asarray(toks[:, s:])},
                                            jnp.int32(s))
    _, pc = model.prefill_step(torch.from_numpy(toks[:, :s]).long())
    cache = model.init_cache(ShapeConfig("serve", S, b, "decode"))
    for k, v in cache.items():
        assert v.shape == jcache[k].shape and v.dtype == torch.bfloat16
        v[(slice(None),) * _seq_axis(v) + (slice(0, s),)].copy_(pc[k])
    log, new = model.serve_step(cache, torch.from_numpy(toks[:, s:]).long(), s)
    assert new["k"] is cache["k"]
    _close(log, jlog, 1e-4)
    for k in ("k", "v"):
        _close(new[k], jnew[k].astype(jnp.float32), 2e-2)   # bf16 entries


def test_moe_decode_consistent_with_forward(moe_pair):
    """The twin of tests/test_models_smoke.py's qwen3-moe case, for both
    MoE layouts, under ``moe_impl="dense"``: dispatch drops differ between
    s and s + 1 tokens, the dense oracle drops nothing."""
    _, _, model = moe_pair
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, moe_impl="dense")
    try:
        s = 16
        toks = torch.from_numpy(_tokens(2, s + 1, cfg.vocab, seed=7)).long()
        full = model.forward_logits(toks)
        _, cache = model.prefill_step(toks[:, :s])
        cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
        log, _ = model.serve_step(cache, toks[:, s:], s)
    finally:
        model.cfg = cfg
    np.testing.assert_allclose(log[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("factor", [1.0, 0.5])
def test_moe_a2a_forward_and_prefill_match_jax(moe_pair, factor):
    """``moe_impl="a2a"`` through the whole model: the forward logits and
    the prefill against JAX's model under a one-device ("data", "model")
    mesh, as JAX's runtime binds it (without a mesh JAX's ``moe_a2a`` runs
    the dispatch instead)."""
    from repro.models.transformer import forward as jax_forward
    jmodel, jparams, model = moe_pair
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jcfg = dataclasses.replace(jmodel.cfg, moe_impl="a2a", capacity_factor=factor)
    jm = jax_make_model(jcfg, ShardingCtx(Rules(), mesh))
    cfg = model.cfg
    model.cfg = ArchConfig(**vars(jcfg))
    try:
        toks = _tokens(2, 16, cfg.vocab, seed=10)
        jlog, _ = jax.jit(lambda p, t: jax_forward(p, jcfg, jm.ctx, tokens=t))(
            jparams, jnp.asarray(toks))
        _close(model.forward_logits(torch.from_numpy(toks).long()), jlog, 1e-4)
        jlast, jcache = jax.jit(jm.prefill_step)(jparams, {"tokens": jnp.asarray(toks)})
        last, cache = model.prefill_step(torch.from_numpy(toks).long())
        _close(last, jlast, 1e-4)
        for name in ("k", "v"):
            _close(cache[name], jcache[name], 1e-4)
    finally:
        model.cfg = cfg


def test_moe_bf16_paths_diverge_as_in_the_reference():
    """Why chip_smoke.py holds the dispatch (nothing dropped) against the
    dense oracle in fp32: in bf16 the two MoE paths round differently, a
    rounding moves a token whose k-th and (k+1)-th router probabilities are
    near equal to another expert, and that grows with depth. The JAX
    reference's own two paths do the same (16 layers, 128 experts top-8,
    bf16: over 2e-2 of the largest logit apart), and agree in fp32; so do
    the port's."""
    cfg = dataclasses.replace(jax_get_config("qwen3-moe-30b-a3b").reduced(), n_layers=16,
                              d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
                              n_experts=128, top_k=8, moe_d_ff=32, vocab=128)
    jmodel = jax_make_model(cfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(ArchConfig(**vars(cfg)), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    toks = _tokens(2, 48, cfg.vocab, seed=9)
    from repro.models.transformer import forward as jax_forward

    def gap(logits):
        dense, disp = (np.asarray(a, np.float32) for a in logits)
        return np.abs(disp - dense).max() / np.abs(dense).max()

    for dtype, lo, hi in (("bfloat16", 2e-2, None), ("float32", None, 1e-5)):
        jax_logits, logits = [], []
        for kw in (dict(moe_impl="dense"), dict(capacity_factor=cfg.n_experts / cfg.top_k)):
            c = dataclasses.replace(cfg, dtype=dtype, **kw)
            jax_logits.append(jax_forward(jparams, c, jmodel.ctx, tokens=jnp.asarray(toks))[0])
            model.cfg, model._compute = ArchConfig(**vars(c)), None
            logits.append(model.forward_logits(torch.from_numpy(toks).long()).float())
        for g in (gap(jax_logits), gap(logits)):
            assert (lo is None or g > lo) and (hi is None or g < hi), (dtype, g)
