"""The port's layers against ``repro.models.layers``, layer by layer, on
the same numpy weights and inputs at the fp32 reduced config (atol 1e-5:
both sides compute in fp32, in another summation order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jl
from repro.parallel.sharding import ShardingCtx
from repro_torch.configs import get_config
from repro_torch.models import layers as tl

ATOL = 1e-5
CTX = ShardingCtx()


def _cfgs(arch="llama3.2-3b"):
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


def _weights(specs, rng):
    """numpy weights for a spec dict: random for every leaf (norms too,
    so that the 1 + w scale is exercised)."""
    return {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
            for k, s in specs.items()}


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(ours, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(ours.float()), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
           jl.rmsnorm(jnp.asarray(x), jnp.asarray(w)))


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[0], [40]])).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5))


def test_attention_prefill():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(2)
    jp, tp = _both(_weights(tl.attn_specs(cfg), rng))
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jo, jc = jl.attention(jnp.asarray(x), jp, jcfg, CTX, jnp.asarray(pos), want_cache=True)
    to, tc = tl.attention(torch.from_numpy(x), tp, cfg, torch.from_numpy(pos.copy()),
                          want_cache=True)
    _close(to, jo)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_attention_cached_decode_rounds_cache_to_bf16():
    """Decode writes the new k/v into the bf16 cache at cache_index (in
    place in the port) and attends positions <= pos over the bf16 values."""
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(3)
    jp, tp = _both(_weights(tl.attn_specs(cfg), rng))
    b, S, pos = 2, 24, 9
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    cv = rng.standard_normal((b, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    positions = np.full((b, 1), pos, np.int32)
    jo, jc = jl.attention(jnp.asarray(x), jp, jcfg, CTX, jnp.asarray(positions),
                          cache={"k": jnp.asarray(ck, jnp.bfloat16),
                                 "v": jnp.asarray(cv, jnp.bfloat16)},
                          cache_index=pos)
    tcache = {"k": torch.from_numpy(ck).bfloat16(), "v": torch.from_numpy(cv).bfloat16()}
    to, tc = tl.attention(torch.from_numpy(x), tp, cfg, torch.from_numpy(positions),
                          cache=tcache, cache_index=pos)
    assert tc["k"] is tcache["k"] and tc["k"].dtype == torch.bfloat16
    _close(to, jo)
    # the new entries are the same fp32 values (to 1e-5) rounded to bf16:
    # equal up to one bf16 step where a value sits on a rounding boundary
    for name in ("k", "v"):
        _close(tc[name], jc[name].astype(jnp.float32), atol=1e-2)
        np.testing.assert_array_equal(
            np.delete(tc[name].float().numpy(), pos, axis=1),
            np.delete(np.asarray(jc[name].astype(jnp.float32)), pos, axis=1))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "nemotron-4-15b", "zamba2-2.7b"])  # swiglu, relu2, gelu
def test_mlp(arch):
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(4)
    jp, tp = _both(_weights(tl.mlp_specs(cfg), rng))
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    _close(tl.mlp(torch.from_numpy(x), tp, cfg), jl.mlp(jnp.asarray(x), jp, jcfg, CTX))


def test_gelu_is_jax_tanh_form():
    """jax.nn.gelu's default is the tanh form; torch's erf form differs by
    up to ~4e-4 on [-3, 3], beyond the fp32 tolerances."""
    import jax
    x = np.linspace(-6, 6, 2001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    assert np.abs(torch.nn.functional.gelu(torch.from_numpy(x)).numpy() - want).max() > 1e-4


def test_embed_and_lm_logits():
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(5)
    jp, tp = _both(_weights(tl.embed_specs(cfg), rng))
    toks = rng.integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    _close(tl.embed_tokens(torch.from_numpy(toks).long(), tp, cfg),
           jl.embed_tokens(jnp.asarray(toks), jp, jcfg, CTX))
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    _close(tl.lm_logits(torch.from_numpy(x), tp, cfg),
           jl.lm_logits(jnp.asarray(x), jp, jcfg, CTX))


def test_param_specs_match_jax():
    """Same names, shapes and init rules as the JAX specs."""
    for arch in ("llama3.2-3b", "nemotron-4-15b"):
        jcfg, cfg = _cfgs(arch)
        for jfn, tfn in ((jl.attn_specs, tl.attn_specs), (jl.mlp_specs, tl.mlp_specs),
                         (jl.embed_specs, tl.embed_specs)):
            js, ts = jfn(jcfg), tfn(cfg)
            assert sorted(js) == sorted(ts)
            for k in js:
                assert (js[k].shape, js[k].init, js[k].dtype) == \
                    (ts[k].shape, ts[k].init, ts[k].dtype)
