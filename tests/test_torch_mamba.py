"""The port's SSM (mamba2) and hybrid (zamba2) families against the JAX
package's, on the CPU, at the reduced fp32 configs.

Layer by layer (``mamba_layer`` prefill and decode on numpy weights),
then whole models on JAX's weights copied through ``params_from_jax``:
forward logits and the prefill cache, one serve step, prefill plus decode
against a forward, and greedy serving. Tolerances: 1e-4 where both sides
compute the same fp32 function in another order of sums (the chunked
scan, tests/test_kernels.py's 1e-4); 2e-3 for the cache path, as
tests/test_models_smoke.py:53-88; 2e-2 for entries of the bf16 KV cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import mamba2 as jm
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.model import make_model as jax_make_model
from repro.models.transformer import forward as jax_forward
from repro.parallel.sharding import ShardingCtx
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import serve
from repro_torch.models import mamba2 as tm
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import make_model
from repro_torch.models.transformer import forward

ARCHS = ["mamba2-2.7b", "zamba2-2.7b"]
KV = ("shared_k", "shared_v")


def _close(ours, ref, atol=1e-4):
    np.testing.assert_allclose(np.asarray(ours.float()), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------- #
# the layer
# ---------------------------------------------------------------------- #
def _layer_weights(cfg, seed):
    """numpy weights for one Mamba2 block: every leaf random (norms too, so
    the 1 + w scale is exercised); A_log and dt_bias small, D near 1."""
    rng = np.random.default_rng(seed)
    out = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
           for k, s in tm.mamba_specs(cfg).items()}
    out["D"] += 1.0
    return out


def _layer_pair(arch="mamba2-2.7b", seed=0):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    w = _layer_weights(cfg, seed)
    return (jcfg, {k: jnp.asarray(v) for k, v in w.items()},
            cfg, {k: torch.from_numpy(v) for k, v in w.items()})


def test_mamba_specs_match_jax():
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        js, ts = jm.mamba_specs(jcfg), tm.mamba_specs(cfg)
        assert sorted(js) == sorted(ts)
        for k in js:
            assert (js[k].shape, js[k].init, js[k].dtype) == (ts[k].shape, ts[k].init,
                                                             ts[k].dtype)
        jstate = jm.mamba_state_specs(jcfg, 3)
        for k, (shape, dtype) in tm.mamba_state_specs(cfg, 3).items():
            assert shape == jstate[k].shape and dtype == torch.float32


@pytest.mark.parametrize("s", [16, 21])     # a chunk multiple (8) and a ragged length
@pytest.mark.parametrize("want_state", [False, True])
def test_mamba_layer_prefill_vs_jax(s, want_state):
    jcfg, jp, cfg, tp = _layer_pair()
    x = np.random.default_rng(1).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jy, jst = jm.mamba_layer(jnp.asarray(x), jp, jcfg, ShardingCtx(), want_state=want_state)
    ty, tst = tm.mamba_layer(torch.from_numpy(x), tp, cfg, want_state=want_state)
    assert ty.shape == (2, s, cfg.d_model)
    _close(ty, jy)
    if want_state:
        for k in ("conv", "ssm"):
            assert tst[k].dtype == torch.float32 and tst[k].shape == jst[k].shape
            _close(tst[k], jst[k])
    else:
        assert tst is None


def test_mamba_layer_decode_vs_jax():
    """Three recurrent steps from a random fp32 state, each fed the
    previous step's state: outputs and states agree."""
    jcfg, jp, cfg, tp = _layer_pair(seed=2)
    rng = np.random.default_rng(3)
    b = 2
    st = {k: rng.standard_normal(shape).astype(np.float32)
          for k, (shape, _) in tm.mamba_state_specs(cfg, b).items()}
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    for _ in range(3):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jy, jst = jm.mamba_layer(jnp.asarray(x), jp, jcfg, ShardingCtx(), state=jst)
        ty, tst = tm.mamba_layer(torch.from_numpy(x), tp, cfg, state=tst)
        _close(ty, jy)
        for k in ("conv", "ssm"):
            assert tst[k].dtype == torch.float32
            _close(tst[k], jst[k])


def test_mamba_layer_decode_continues_prefill():
    """Prefill of s tokens with its state, then one recurrent step, equals
    the prefill of s + 1 tokens at the last position."""
    _, _, cfg, tp = _layer_pair(seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32))
    full, _ = tm.mamba_layer(x, tp, cfg)
    _, st = tm.mamba_layer(x[:, :12], tp, cfg, want_state=True)
    step, _ = tm.mamba_layer(x[:, 12:], tp, cfg, state=st)
    _close(step[:, 0], full[:, -1].numpy(), atol=1e-5)


# ---------------------------------------------------------------------- #
# the models
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jcfg = jax_get_config(request.param).reduced()
    jmodel = jax_make_model(jcfg)
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(get_config(request.param).reduced(), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


def test_params_from_jax_round_trips_every_leaf(pair):
    jmodel, jparams, model = pair
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    jax_leaves = {".".join(p.key for p in path): np.asarray(v) for path, v in flat}
    assert list(jax_leaves) == list(model.param_specs())
    state = model.state_dict()
    assert sorted(state) == sorted(jax_leaves)
    for name, want in jax_leaves.items():
        assert str(state[name].dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(state[name].numpy(), want)
    parts = {"embed", "blocks"} | ({"shared"} if model.cfg.family == "hybrid" else set())
    assert set(model.parts) == parts


def test_forward_logits_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _tokens(2, 21, model.cfg.vocab, seed=1)       # ragged: chunk 8
    jlog, _ = jax_forward(jparams, jmodel.cfg, jmodel.ctx, tokens=jnp.asarray(toks))
    log, _ = forward(model.compute_params(), model.cfg, torch.from_numpy(toks).long())
    assert log.shape == (2, 21, model.cfg.vocab)
    _close(log, jlog)


def test_prefill_logits_and_cache_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _tokens(2, 16, model.cfg.vocab, seed=2)
    jlog, jcache = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks)})
    log, cache = model.prefill_step(torch.from_numpy(toks).long())
    assert log.shape == (2, 1, model.cfg.vocab)
    _close(log, jlog)
    assert sorted(cache) == sorted(jcache)
    for name, want in jcache.items():
        assert tuple(cache[name].shape) == want.shape
        assert str(cache[name].dtype) == f"torch.{want.dtype}"
        _close(cache[name], want)


def test_cache_buffers_match_jax(pair):
    """fp32 SSM states and bf16 shared KV, the shapes of init_cache_specs."""
    jmodel, _, model = pair
    shape = (2, 24)
    want = jmodel.init_cache(JaxShapeConfig("serve", shape[1], shape[0], "decode"))
    got = model.init_cache(ShapeConfig("serve", shape[1], shape[0], "decode"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape and str(got[name].dtype) == f"torch.{w.dtype}"
        assert not got[name].any()


def test_serve_step_matches_jax(pair):
    """Prefill spliced into the max_len buffers, then one decode step."""
    jmodel, jparams, model = pair
    b, s, S = 2, 12, 20
    toks = _tokens(b, s + 1, model.cfg.vocab, seed=3)
    _, jpc = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks[:, :s])})
    jcache = {k: (jpc[k] if jpc[k].shape == v.shape
                  else v.at[:, :, :s].set(jpc[k].astype(v.dtype)))
              for k, v in jmodel.init_cache(JaxShapeConfig("serve", S, b, "decode")).items()}
    jlog, jnew = jax.jit(jmodel.serve_step)(jparams, jcache,
                                            {"tokens": jnp.asarray(toks[:, s:])}, jnp.int32(s))
    _, pc = model.prefill_step(torch.from_numpy(toks[:, :s]).long())
    cache = model.init_cache(ShapeConfig("serve", S, b, "decode"))
    serve.splice_cache(cache, pc)
    log, new = model.serve_step(cache, torch.from_numpy(toks[:, s:]).long(), s)
    assert all(new[k] is cache[k] for k in cache)           # updated in place
    _close(log, jlog)
    for name, want in jnew.items():
        _close(new[name], want.astype(jnp.float32), 2e-2 if name in KV else 1e-4)


def test_decode_consistent_with_forward(pair):
    """The port's twin of tests/test_models_smoke.py:53-88: prefill(s) +
    decode(token s) equals a forward over s + 1 tokens at the last
    position (the chunked scan against the recurrence; KV grown by one)."""
    _, _, model = pair
    s = 16
    toks = torch.from_numpy(_tokens(2, s + 1, model.cfg.vocab, seed=4)).long()
    full = model.forward_logits(toks)
    _, cache = model.prefill_step(toks[:, :s])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) if k in KV else v
             for k, v in cache.items()}
    log, _ = model.serve_step(cache, toks[:, s:], s)
    np.testing.assert_allclose(log[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


def _bf16_cache_gap(arch: str) -> float:
    """max |prefill(s) + decode - forward(s + 1)| over the largest logit,
    at the reduced config computing in bf16."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = make_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(1))
    s = 16
    toks = torch.from_numpy(_tokens(2, s + 1, cfg.vocab, seed=5)).long()
    full = model.forward_logits(toks)[:, -1].float()
    _, cache = model.prefill_step(toks[:, :s])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) if k in KV else v
             for k, v in cache.items()}
    log, _ = model.serve_step(cache, toks[:, s:], s)
    return ((log[:, 0].float() - full).abs().max() / full.abs().max()).item()


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_cache_gap_is_the_conv_rounding(arch, monkeypatch):
    """In bf16, decode and a forward differ by about 1% of the largest
    logit here, as in the JAX model: its prefill conv adds the four taps
    in bf16, its decode conv sums them in one einsum. With the decode
    conv taken in the prefill's order, nothing else in the cache path
    rounds differently (the chunked scan and the recurrence agree far
    below a bf16 step), and the gap closes."""
    gap = _bf16_cache_gap(arch)
    assert gap > 2e-3
    monkeypatch.setattr(tm, "_conv_step", lambda window, w, bias: tm._conv1d(window, w, bias)[:, -1])
    assert _bf16_cache_gap(arch) <= 0.1 * gap


def _torch_to_jax(model):
    """The port's state dict as the JAX param tree (nested dicts)."""
    tree = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(t.numpy())
    return tree


def _jax_greedy(jmodel, jparams, prompt, gen):
    """The loop of repro.launch.serve.run_serving on given params."""
    b, s = prompt.shape
    cache = jmodel.init_cache(JaxShapeConfig("serve", s + gen, b, "decode"))
    logits, pc = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(prompt)})
    cache = {k: (pc[k] if pc[k].shape == v.shape else v.at[:, :, :s].set(pc[k].astype(v.dtype)))
             for k, v in cache.items()}
    step = jax.jit(jmodel.serve_step)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = step(jparams, cache, {"tokens": tok}, jnp.int32(s + i))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_greedy_tokens_match_jax(arch):
    """run_serving on the CPU (weights from its seed, prompt from numpy)
    against the JAX serving loop on the same weights and prompt: the same
    greedy tokens, and no kernel launched."""
    batch, prompt_len, gen, seed = 3, 10, 9, 1
    before = dict(LAUNCHES)
    out = serve.run_serving(arch, batch=batch, prompt_len=prompt_len, gen=gen, smoke=True,
                            seed=seed, device="cpu")
    assert LAUNCHES == before
    assert out["tokens"].shape == (batch, gen) and out["logits_finite"]
    model = make_model(get_config(arch).reduced(), device="cpu")
    model.init_params(torch.Generator().manual_seed(seed))
    prompt = np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (batch, prompt_len)).astype(np.int32)
    jmodel = jax_make_model(jax_get_config(arch).reduced())
    want = _jax_greedy(jmodel, _torch_to_jax(model), prompt, gen)
    np.testing.assert_array_equal(out["tokens"], want)


def test_splice_cache_by_family():
    """KV buffers take the prefill on their sequence axis, SSM states whole."""
    cache = {"ssm": torch.zeros(2, 3, 4), "shared_k": torch.zeros(2, 3, 10, 2, 4,
                                                                   dtype=torch.bfloat16)}
    pc = {"ssm": torch.ones(2, 3, 4), "shared_k": torch.full((2, 3, 6, 2, 4), 2.0)}
    serve.splice_cache(cache, pc)
    assert cache["ssm"].eq(1).all()
    assert cache["shared_k"][:, :, :6].eq(2).all() and not cache["shared_k"][:, :, 6:].any()
    assert cache["shared_k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ARCHS)
def test_compute_params_cast_what_jax_casts(arch):
    """In bf16: Mamba's in_proj, conv_w, conv_b, out_proj and the shared
    block's w* matrices in bf16; A_log, D, dt_bias, the norms and the
    embedding/LM head fp32."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = make_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    params = model.compute_params()
    blocks = params["blocks"]
    for k in ("in_proj", "conv_w", "conv_b", "out_proj"):
        assert blocks[k].dtype == torch.bfloat16
        assert torch.equal(blocks[k], model.blocks[k].to(torch.bfloat16))
    for k in ("A_log", "D", "dt_bias", "norm", "out_norm"):
        assert blocks[k] is model.blocks[k] and blocks[k].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in params["embed"].values())
    if cfg.family == "hybrid":
        for part in ("attn", "mlp"):
            for k, v in params["shared"][part].items():
                assert v.dtype == (torch.bfloat16 if k.startswith("w") else torch.float32), k
    assert model.compute_params() is params
