"""The port's vlm (qwen2-vl-72b: M-RoPE, vision stub) and audio
(musicgen-medium: absolute sinusoid plus RoPE, audio stub) families against
``repro`` at their reduced configs (fp32), on JAX's weights copied through
``params_from_jax`` and the same numpy embeddings: M-RoPE under three
distinct position streams, the sinusoid, prefill, the cached decode step,
decode against forward, one training step's loss and gradients, and the
serving and training entry points on the CPU.

Tolerances are those of tests/test_torch_model.py and test_torch_train.py:
1e-4 for fp32 logits and caches, 2e-2 for bf16 cache entries, 2e-3 for
decode against forward, 1e-5 of the loss and 1e-4 of each gradient leaf's
largest |value|."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
from repro.configs.registry import get_config as jax_get_config
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.model import make_model as jax_make_model
from repro.optim.adamw import OptConfig as JaxOptConfig
from repro.parallel.sharding import ShardingCtx
import repro_torch.launch.serve as serve
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import run_training
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import make_model
from repro_torch.optim.adamw import OptConfig

ARCHS = ["qwen2-vl-72b", "musicgen-medium"]
CTX = ShardingCtx()
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): np.asarray(v) for path, v in flat}


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


def _embeds(b, s, e, seed):
    return np.random.default_rng(seed).standard_normal((b, s, e)).astype(np.float32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    jmodel = jax_make_model(jax_get_config(request.param).reduced())
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(get_config(request.param).reduced(), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


# ---------------------------------------------------------------------- #
# layers: M-RoPE and the sinusoid
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("d", [16, 20, 128])     # sections (4, 2, 2), (5, 2, 3), (32, 16, 16)
def test_mrope_sections_match_jax(d):
    assert tl.mrope_sections_for(d) == jl.mrope_sections_for(d)
    assert sum(tl.mrope_sections_for(d)) == d // 2


@pytest.mark.parametrize("d", [16, 20, 128])
def test_apply_mrope_three_distinct_streams(d):
    """Temporal, height and width streams that differ from each other, so
    a wrong section split or a stream read in the wrong place shows (with
    text positions all three are equal and M-RoPE is plain RoPE)."""
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 7, 3, d)).astype(np.float32)
    pos = np.stack([np.arange(7)[None, :] + np.array([[0], [40]]),
                    rng.integers(0, 32, (2, 7)),
                    rng.integers(0, 500, (2, 7))]).astype(np.int32)     # [3, b, s]
    secs = jl.mrope_sections_for(d)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, secs)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, secs)
    _close(got, want, 1e-5)
    # the streams matter: the same x under text positions (t = h = w) differs
    text = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[[0, 0, 0]].copy()), 1e6, secs)
    assert (text - got).abs().max() > 1e-2


def test_mrope_text_positions_are_plain_rope():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 5, 2, 16)).astype(np.float32))
    pos = torch.arange(5, dtype=torch.int32)[None].expand(2, 5) + 3
    torch.testing.assert_close(
        tl.apply_rope(x, pos[None].expand(3, 2, 5), 1e4, tl.mrope_sections_for(16)),
        tl.apply_rope(x, pos, 1e4), rtol=0, atol=0)


@pytest.mark.parametrize("e", [64, 1536])
def test_sinusoid_matches_jax(e):
    pos = (np.arange(600)[None, :] + np.array([[0], [3]])).astype(np.int32)
    want = jt._sinusoid(jnp.asarray(pos), e, jnp.float32)
    got = tt._sinusoid(torch.from_numpy(pos), e, torch.float32)
    assert got.shape == (2, 600, e)
    _close(got, want, 1e-6)


def test_attention_decode_reads_the_temporal_stream():
    """Decode under M-RoPE with [3, b, 1] positions: rows attend the cache
    up to their temporal position (positions[0]), as in JAX; the height and
    width streams only rotate."""
    jcfg = jax_get_config("qwen2-vl-72b").reduced()
    cfg = get_config("qwen2-vl-72b").reduced()
    rng = np.random.default_rng(3)
    p = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
         for k, s in tl.attn_specs(cfg).items()}
    b, S = 2, 24
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((b, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    cv = rng.standard_normal((b, S, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    positions = np.array([[[9], [9]], [[2], [20]], [[17], [5]]], np.int32)   # [3, b, 1]
    jo, _ = jl.attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                         CTX, jnp.asarray(positions),
                         cache={"k": jnp.asarray(ck, jnp.bfloat16),
                                "v": jnp.asarray(cv, jnp.bfloat16)}, cache_index=9)
    to, _ = tl.attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                         cfg, torch.from_numpy(positions),
                         cache={"k": torch.from_numpy(ck).bfloat16(),
                                "v": torch.from_numpy(cv).bfloat16()}, cache_index=9)
    _close(to, jo, 1e-5)


# ---------------------------------------------------------------------- #
# the model on embeddings
# ---------------------------------------------------------------------- #
def test_params_from_jax_round_trip(pair):
    _, jparams, model = pair
    want = _flat(jparams)
    assert list(want) == list(model.param_specs())
    state = model.state_dict()
    for name, w in want.items():
        np.testing.assert_array_equal(state[name].numpy(), w)


def test_forward_matches_jax(pair):
    jmodel, jparams, model = pair
    emb = _embeds(2, 16, model.cfg.d_model, seed=4)
    jlog, _ = jt.forward(jparams, jmodel.cfg, jmodel.ctx, embeds=jnp.asarray(emb))
    _close(model.forward_logits(embeds=torch.from_numpy(emb)), jlog, 1e-4)


def test_prefill_matches_jax(pair):
    jmodel, jparams, model = pair
    emb = _embeds(2, 16, model.cfg.d_model, seed=5)
    jlog, jcache = jax.jit(jmodel.prefill_step)(jparams, {"embeds": jnp.asarray(emb)})
    log, cache = model.prefill_step(embeds=torch.from_numpy(emb))
    assert log.shape == (2, 1, model.cfg.vocab)
    _close(log, jlog, 1e-4)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        _close(cache[name], jcache[name], 1e-4)


def test_serve_step_matches_jax(pair):
    """Prefill spliced into bf16 max_len buffers, then one decode step on
    the next embedding."""
    jmodel, jparams, model = pair
    b, s, S = 2, 12, 20
    emb = _embeds(b, s + 1, model.cfg.d_model, seed=6)
    _, jpc = jax.jit(jmodel.prefill_step)(jparams, {"embeds": jnp.asarray(emb[:, :s])})
    jcache = {k: jnp.zeros_like(v).at[:, :, :s].set(jpc[k].astype(v.dtype))
              for k, v in jmodel.init_cache(JaxShapeConfig("serve", S, b, "decode")).items()}
    jlog, jnew = jax.jit(jmodel.serve_step)(jparams, jcache,
                                            {"embeds": jnp.asarray(emb[:, s:])}, jnp.int32(s))
    _, pc = model.prefill_step(embeds=torch.from_numpy(emb[:, :s]))
    cache = model.init_cache(ShapeConfig("serve", S, b, "decode"))
    serve.splice_cache(cache, pc)
    log, new = model.serve_step(cache, None, s, embeds=torch.from_numpy(emb[:, s:]))
    assert new["k"] is cache["k"] and new["k"].dtype == torch.bfloat16
    _close(log, jlog, 1e-4)
    for k in ("k", "v"):
        _close(new[k], jnew[k].astype(jnp.float32), 2e-2)     # bf16 entries


def test_decode_consistent_with_forward(pair):
    """prefill(s embeddings) + decode(embedding s) equals a full forward over
    s+1 embeddings at the last position (fp32 cache grown by one slot)."""
    _, _, model = pair
    s = 16
    emb = torch.from_numpy(_embeds(2, s + 1, model.cfg.d_model, seed=7))
    full = model.forward_logits(embeds=emb)
    _, cache = model.prefill_step(embeds=emb[:, :s])
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1)) for k, v in cache.items()}
    log, _ = model.serve_step(cache, None, s, embeds=emb[:, s:])
    np.testing.assert_allclose(log[:, 0].numpy(), full[:, -1].numpy(), atol=2e-3, rtol=2e-3)


def test_abs_sin_also_takes_rope():
    """musicgen's abs_sin adds the sinusoid to its inputs and, as JAX does
    for every rope but "none", rotates q and k too: with the rotation taken
    out the logits move."""
    cfg = get_config("musicgen-medium").reduced()
    model = make_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    emb = torch.from_numpy(_embeds(1, 12, cfg.d_model, seed=8))
    both = model.forward_logits(embeds=emb)
    model.cfg = dataclasses.replace(cfg, rope="none")
    neither = model.forward_logits(embeds=emb)
    assert (both - neither).abs().max() > 1e-3


# ---------------------------------------------------------------------- #
# training on embeddings
# ---------------------------------------------------------------------- #
def _batch(e, b=4, s=16, seed=1):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.standard_normal((b, s, e)).astype(np.float32),
            "labels": rng.integers(0, 256, (b, s)).astype(np.int32)}


def _torch_batch(batch):
    return {"embeds": torch.from_numpy(batch["embeds"]),
            "labels": torch.from_numpy(batch["labels"]).long()}


@pytest.mark.parametrize("remat", [False, True], ids=["base", "remat"])
def test_loss_and_grads_match_jax(pair, remat):
    jmodel, jparams, model = pair
    jmodel = jax_make_model(dataclasses.replace(jmodel.cfg, remat=remat))
    model.cfg = dataclasses.replace(model.cfg, remat=remat)
    batch = _batch(model.cfg.d_model)
    try:
        jloss, jgrads = jax.jit(jmodel._value_and_grad)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        loss, grads = model.value_and_grad(_torch_batch(batch))
    finally:
        model.cfg = dataclasses.replace(model.cfg, remat=False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    jgrads = _flat(jgrads)
    assert list(grads) == list(jgrads)
    for name, want in jgrads.items():
        got = grads[name].numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    """Three AdamW steps from JAX's weights on the same embeddings batches:
    the losses, then every parameter, held as tests/test_torch_train.py
    holds them (1% of the farthest three steps can move an element, 3 lr:
    AdamW moves an element whose gradient is near zero by up to lr, so the
    last-bit differences of the two gradients reach its update there)."""
    opt = dict(kind="adamw", lr=1e-3, warmup=2, total_steps=10)
    jmodel = jax_make_model(jax_get_config(arch).reduced(), opt=JaxOptConfig(**opt))
    jp = jmodel.init_params(jax.random.key(2))
    model = make_model(get_config(arch).reduced(), device="cpu", opt=OptConfig(**opt))
    model.load_params(params_from_jax(jax.device_get(jp)))
    jstate, state = jmodel.init_opt(jp), model.init_opt()
    step = jax.jit(jmodel.train_step)
    for i in range(3):
        batch = _batch(model.cfg.d_model, seed=10 + i)
        jp, jstate, jm = step(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = model.train_step(state, _torch_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    masters = model.masters()
    for name, want in _flat(jp).items():
        np.testing.assert_allclose(masters[name].numpy(), want, rtol=0,
                                   atol=1e-2 * 3 * opt["lr"], err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_on_embeddings(arch):
    """``run_training`` on the CPU: the pipeline's fp32 embeddings reach
    ``train_step`` through ``ElasticRuntime.step`` (labels as int64),
    through a MATCHALLOCATE, a grow, a shrink and a node failure."""
    res = run_training(arch, steps=5, grow_at=1, shrink_at=2, fail_at=3, device="cpu")
    kinds = [e.kind for e in res["events"]]
    assert kinds == ["rebind", "grow", "rebind", "shrink", "rebind", "eject", "rebind"]
    assert len(res["losses"]) == 5 and np.isfinite(res["losses"]).all()
    assert abs(res["losses"][0] - math.log(256)) < 1.0


# ---------------------------------------------------------------------- #
# serving
# ---------------------------------------------------------------------- #
_DEFAULT_RNG = np.random.default_rng


class _Recording:
    """A numpy Generator that records what ``standard_normal`` returns."""

    def __init__(self, seed):
        self.rng, self.draws = _DEFAULT_RNG(seed), []

    def standard_normal(self, shape):
        out = self.rng.standard_normal(shape)
        self.draws.append(out)
        return out


def _record_draws(monkeypatch, module):
    rec = []

    def default_rng(seed):
        rec.append(_Recording(seed))
        return rec[-1]
    monkeypatch.setattr(module.np.random, "default_rng", default_rng)
    return rec


@pytest.mark.parametrize("arch", ARCHS)
def test_run_serving_draws_jax_embeddings(arch, monkeypatch):
    """``run_serving(device="cpu")`` on the reduced config feeds the model
    the embeddings JAX's ``run_serving`` draws: the prompt, then one draw a
    decode step, from ``default_rng(seed)`` in the same order."""
    b, s, gen, seed = 2, 8, 5, 3
    rec = _record_draws(monkeypatch, jax_serve)
    jax_serve.run_serving(arch, batch=b, prompt_len=s, gen=gen, seed=seed)
    want = rec[-1].draws
    monkeypatch.undo()
    fed = []
    orig_prefill, orig_serve = tt.forward, tt.decode_step

    def forward(*a, embeds=None, **kw):
        fed.append(embeds.clone())
        return orig_prefill(*a, embeds=embeds, **kw)

    def decode_step(*a, embeds=None, **kw):
        fed.append(embeds.clone())
        return orig_serve(*a, embeds=embeds, **kw)
    from repro_torch.models import model as model_mod
    monkeypatch.setattr(model_mod, "forward", forward)
    monkeypatch.setattr(model_mod, "decode_step", decode_step)
    out = serve.run_serving(arch, batch=b, prompt_len=s, gen=gen, seed=seed, device="cpu")
    assert out["tokens"].shape == (b, gen) and out["logits_finite"]
    assert [tuple(w.shape) for w in want] == \
        [(b, s, get_config(arch).reduced().d_model)] + [(b, 1, 64)] * (gen - 1)
    assert len(fed) == len(want)
    for got, w in zip(fed, want):
        np.testing.assert_array_equal(got.numpy(), w.astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_model_tokens_match_jax_run_serving(arch):
    """On the weights JAX's ``run_serving`` draws (``init_params(key(seed))``
    at the reduced config), the port's serving loop gives JAX's tokens."""
    b, s, gen, seed = 2, 8, 6, 1
    want = jax_serve.run_serving(arch, batch=b, prompt_len=s, gen=gen, seed=seed)["tokens"]
    jparams = jax_make_model(jax_get_config(arch).reduced()).init_params(jax.random.key(seed))
    model = make_model(get_config(arch).reduced(), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    got = serve.serve_model(model, b, s, gen, seed=seed)["tokens"]
    np.testing.assert_array_equal(got, want)
