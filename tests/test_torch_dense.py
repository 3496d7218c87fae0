"""The three dense configs that had no JAX parity in the port's tests,
phi3-medium-14b, phi4-mini-3.8b and nemotron-4-15b, against
``repro.models.model`` on JAX's weights copied through ``params_from_jax``:
each at a narrow fp32 config that keeps its GQA group (nemotron 12 / 2
heads, group 6; phi3 8 / 2, group 4; phi4 6 / 2, group 3; head dim 16),
its MLP (nemotron's relu2, the phis' SwiGLU) and its untied head. The
prefill, one decode step over the bf16 cache, and the loss and every
gradient of one batch, at the tolerances of tests/test_torch_model.py
and tests/test_torch_train.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.config import ShapeConfig as JaxShapeConfig
from repro.models.model import make_model as jax_make_model
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import make_model

# arch: (n_heads, n_kv_heads) of the narrow config, the full config's group
NARROW = {"nemotron-4-15b": (12, 2), "phi3-medium-14b": (8, 2), "phi4-mini-3.8b": (6, 2)}
LOSS_RTOL = 1e-5          # of the loss
GRAD_TOL = 1e-4           # of each leaf's largest |grad|


def narrow(cfg, arch):
    h, kvh = NARROW[arch]
    return dataclasses.replace(cfg.reduced(), n_heads=h, n_kv_heads=kvh, head_dim=16)


@pytest.fixture(scope="module", params=list(NARROW))
def pair(request):
    arch = request.param
    jmodel = jax_make_model(narrow(jax_get_config(arch), arch))
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(narrow(get_config(arch), arch), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    return jmodel, jparams, model


def _tokens(b, s, vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(ours, ref, atol):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("arch", list(NARROW))
def test_narrow_config_keeps_the_arch(arch):
    """The narrow config keeps the full config's GQA group, MLP and head."""
    full, cfg = get_config(arch), narrow(get_config(arch), arch)
    assert cfg.n_heads // cfg.n_kv_heads == full.n_heads // full.n_kv_heads
    assert (cfg.mlp_act, cfg.tie_embeddings, cfg.dtype) == (full.mlp_act, full.tie_embeddings,
                                                            "float32")


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
    _, jpc = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(toks[:, :s])})
    jcache = {k: jnp.zeros_like(v).at[:, :, :s].set(jpc[k].astype(v.dtype))
              for k, v in jmodel.init_cache(JaxShapeConfig("serve", S, b, "decode")).items()}
    jlog, jnew = jax.jit(jmodel.serve_step)(jparams, jcache,
                                            {"tokens": jnp.asarray(toks[:, s:])},
                                            jnp.int32(s))
    _, pc = model.prefill_step(torch.from_numpy(toks[:, :s]).long())
    cache = model.init_cache(ShapeConfig("serve", S, b, "decode"))
    assert all(c.dtype == torch.bfloat16 for c in cache.values())
    for k in cache:
        cache[k][:, :, :s].copy_(pc[k])
    log, new = model.serve_step(cache, torch.from_numpy(toks[:, s:]).long(), s)
    _close(log, jlog, 1e-4)
    for k in ("k", "v"):
        _close(new[k], jnew[k].astype(jnp.float32), 2e-2)   # bf16 entries


def test_loss_and_grads_match_jax(pair):
    jmodel, jparams, model = pair
    toks = _tokens(4, 17, model.cfg.vocab, seed=3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jloss, jgrads = jax.jit(jmodel._value_and_grad)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = model.value_and_grad({k: torch.from_numpy(v).long() for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    jgrads = {".".join(p.key for p in path): np.asarray(v) for path, v in flat}
    assert list(grads) == list(jgrads)
    for name, want in jgrads.items():
        got = grads[name].float().numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)
