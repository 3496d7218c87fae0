"""The port's serving path (``repro_torch.launch.serve``) on the CPU, and
its greedy tokens against the JAX package's on the same weights."""
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
from repro_torch.launch import serve
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import make_model

ARCH = "llama3.2-3b"


def _jax_greedy(jmodel, jparams, prompt, gen):
    """The loop of repro.launch.serve.run_serving on given params."""
    b, s = prompt.shape
    cache = jmodel.init_cache(JaxShapeConfig("serve", s + gen, b, "decode"))
    logits, pc = jax.jit(jmodel.prefill_step)(jparams, {"tokens": jnp.asarray(prompt)})
    cache = {k: v.at[:, :, :s].set(pc[k].astype(v.dtype)) for k, v in cache.items()}
    step = jax.jit(jmodel.serve_step)
    tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
    out = [np.asarray(tok)]
    for i in range(gen - 1):
        logits, cache = step(jparams, cache, {"tokens": tok}, jnp.int32(s + i))
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(tok))
    return np.concatenate(out, axis=1)


def _torch_greedy(model, prompt, gen):
    """The loop of repro_torch.launch.serve.run_serving on given params."""
    b, s = prompt.shape
    cache = model.init_cache(ShapeConfig("serve", s + gen, b, "decode"))
    logits, pc = model.prefill_step(torch.from_numpy(prompt).long())
    for k, buf in cache.items():
        buf[:, :, :s].copy_(pc[k])
    tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
    out = [tok]
    for i in range(gen - 1):
        logits, cache = model.serve_step(cache, tok, s + i)
        tok = logits[:, -1, :].argmax(dim=-1, keepdim=True)
        out.append(tok)
    return torch.cat(out, dim=1).numpy()


def test_greedy_tokens_match_jax():
    """Prefill plus 8 greedy decode steps through both models on the same
    copied weights and numpy prompt: the tokens are identical."""
    jmodel = jax_make_model(jax_get_config(ARCH).reduced())
    jparams = jmodel.init_params(jax.random.key(0))
    model = make_model(get_config(ARCH).reduced(), device="cpu")
    model.load_params(params_from_jax(jax.device_get(jparams)))
    prompt = np.random.default_rng(0).integers(0, 256, (3, 10)).astype(np.int32)
    want = _jax_greedy(jmodel, jparams, prompt, gen=9)
    got = _torch_greedy(model, prompt, gen=9)
    assert got.shape == (3, 9)
    np.testing.assert_array_equal(got, want)


def test_run_serving_smoke_cpu():
    out = serve.run_serving(ARCH, batch=2, prompt_len=8, gen=5, smoke=True, seed=1,
                            device="cpu")
    assert out["tokens"].shape == (2, 5)
    assert out["logits_finite"]
    assert ((out["tokens"] >= 0) & (out["tokens"] < 256)).all()
    again = serve.run_serving(ARCH, batch=2, prompt_len=8, gen=5, smoke=True, seed=1,
                              device="cpu")
    np.testing.assert_array_equal(again["tokens"], out["tokens"])


def test_run_serving_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run_serving(ARCH, batch=1, prompt_len=4, gen=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_model(get_config(ARCH).reduced())


def test_cli_smoke_flag_reaches_full_width():
    """--smoke is on by default and --no-smoke turns it off (the JAX CLI's
    store_true with default=True could never run full width)."""
    ap = serve._parser()
    assert ap.parse_args([]).smoke is True
    assert ap.parse_args(["--no-smoke"]).smoke is False
    assert ap.parse_args([]).device == "cuda"
