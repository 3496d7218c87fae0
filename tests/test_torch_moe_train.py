"""The port's MoE training path against ``repro`` at the reduced
qwen3-moe-30b-a3b (every layer MoE, top-2 of 4 experts) and
llama4-maverick-400b-a17b (a dense and a MoE layer a group, top-1, a
shared expert, Adafactor) configs in fp32, on JAX's weights copied through
``params_from_jax`` and the same numpy batches: the loss and every gradient
leaf, train steps, checkpoints across the two packages, and the elastic
loop of ``run_training``.

At top-1 the renormalised gate is g / g = 1, so the router's gradient is
zero in exact arithmetic and each framework returns its own rounding
noise there. The tests hold that leaf for what it is (see
``test_top1_router_gradient_is_rounding_noise``)."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import perf_patch as jax_perf_patch
from repro.models.model import make_model as jax_make_model
from repro.optim.adamw import OptConfig as JaxOptConfig
from repro.parallel.sharding import Rules, ShardingCtx
from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.registry import perf_patch
from repro_torch.convert import params_from_jax
from repro_torch.launch.train import run_training
from repro_torch.models.model import make_model
from repro_torch.optim.adamw import OptConfig
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.checkpoint import CheckpointManager

QWEN3, LLAMA4 = "qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b"
ARCHS = (QWEN3, LLAMA4)
LOSS_RTOL = 1e-5          # of the loss
GRAD_TOL = 1e-4           # of each leaf's largest |grad|; a top-1 router: of the model's
PARAM_TOL = 1e-2          # of the farthest the train steps can move a parameter
NOISE = 1e-6              # a top-1 router's |grad| below this share of the model's largest
ROUTER = "blocks.moe.ffn.router"     # llama4's, the only top-1 router
PATCHES = [{}, {"remat": True}, {"cast_params_once": True}, {"moe_impl": "dense"}]
OPT = dict(lr=1e-3, warmup=2, total_steps=10)


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): np.asarray(v) for path, v in flat}


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax_make_model(jax_get_config(arch).reduced()).init_params(jax.random.key(0))


def _batch(b=4, s=16, seed=1):
    toks = np.random.default_rng(seed).integers(0, 256, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pair(arch, opt=None, **patch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **patch)
    jopt = None if opt is None else JaxOptConfig(**opt)
    jmodel = jax_make_model(jcfg, opt=jopt)
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    model = make_model(cfg, device="cpu", opt=None if opt is None else OptConfig(**opt))
    model.load_params(params_from_jax(jax.device_get(_jax_params(arch))))
    return jmodel, model


@functools.lru_cache(maxsize=None)
def _losses_and_grads(arch, patch_items):
    """(JAX's loss, its gradients; the port's) on one batch, as numpy."""
    jmodel, model = _pair(arch, **dict(patch_items))
    batch = _batch()
    jloss, jgrads = jax.jit(jmodel._value_and_grad)(_jax_params(arch), _jax_batch(batch))
    loss, grads = model.value_and_grad(_torch_batch(batch))
    return (float(jloss), _flat(jgrads), loss.item(),
            {n: g.float().numpy() for n, g in grads.items()})


def _top1_router(arch):
    return ROUTER if get_config(arch).reduced().top_k == 1 else None


def _patch_id(p):
    return "-".join(f"{k}={v}" if isinstance(v, str) else k for k, v in p.items()) or "base"


def _check_grads(arch, grads, jgrads):
    """Each leaf within ``GRAD_TOL`` of its own largest |grad|; a top-1
    router within ``GRAD_TOL`` of the model's largest."""
    assert list(grads) == list(jgrads)
    largest = max(np.abs(g).max() for g in jgrads.values())
    for name, want in jgrads.items():
        got = grads[name]
        assert got.shape == want.shape, name
        scale = largest if name == _top1_router(arch) else np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("patch", PATCHES, ids=_patch_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, patch):
    """The loss at ``LOSS_RTOL``; each leaf within ``GRAD_TOL`` of its own
    largest |grad|, except a top-1 router, whose gradient is rounding noise
    in both frameworks: that leaf within ``GRAD_TOL`` of the model's
    largest |grad| over all leaves."""
    jloss, jgrads, loss, grads = _losses_and_grads(arch, tuple(patch.items()))
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    _check_grads(arch, grads, jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_perf_bundle_loss_and_grads_match_jax(arch):
    """The §Perf bundle (``moe_impl="a2a"``: qwen3-moe at capacity factor
    1.0, llama4 with ``moe_ep2d``; bf16_grads, seq_sharded_loss,
    prefill_last_logits) against JAX's model under a one-device ("data",
    "model") mesh, as JAX's runtime binds it: the loss and every gradient
    leaf as ``test_loss_and_grads_match_jax`` holds them."""
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    jpatch = {k: v for k, v in jax_perf_patch(arch).items() if k != "ssm_chunk"}
    assert jpatch == perf_patch(arch) and jpatch["moe_impl"] == "a2a"
    jcfg = dataclasses.replace(jax_get_config(arch), **jpatch).reduced()
    jmodel = jax_make_model(jcfg, ShardingCtx(Rules(), mesh))
    model = make_model(dataclasses.replace(get_config(arch), **jpatch).reduced(), device="cpu")
    assert vars(model.cfg) == vars(jcfg)
    model.load_params(params_from_jax(jax.device_get(_jax_params(arch))))
    batch = _batch()
    jloss, jgrads = jax.jit(jmodel._value_and_grad)(_jax_params(arch), _jax_batch(batch))
    loss, grads = model.value_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _check_grads(arch, {n: g.float().numpy() for n, g in grads.items()}, _flat(jgrads))


@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_perf_bundle(arch):
    """``run_training(perf=True)`` runs the a2a path to three finite losses."""
    res = run_training(arch, steps=3, perf=True, device="cpu")
    assert res["runtime"].cfg.moe_impl == "a2a"
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert abs(res["losses"][0] - math.log(256)) < 1.0


@pytest.mark.parametrize("patch", PATCHES, ids=_patch_id)
def test_top1_router_gradient_is_rounding_noise(patch):
    """At top_k 1 the gate renormalised over the top-k is g / g = 1
    (``repro/models/moe.py:69``, ``repro_torch/models/moe.py``'s ``_route``):
    the output does not depend on the router's logits, and its gradient is
    zero in exact arithmetic. Both frameworks return rounding noise there,
    below ``NOISE`` of the model's largest |grad|, and the two noises are
    unrelated, so a per-leaf comparison of that leaf measures nothing."""
    assert _top1_router(LLAMA4) == ROUTER and _top1_router(QWEN3) is None
    _, jgrads, _, grads = _losses_and_grads(LLAMA4, tuple(patch.items()))
    largest = max(np.abs(g).max() for g in jgrads.values())
    for g in (jgrads[ROUTER], grads[ROUTER]):
        assert np.abs(g).max() < NOISE * largest


def _train(arch, kind, steps, patch=None):
    """``steps`` train steps of each framework on the same batches: (JAX's
    params, its losses; the port's model, its losses)."""
    opt = dict(kind=kind, **OPT)
    jmodel, model = _pair(arch, opt=opt, **(patch or {}))
    jp = _jax_params(arch)
    jstate, state = jmodel.init_opt(jp), model.init_opt()
    step = jax.jit(jmodel.train_step)
    jlosses, losses = [], []
    for i in range(steps):
        batch = _batch(seed=10 + i)
        jp, jstate, jm = step(jp, jstate, _jax_batch(batch))
        state, m = model.train_step(state, _torch_batch(batch))
        jlosses.append(float(jm["loss"]))
        losses.append(m["loss"].item())
    assert state.step == int(jstate.step) == steps
    return _flat(jp), jlosses, model, losses


def test_three_adamw_steps_match_jax():
    """qwen3-moe: three AdamW steps, the losses, then every parameter
    within 1% of the farthest three steps can move an element (3 lr), as
    tests/test_torch_train.py holds llama."""
    jp, jlosses, model, losses = _train(QWEN3, "adamw", 3)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    got = model.masters()
    for name, want in jp.items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=PARAM_TOL * 3 * OPT["lr"], err_msg=name)


def _adafactor_step_bound(p0, lr, weight_decay):
    """The largest change one Adafactor step can make to an element of the
    leaf ``p0``. The step is ``-lr (weight_decay p + u)``, and the RMS clip
    (``optim/adamw.py``: u / max(rms(u), 1)) leaves mean(u^2) <= 1 over the
    leaf's n elements, so no |u| exceeds sqrt(n), whatever the gradient."""
    return lr * (math.sqrt(p0.size) + weight_decay * np.abs(p0).max())


def test_one_adafactor_step_matches_jax():
    """llama4-maverick under its Adafactor, one step: the loss and every
    parameter but the top-1 router within 1% of 3 lr, as the AdamW steps.
    The router's gradient is each framework's own rounding noise, and
    Adafactor divides by the root of its factored second moment, so a
    step of lr's order lands in a direction that noise picks
    (``ROADMAP.md``, Known differences). Each framework's step on the
    router lies within the largest step Adafactor can take there
    (``_adafactor_step_bound``), and the two routers within the sum of
    their two steps of each other."""
    p0 = np.asarray(jax.device_get(_jax_params(LLAMA4))["blocks"]["moe"]["ffn"]["router"])
    jp, jlosses, model, losses = _train(LLAMA4, "adafactor", 1)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    got = model.masters()
    for name, want in jp.items():
        if name != ROUTER:
            np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                       atol=PARAM_TOL * 3 * OPT["lr"], err_msg=name)
    lr1 = warmup_cosine(torch.tensor(1.0), OPT["lr"], OPT["warmup"], OPT["total_steps"]).item()
    bound = _adafactor_step_bound(p0, lr1, OptConfig().weight_decay)
    jstep = np.abs(jp[ROUTER] - p0).max()
    step = np.abs(got[ROUTER].numpy() - p0).max()
    assert jstep <= bound and step <= bound, (jstep, step, bound)
    assert np.abs(got[ROUTER].numpy() - jp[ROUTER]).max() <= jstep + step


def test_adafactor_losses_part_after_the_first_step():
    """The router that the noise moved shows in the next step's loss: the
    second losses of the two frameworks differ by more than ``LOSS_RTOL``,
    where the first agree within it. If either framework stops turning the
    noise into a step, this fails and the known difference goes."""
    _, jlosses, _, losses = _train(LLAMA4, "adafactor", 2)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, jlosses)]
    assert rel[0] <= LOSS_RTOL < rel[1], rel


# ---------------------------------------------------------------------- #
# checkpoints across the two packages
# ---------------------------------------------------------------------- #
def _state_leaves(state):
    """The port's OptState in JAX's flatten order: step, mu's, nu's leaves."""
    return [state.step] + jax.tree_util.tree_leaves(state.mu) \
        + jax.tree_util.tree_leaves(state.nu)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_jax_to_torch(tmp_path, arch, kind):
    opt = dict(kind=kind, warmup=2, total_steps=10)
    jmodel, model = _pair(arch, opt=opt)
    jparams = _jax_params(arch)
    jp, jstate, _ = jax.jit(jmodel.train_step)(jparams, jmodel.init_opt(jparams),
                                               _jax_batch(_batch()))
    JaxCheckpointManager(str(tmp_path)).save(7, {"params": jp, "opt_state": jstate})
    step, out = CheckpointManager(str(tmp_path)).restore(
        like={"params": model.masters(), "opt_state": model.init_opt()})
    assert step == 7 and out["opt_state"].step == 1
    for name, want in _flat(jp).items():
        np.testing.assert_array_equal(out["params"][name].numpy(), want)
    want_state = jax.tree_util.tree_leaves(jstate)
    got_state = _state_leaves(out["opt_state"])
    assert len(got_state) == len(want_state)
    for got, want in zip(got_state[1:], want_state[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_torch_to_jax(tmp_path, arch, kind):
    opt = dict(kind=kind, warmup=2, total_steps=10)
    jmodel, model = _pair(arch, opt=opt)
    state, _ = model.train_step(model.init_opt(), _torch_batch(_batch()))
    CheckpointManager(str(tmp_path)).save(3, {"params": model.masters(), "opt_state": state})
    jparams = _jax_params(arch)
    step, out = JaxCheckpointManager(str(tmp_path)).restore(
        like={"params": jparams, "opt_state": jmodel.init_opt(jparams)})
    assert step == 3 and int(out["opt_state"].step) == 1
    got = model.masters()
    for name, want in _flat(out["params"]).items():
        np.testing.assert_array_equal(want, got[name].numpy())
    want_state = jax.tree_util.tree_leaves(out["opt_state"])
    ours = _state_leaves(state)
    assert len(want_state) == len(ours)
    for want, mine in zip(want_state[1:], ours[1:]):
        np.testing.assert_array_equal(np.asarray(want), mine.numpy())


# ---------------------------------------------------------------------- #
# the elastic loop
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_run_training_grow_shrink_fail(arch):
    """``run_training`` on the CPU through a MATCHALLOCATE, a grow, a
    shrink and a node failure with replacement, under each MoE config's
    own optimizer (AdamW for qwen3-moe, Adafactor for llama4)."""
    res = run_training(arch, steps=6, grow_at=2, shrink_at=3, fail_at=4, device="cpu")
    kinds = [e.kind for e in res["events"]]
    assert kinds == ["rebind", "grow", "rebind", "shrink", "rebind", "eject", "rebind"]
    assert len(res["losses"]) == 6 and np.isfinite(res["losses"]).all()
    assert abs(res["losses"][0] - math.log(256)) < 1.0
    assert res["runtime"].model.opt.kind == get_config(arch).optimizer


def test_run_training_cuts_depth():
    """``n_layers`` cuts the depth of the config that runs and names the cut."""
    res = run_training(QWEN3, steps=2, n_layers=1, device="cpu")
    rt = res["runtime"]
    assert res["reduced"] == {"n_layers": "1 of 2"} and rt.cfg.n_layers == 1
    assert rt.params["blocks.ffn.router"].shape[0] == 1
    assert np.isfinite(res["losses"]).all()
    assert run_training(QWEN3, steps=1, device="cpu")["reduced"] is None


@pytest.mark.parametrize("arch,n_layers", [(QWEN3, 3), (QWEN3, 0), (LLAMA4, 1)],
                         ids=["deeper", "none", "half-a-group"])
def test_run_training_refuses_a_bad_cut(arch, n_layers):
    """More layers than the config has, none, or a part of an interleaved
    group (llama4's dense layer without its MoE layer) raise before any
    allocation."""
    with pytest.raises(ValueError, match="cannot cut"):
        run_training(arch, steps=1, n_layers=n_layers, device="cpu")
