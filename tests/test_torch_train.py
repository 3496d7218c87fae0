"""The port's training path against ``repro`` at the reduced llama3.2-3b
config (fp32), on JAX's weights copied through ``params_from_jax`` and the
same numpy batches: the loss and every gradient leaf, train steps with
AdamW and Adafactor, the optimizer on identical gradients, checkpoints
across the two packages, and the elastic loop of ``run_training``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models.model import make_model as jax_make_model
from repro.models.transformer import loss_fn as jax_loss_fn
from repro.optim.adamw import OptConfig as JaxOptConfig
from repro.optim.adamw import apply_updates as jax_apply_updates
from repro.optim.adamw import init_opt_state as jax_init_opt_state
from repro.runtime.checkpoint import CheckpointManager as JaxCheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models.model import make_model
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.runtime.checkpoint import CheckpointManager

ARCH = "llama3.2-3b"
LOSS_RTOL = 1e-5          # of the loss
GRAD_TOL = 1e-4           # of each leaf's largest |grad|
PARAM_TOL = 1e-2          # of the farthest the train steps can move a parameter


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(p.key for p in path): np.asarray(v) for path, v in flat}


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_get_config(ARCH).reduced()
    return jax_make_model(jcfg).init_params(jax.random.key(0))


def _batch(b=4, s=16, seed=1):
    toks = np.random.default_rng(seed).integers(0, 256, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _pair(jax_params, opt=None, arch=ARCH, **patch):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **patch)
    jopt = None if opt is None else JaxOptConfig(**opt)
    jmodel = jax_make_model(jcfg, opt=jopt)
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    model = make_model(cfg, device="cpu", opt=None if opt is None else OptConfig(**opt))
    model.load_params(params_from_jax(jax.device_get(jax_params)))
    return jmodel, model


def _check_grads(grads, jgrads):
    assert list(grads) == list(jgrads)
    for name, want in jgrads.items():
        got = grads[name].float().numpy()
        assert got.shape == want.shape, name
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("patch", [
    {}, {"remat": True}, {"onehot_ce": True}, {"cast_params_once": True},
    {"bf16_grads": True}, {"seq_sharded_loss": True},
], ids=lambda p: "-".join(p) or "base")
def test_loss_and_grads_match_jax(jax_params, patch):
    jmodel, model = _pair(jax_params, **patch)
    batch = _batch()
    jloss, jgrads = jax.jit(jmodel._value_and_grad)(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = model.value_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _check_grads(grads, _flat(jgrads))


@pytest.mark.parametrize("arch,patch", [
    ("mamba2-2.7b", {}), ("mamba2-2.7b", {"remat": True}), ("zamba2-2.7b", {"remat": True}),
])
def test_ssm_and_hybrid_loss_and_grads_match_jax(arch, patch):
    """The SSM and hybrid backbones train on the CPU through the plain
    versions (on a card they wait for the ssd_chunk backward)."""
    jparams = jax_make_model(jax_get_config(arch).reduced()).init_params(jax.random.key(1))
    jmodel, model = _pair(jparams, arch=arch, **patch)
    batch = _batch()
    jloss, jgrads = jax.jit(jmodel._value_and_grad)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = model.value_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _check_grads(grads, _flat(jgrads))


def test_grad_accum_matches_jax_microbatches(jax_params):
    """``grad_accum=2``: the mean of the microbatches' fp32 gradients,
    as JAX's ``train_step`` scans them."""
    jmodel, model = _pair(jax_params, grad_accum=2)
    batch = _batch()
    half = {k: v.reshape(2, 2, -1) for k, v in batch.items()}
    vg = jax.jit(jmodel._value_and_grad)
    parts = [vg(jax_params, {k: jnp.asarray(v[i]) for k, v in half.items()}) for i in range(2)]
    jloss = np.mean([float(l) for l, _ in parts])
    jgrads = {n: (g0 + g1) / 2 for (n, g0), g1 in
              zip(_flat(parts[0][1]).items(), _flat(parts[1][1]).values())}
    loss, grads = model.value_and_grad(_torch_batch(batch))
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    _check_grads(grads, jgrads)


def test_eval_step_is_the_loss(jax_params):
    jmodel, model = _pair(jax_params)
    batch = _batch(seed=3)
    jloss = jax_loss_fn(jax_params, jmodel.cfg, jmodel.ctx,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(model.eval_step(_torch_batch(batch)).item(), float(jloss),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("kind,patch", [("adamw", {}), ("adafactor", {}),
                                        ("adamw", {"grad_accum": 2})],
                         ids=["adamw", "adafactor", "adamw-accum2"])
def test_three_train_steps_match_jax(jax_params, kind, patch):
    """Three steps on the same batches: the losses, then every parameter."""
    opt = dict(kind=kind, lr=1e-3, warmup=2, total_steps=10)
    jmodel, model = _pair(jax_params, opt=opt, **patch)
    jp, jstate = jax_params, jmodel.init_opt(jax_params)
    state = model.init_opt()
    step = jax.jit(jmodel.train_step)
    for i in range(3):
        batch = _batch(seed=10 + i)
        jp, jstate, jm = step(jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = model.train_step(state, _torch_batch(batch))
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=LOSS_RTOL)
    assert state.step == int(jstate.step) == 3
    # AdamW divides by sqrt(v), so an element whose gradient is near zero
    # moves by up to lr whatever its gradient's size, and the last-bit
    # differences of the two gradients reach its update there: held to 1%
    # of the farthest three steps can move an element (3 lr); Adafactor
    # the same
    got = model.masters()
    for name, want in _flat(jp).items():
        np.testing.assert_allclose(got[name].numpy(), want, rtol=0,
                                   atol=PARAM_TOL * 3 * opt["lr"], err_msg=name)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_apply_updates_matches_jax(kind):
    """Five updates on identical gradients, clipped by the global norm
    (one step's gradients exceed it), within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"b": (7,), "w": (5, 6), "blocks": {"k": (3, 4, 8)}}

    def tree(f):
        return {k: tree_of(v, f) for k, v in shapes.items()}

    def tree_of(v, f):
        return {k: tree_of(x, f) for k, x in v.items()} if isinstance(v, dict) else f(v)

    p0 = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    cfg = dict(kind=kind, lr=1e-2, warmup=2, total_steps=8, clip_norm=1.0)
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, p0), None
    jstate = jax_init_opt_state(jp, JaxOptConfig(**cfg))
    params = {n: torch.from_numpy(v.copy()) for n, v in _flat(p0).items()}
    state = init_opt_state(params, OptConfig(**cfg))
    for i in range(5):
        g = tree(lambda s: (rng.standard_normal(s) * (3.0 if i == 1 else 0.1))
                 .astype(np.float32))
        jp, jstate = jax_apply_updates(jp, jax.tree_util.tree_map(jnp.asarray, g), jstate,
                                       JaxOptConfig(**cfg))
        state = apply_updates(params, {n: torch.from_numpy(v.copy())
                                       for n, v in _flat(g).items()}, state, OptConfig(**cfg))
    for name, want in _flat(jp).items():
        np.testing.assert_allclose(params[name].numpy(), want, rtol=1e-6, atol=1e-6,
                                   err_msg=name)


def test_adamw_chunks_match_whole_leaves(monkeypatch):
    """AdamW updates a large leaf slice by slice: the same numbers as one
    pass over the whole leaf."""
    import repro_torch.optim.adamw as adamw
    rng = np.random.default_rng(1)
    p0 = {"w": rng.standard_normal((9, 5, 4)).astype(np.float32),
          "v": rng.standard_normal((37,)).astype(np.float32)}
    g0 = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
    out = []
    for chunk in (1 << 26, 20):
        monkeypatch.setattr(adamw, "CHUNK_ELEMENTS", chunk)
        params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        state = init_opt_state(params, OptConfig())
        for _ in range(2):
            state = apply_updates(params, {k: torch.from_numpy(v.copy()) for k, v in g0.items()},
                                  state, OptConfig())
        out.append(params)
    assert len(adamw._chunks(torch.zeros(9, 5, 4))) == 9
    for k in p0:
        torch.testing.assert_close(out[0][k], out[1][k], rtol=0, atol=0)


# ---------------------------------------------------------------------- #
# checkpoints across the two packages
# ---------------------------------------------------------------------- #
def _state_leaves(state):
    """The port's OptState in JAX's flatten order: step, mu's, nu's leaves
    (dicts in sorted key order, tensors as leaves)."""
    return [state.step] + jax.tree_util.tree_leaves(state.mu) \
        + jax.tree_util.tree_leaves(state.nu)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoint_jax_to_torch(tmp_path, jax_params, kind):
    opt = dict(kind=kind, warmup=2, total_steps=10)
    jmodel, model = _pair(jax_params, opt=opt)
    jp, jstate, _ = jax.jit(jmodel.train_step)(
        jax_params, jmodel.init_opt(jax_params),
        {k: jnp.asarray(v) for k, v in _batch().items()})
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
def test_checkpoint_torch_to_jax(tmp_path, jax_params, kind):
    opt = dict(kind=kind, warmup=2, total_steps=10)
    jmodel, model = _pair(jax_params, opt=opt)
    state, _ = model.train_step(model.init_opt(), _torch_batch(_batch()))
    CheckpointManager(str(tmp_path)).save(3, {"params": model.masters(), "opt_state": state})
    step, out = JaxCheckpointManager(str(tmp_path)).restore(
        like={"params": jax_params, "opt_state": jmodel.init_opt(jax_params)})
    assert step == 3 and int(out["opt_state"].step) == 1
    got = model.masters()
    for name, want in _flat(out["params"]).items():
        np.testing.assert_array_equal(want, got[name].numpy())
    want_state = jax.tree_util.tree_leaves(out["opt_state"])
    ours = _state_leaves(state)
    assert len(want_state) == len(ours)
    for want, mine in zip(want_state[1:], ours[1:]):
        np.testing.assert_array_equal(np.asarray(want), mine.numpy())


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"a.w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(4)}
    state = init_opt_state(params, OptConfig())
    for s in (1, 2, 3):
        mgr.save(s, {"params": params, "opt_state": state}, blocking=s != 3)
    step, out = mgr.restore(like={"params": params, "opt_state": state})
    assert step == 3 == mgr.latest_step()
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000002",
                                                              "step_00000003"]
    torch.testing.assert_close(out["params"]["a.w"], params["a.w"])
    with pytest.raises(ValueError):
        mgr.restore(like={"params": {"b": params["b"]}})
