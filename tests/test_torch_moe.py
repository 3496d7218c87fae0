"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the same numpy inputs and JAX's weights, copied
through ``params_from_jax``: the router, the dense oracle, the capacity
dispatch (the same pairs kept, pair for pair, where the capacity drops
some), the capacity's rounding, the gradients, and ``moe_a2a`` against
JAX's under a one-device mesh (both stages' pairs and the gradients);
then the twins of tests/test_moe.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.config import ArchConfig as JaxArchConfig
from repro.models.layers import materialize_tree, rmsnorm as jrmsnorm
from repro.parallel.sharding import Rules, ShardingCtx
from repro_torch.convert import params_from_jax
from repro_torch.models import moe
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import rmsnorm

BASE = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=1,
            d_ff=64, vocab=64, n_experts=8, top_k=2, moe_d_ff=16, dtype="float32")
TOL = 2e-5          # fp32 on both sides: only the order of the sums differs


def _cfgs(**kw):
    return JaxArchConfig(**{**BASE, **kw}), ArchConfig(**{**BASE, **kw})


def _params(jcfg, seed=0):
    jp = materialize_tree(jmoe.moe_specs(jcfg), jax.random.key(seed))
    return jp, params_from_jax(jax.device_get(jp))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _jax_keep(ids, T, jcfg):
    """JAX's kept pairs, by the lines of ``repro.models.moe.moe_dispatch``
    that rank them (the reference exposes no plan of its own)."""
    E, k = jcfg.n_experts, jcfg.top_k
    C = max(int(T * k * jcfg.capacity_factor / E), 1)
    C = -(-C // 64) * 64 if T >= 4096 else C
    fid = ids.reshape(T * k)
    order = jnp.argsort(fid, stable=True)
    sorted_fid = fid[order]
    first = jnp.searchsorted(sorted_fid, sorted_fid, side="left")
    ranks_sorted = jnp.arange(T * k, dtype=jnp.int32) - first.astype(jnp.int32)
    rank = ranks_sorted[jnp.argsort(order, stable=True)]
    return np.asarray(rank < C), C


def _routes(jcfg, cfg, jp, p, x):
    """(JAX's gates, ids; the port's) for x [b, s, e] as the layer sees it."""
    T = x.shape[0] * x.shape[1]
    jxn = jrmsnorm(jnp.asarray(x), jp["norm"], jcfg.norm_eps).reshape(T, -1)
    xn = rmsnorm(torch.from_numpy(x), p["norm"], cfg.norm_eps).reshape(T, -1)
    jg, jids = jmoe._route(jxn, jp, jcfg)
    g, ids = moe._route(xn, p, cfg)
    return (np.asarray(jg), np.asarray(jids)), (g.numpy(), ids.numpy())


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_matches_jax(top_k):
    """Ids equal and gates within 1e-6 on inputs whose top-k probabilities
    are tie-free (checked: every gap above 1e-5)."""
    jcfg, cfg = _cfgs(top_k=top_k)
    jp, p = _params(jcfg)
    x = _x((4, 16, 32))
    (jg, jids), (g, ids) = _routes(jcfg, cfg, jp, p, x)
    logits = x.reshape(64, 32) @ np.asarray(jp["router"])
    top = -np.sort(-logits, axis=-1)[:, :top_k + 1]
    assert np.diff(top, axis=-1).min() < -1e-5
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(g, jg, atol=1e-6, rtol=0)
    np.testing.assert_allclose(g.sum(-1), 1.0, atol=1e-6)


@pytest.mark.parametrize("impl", ["dense", "dispatch"])
@pytest.mark.parametrize("top_k,shared,act", [(1, 0, "swiglu"), (2, 0, "swiglu"),
                                              (4, 1, "swiglu"), (2, 0, "relu2"),
                                              (2, 1, "gelu")])
def test_layer_matches_jax(impl, top_k, shared, act):
    """``moe_dense`` and ``moe_dispatch`` against JAX's at the default
    capacity (1.25: some pairs drop) in fp32; the gelu is the tanh form
    in both."""
    jcfg, cfg = _cfgs(top_k=top_k, moe_shared=shared, mlp_act=act)
    jp, p = _params(jcfg)
    x = _x((2, 16, 32))
    want = getattr(jmoe, f"moe_{impl}")(jnp.asarray(x), jp, jcfg, ShardingCtx())
    got = getattr(moe, f"moe_{impl}")(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape,kw", [
    ((2, 16, 32), dict(capacity_factor=0.1)),                            # C = 1 of 32 pairs/expert
    ((1, 8, 32), dict(n_experts=128, top_k=8, capacity_factor=1.25)),    # decode at batch 8: C = 1
    ((2, 12, 32), dict(n_experts=4, top_k=2, capacity_factor=0.5)),
])
def test_dispatch_keeps_jax_pairs(shape, kw):
    """Where the capacity drops pairs, the port keeps exactly JAX's, pair
    for pair (rank by a stable sort: token order within an expert), and
    its outputs agree."""
    jcfg, cfg = _cfgs(**kw)
    jp, p = _params(jcfg)
    x = _x(shape, seed=3)
    T = shape[0] * shape[1]
    (_, jids), (_, ids) = _routes(jcfg, cfg, jp, p, x)
    np.testing.assert_array_equal(ids, jids)
    jkeep, jC = _jax_keep(jnp.asarray(jids), T, jcfg)
    plan = moe.dispatch_plan(torch.from_numpy(ids), cfg)
    assert plan.capacity == jC
    assert 0 < (~jkeep).sum() < jkeep.size                  # some pairs drop, not all
    np.testing.assert_array_equal(plan.keep.numpy(), jkeep)
    E, C = cfg.n_experts, plan.capacity
    dest = plan.dest.numpy()
    assert (dest[~jkeep] == E * C).all()
    assert len(set(dest[jkeep].tolist())) == jkeep.sum()   # one row each
    want = jmoe.moe_dispatch(jnp.asarray(x), jp, jcfg, ShardingCtx())
    got = moe.moe_dispatch(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("T,factor,want", [(4095, 1.01, 1033), (4096, 1.01, 1088),
                                           (4096, 1.0, 1024), (8192, 0.3, 640), (8, 1.25, 2),
                                           (2, 0.1, 1)])
def test_capacity_rounds_from_4096_tokens(T, factor, want):
    """C = max(int(T k f / E), 1), rounded up to a multiple of 64 from
    T = 4096 on, as JAX's."""
    jcfg, cfg = _cfgs(capacity_factor=factor)
    ids = jnp.asarray(np.random.default_rng(4).integers(0, 8, (T, 2)).astype(np.int32))
    assert moe.capacity(T, cfg) == _jax_keep(ids, T, jcfg)[1] == want


def test_dispatch_matches_jax_at_4096_tokens():
    """The rounded capacity in use: T = 4096 at C 1088 against JAX's."""
    jcfg, cfg = _cfgs(d_model=16, capacity_factor=1.01)
    jp, p = _params(jcfg)
    x = _x((4, 1024, 16), seed=5)
    want = jmoe.moe_dispatch(jnp.asarray(x), jp, jcfg, ShardingCtx())
    got = moe.moe_dispatch(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kw", [dict(capacity_factor=4.0), dict(capacity_factor=0.5, moe_shared=1)])
def test_dispatch_grads_match_jax(kw):
    """Every parameter's and the input's gradient of sum(y^2) through
    ``moe_dispatch`` against ``jax.grad``, within 1e-5 of each gradient's
    largest |value| (with and without drops)."""
    jcfg, cfg = _cfgs(**kw)
    jp, p = _params(jcfg)
    x = _x((2, 8, 32), seed=6)

    def jloss(jp, x):
        return jnp.sum(jmoe.moe_dispatch(x, jp, jcfg, ShardingCtx()) ** 2)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    (moe.moe_dispatch(xt, leaves, cfg) ** 2).sum().backward()
    pairs = [(xt.grad, jgx)] + [(leaves[k].grad, jgp[k]) for k in sorted(leaves)]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _mesh_ctx():
    """JAX's runtime's mesh on one device: ("data", "model") of 1 x 1."""
    from jax.sharding import AxisType
    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    return ShardingCtx(Rules(), mesh)


A2A_CFGS = {"qwen3-reduced": lambda: dataclasses.replace(
                jax_get_config("qwen3-moe-30b-a3b").reduced(), dtype="float32"),
            "base": lambda: JaxArchConfig(**BASE)}


def _a2a_pair(name, **kw):
    jcfg = dataclasses.replace(A2A_CFGS[name](), moe_impl="a2a", **kw)
    return jcfg, ArchConfig(**vars(jcfg))


@pytest.mark.parametrize("factor", [1.0, 1.25, 0.5])
@pytest.mark.parametrize("name", list(A2A_CFGS))
def test_a2a_matches_jax(name, factor):
    """``moe(moe_impl="a2a")`` against JAX's ``moe_a2a`` under a one-device
    mesh (JAX's runtime binds one; without it JAX falls back to the
    dispatch): y within 2e-5 of the largest |y|, each parameter's and x's
    gradient of sum(y^2) within 1e-5 of its largest |value|. Where the
    capacities of the two paths differ (1.25, 0.5) y is also held more than
    0.1 of the largest |y| away from ``moe_dispatch``'s, so no fallback to
    the dispatch can pass."""
    jcfg, cfg = _a2a_pair(name, capacity_factor=factor)
    jp, p = _params(jcfg)
    x = np.array(jax.random.normal(jax.random.key(1), (2, 16, jcfg.d_model)))
    ctx = _mesh_ctx()
    want = np.asarray(jax.jit(lambda x, jp: jmoe.moe_a2a(x, jp, jcfg, ctx))(x, jp))
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y = moe.moe(xt, leaves, cfg)
    scale = np.abs(want).max()
    np.testing.assert_allclose(y.detach().numpy(), want, atol=2e-5 * scale, rtol=0)
    if factor != 1.0:
        disp = moe.moe_dispatch(torch.from_numpy(x), p, cfg).numpy()
        assert np.abs(y.detach().numpy() - disp).max() > 0.1 * scale

    def jloss(jp, x):
        return jnp.sum(jmoe.moe_a2a(x, jp, jcfg, ctx) ** 2)
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    (y ** 2).sum().backward()
    pairs = [(xt.grad, jgx)] + [(leaves[k].grad, jgp[k]) for k in sorted(leaves)]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(want).max() > 0 and np.isfinite(want).all()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)


def _jax_a2a_plan(ids, jcfg):
    """JAX's two stages of ranks, by the lines of ``local_moe`` at one
    shard (the reference exposes no plan of its own)."""
    T, k = ids.shape
    n_sh, e_loc = 1, jcfg.n_experts
    S_cap = max(int(T * k * jcfg.capacity_factor / n_sh), 8)
    fid = ids.reshape(T * k)
    dest = fid // e_loc
    order = jnp.argsort(dest, stable=True)
    sorted_dest = dest[order]
    first = jnp.searchsorted(sorted_dest, sorted_dest, side="left")
    ranks_sorted = jnp.arange(T * k, dtype=jnp.int32) - first.astype(jnp.int32)
    rank = ranks_sorted[jnp.argsort(order, stable=True)]
    keep = rank < S_cap
    slot = jnp.where(keep, dest * S_cap + rank, n_sh * S_cap)
    rid = jnp.full((n_sh * S_cap + 1,), -1, jnp.int32).at[slot].set(
        jnp.where(keep, fid % e_loc, -1), mode="drop")[:-1]
    N = n_sh * S_cap
    C2 = max(int(N * jcfg.capacity_factor / e_loc), 8)
    order2 = jnp.argsort(rid, stable=True)
    sid = rid[order2]
    first2 = jnp.searchsorted(sid, sid, side="left")
    rk2 = (jnp.arange(N, dtype=jnp.int32) - first2.astype(jnp.int32))[
        jnp.argsort(order2, stable=True)]
    ok2 = jnp.logical_and(rid >= 0, rk2 < C2)
    slot2 = jnp.where(ok2, rid * C2 + rk2, e_loc * C2)
    return {k_: np.asarray(v) for k_, v in dict(
        keep=keep, slot=slot, recv_eid=rid, recv_keep=ok2, recv_slot=slot2).items()}, S_cap, C2


@pytest.mark.parametrize("shape,kw", [
    ((2, 16, 32), dict(capacity_factor=0.5)),        # both stages drop
    ((2, 16, 32), dict(capacity_factor=0.1)),        # S_cap and C2 at their floor of 8
    ((1, 8, 32), dict(n_experts=128, top_k=8, capacity_factor=1.25)),
    ((4, 64, 32), dict(capacity_factor=1.0)),
])
def test_a2a_plan_keeps_jax_pairs(shape, kw):
    """``send_plan`` and ``recv_plan`` at one shard keep JAX's pairs at
    both stages, row for row: the send slots, the received expert ids (-1
    in empty rows), the expert slots, both capacities."""
    jcfg, cfg = _cfgs(**kw)
    jp, p = _params(jcfg)
    x = _x(shape, seed=3)
    (_, jids), (_, ids) = _routes(jcfg, cfg, jp, p, x)
    np.testing.assert_array_equal(ids, jids)
    want, S_cap, C2 = _jax_a2a_plan(jnp.asarray(jids), jcfg)   # eager: a few small ops
    sp = moe.send_plan(torch.from_numpy(ids), cfg, 1)
    rp = moe.recv_plan(sp.send_eid.reshape(-1), cfg, 1)
    assert (sp.send_capacity, rp.expert_capacity) == (S_cap, C2)
    got = dict(keep=sp.keep, slot=sp.slot, recv_eid=sp.send_eid.reshape(-1),
               recv_keep=rp.recv_keep, recv_slot=rp.recv_slot)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, err_msg=name)
    kept = sp.kept(rp).numpy()
    assert kept.sum() == want["recv_keep"].sum()
    if kw["capacity_factor"] < 1:
        assert 0 < kept.sum() < kept.size


# ---------------------------------------------------------------------- #
# twins of tests/test_moe.py, on the port alone (torch-drawn weights)
# ---------------------------------------------------------------------- #
def _torch_params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for name, spec in moe.moe_specs(cfg).items():
        params[name] = torch.empty(spec.shape)
        spec.materialize_(params[name], gen)
    return params


def _tx(shape, seed=1):
    return torch.from_numpy(_x(shape, seed))


@pytest.mark.parametrize("top_k,shared", [(1, 0), (2, 0), (4, 1)])
def test_dispatch_matches_dense_oracle(top_k, shared):
    """With capacity high enough that nothing drops, the scatter dispatch
    equals the all-experts dense oracle."""
    _, cfg = _cfgs(top_k=top_k, moe_shared=shared, capacity_factor=8.0)
    p = _torch_params(cfg)
    x = _tx((2, 16, cfg.d_model))
    np.testing.assert_allclose(moe.moe_dispatch(x, p, cfg).numpy(),
                               moe.moe_dense(x, p, cfg).numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("top_k,shared", [(1, 0), (2, 1), (4, 0)])
def test_a2a_matches_dense_oracle(top_k, shared):
    """With capacity high enough that neither stage drops, ``moe_a2a``
    equals the all-experts dense oracle; ``moe_ep2d`` changes nothing at
    one shard."""
    _, cfg = _cfgs(top_k=top_k, moe_shared=shared, capacity_factor=8.0, moe_impl="a2a")
    p = _torch_params(cfg)
    x = _tx((2, 16, cfg.d_model))
    want = moe.moe_dense(x, p, cfg).numpy()
    for ep2d in (False, True):
        got = moe.moe(x, p, dataclasses.replace(cfg, moe_ep2d=ep2d))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_a2a_drops_tokens_gracefully():
    """At tiny capacity both stages drop (S_cap 25 of 256 pairs, C2 8 of
    the 25 rows for each of 2 experts); the output is finite."""
    _, cfg = _cfgs(capacity_factor=0.1, n_experts=2, moe_impl="a2a")
    p = _torch_params(cfg)
    x = _tx((4, 32, cfg.d_model))
    y = moe.moe(x, p, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    sp = moe.send_plan(moe._route(x.reshape(128, -1), p, cfg)[1], cfg, 1)
    rid = sp.send_eid.reshape(-1)
    assert not sp.keep.all() and not moe.recv_plan(rid, cfg, 1).recv_keep[rid >= 0].all()


def test_capacity_drops_tokens_gracefully():
    """At tiny capacity the output is finite and of the input's shape."""
    _, cfg = _cfgs(capacity_factor=0.1)
    p = _torch_params(cfg)
    x = _tx((2, 16, cfg.d_model))
    y = moe.moe_dispatch(x, p, cfg)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert not moe.dispatch_plan(moe._route(x.reshape(32, -1), p, cfg)[1], cfg).keep.all()


def test_gates_renormalized():
    _, cfg = _cfgs(top_k=4)
    p = _torch_params(cfg)
    gates, ids = moe._route(_tx((8, cfg.d_model)), p, cfg)
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-5)
    for row in ids.numpy():
        assert len(set(row.tolist())) == cfg.top_k


def test_moe_grad_flows():
    _, cfg = _cfgs(capacity_factor=4.0)
    p = {k: v.requires_grad_() for k, v in _torch_params(cfg).items()}
    (moe.moe_dispatch(_tx((2, 8, cfg.d_model)), p, cfg) ** 2).sum().backward()
    total = sum(v.grad.abs().sum().item() for v in p.values())
    assert np.isfinite(total) and total > 0


def test_dispatch_in_bf16_matches_dense_oracle():
    """The serving dtype: bf16 activations over bf16 expert weights (the
    router and norm fp32, as the serving cast keeps them), nothing dropped:
    the dispatch within 2e-2 of the dense oracle's largest |value|, both
    routed from the same bf16 input in fp32."""
    _, cfg = _cfgs(dtype="bfloat16", capacity_factor=8.0, moe_shared=1)
    p = {k: v if k in ("router", "norm") else v.bfloat16()
         for k, v in _torch_params(cfg).items()}
    x = _tx((2, 16, cfg.d_model)).bfloat16()
    got, want = moe.moe_dispatch(x, p, cfg), moe.moe_dense(x, p, cfg)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= \
        2e-2 * want.float().abs().max().item()
