"""Serving on a bound rank, and a train step on a three-axis mesh, against JAX.

The port's ``Model.prefill_step`` and ``serve_step`` under a mesh of a
gloo world of 4 CPU processes (one ``run_world`` for the file) against
JAX's on a 4-device mesh of Auto axes (one ``run_jax_oracle``), on JAX's
weights, in fp32 at the reduced configs:

* reduced llama3.2-3b, mamba2-2.7b, zamba2-2.7b with ``sliding_window``
  16 under a 32-token prompt (so the window cuts during decode), and
  qwen3-moe-30b-a3b on the dispatch and on ``moe_a2a`` (whose decode falls
  back to the dispatch), on meshes ("data", "model") (2, 2) and (1, 4)
  and ("pod" 2, "data" 1, "model" 2), and at (2, 2) mamba2 with
  ``ssm_seq_sharded`` and llama with ``mlp_seq_sharded`` (whose decode
  runs the MLP whole): each rank's prefill cache block is
  JAX's device shard, and the last logits of prefill and of three decode
  steps (the prefill cache spliced into 72-position buffers, each rank
  its block) are JAX's, within ``LOGIT_TOL``, and so are the cache blocks
  after them;
* a train step of reduced llama3.2-3b on the ("pod", "data", "model")
  mesh: the loss, the global-batch-mean gradient and each rank's shards
  after the step within ``test_torch_zero3``'s step tolerances;
* ``ref_decode``'s contract (starts, empty rows, the logsumexp) against a
  direct masked softmax, and the windowed decode of the port's attention
  against JAX's ``layers.attention`` with a cache and a window.
"""
import dataclasses
import json
import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_dist_harness import run_jax_oracle, run_world

WORLD = 4
# CACHE 72: the decode positions 32-34 lie in a block that is not the last
# on every mesh (blocks of 36 and 18), so later ranks hold no position yet
# and attend nothing
SEQ, BATCH, CACHE, GEN = 32, 4, 72, 3
MOE = "qwen3-moe-30b-a3b"
# case: (arch, config patch)
CASES = {"llama3.2-3b": ("llama3.2-3b", {}), "mamba2-2.7b": ("mamba2-2.7b", {}),
         "zamba2-2.7b": ("zamba2-2.7b", {"sliding_window": 16}),
         "qwen3-moe-dispatch": (MOE, {"moe_impl": "dispatch", "capacity_factor": 1.0}),
         "qwen3-moe-a2a": (MOE, {"moe_impl": "a2a", "capacity_factor": 1.0}),
         "mamba2-seq-sharded": ("mamba2-2.7b", {"ssm_seq_sharded": True}),
         "llama3.2-3b-mlp-seq": ("llama3.2-3b", {"mlp_seq_sharded": True})}
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x4": ((1, 4), ("data", "model")),
          "pod2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# the flags' forms of a program, on the (2, 2) mesh alone
ONE_MESH = ("mamba2-seq-sharded", "llama3.2-3b-mlp-seq")
SERVE_CASES = [(c, m) for c in CASES for m in MESHES if c not in ONE_MESH or m == "2x2"]
TRAIN_MESH = "pod2x1x2"
# the one-device serving tests' tolerance (tests/test_torch_model.py): logits
# and the prefill cache at atol = rtol = 1e-4, fp32 on both sides
LOGIT_TOL = 1e-4
# the decode cache's bf16 entries, as tests/test_torch_model.py holds them
CACHE_TOL = 2e-2
# test_torch_zero3's step tolerances: the loss relative, the gradient of each
# leaf's largest |g|, the shards of their kind's largest |value|
LOSS_TOL, GRAD_TOL, SHARD_TOL = 1e-6, 1e-5, 1e-6


def _tag(case, mesh):
    return f"{case}|{mesh}"


ORACLE = f"""
import dataclasses
import json
import jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.config import ShapeConfig
from repro.models.model import make_model
from repro.models.transformer import loss_fn
from repro.optim.adamw import OptConfig
from repro.parallel.sharding import Rules, ShardingCtx

CASES, MESHES = {CASES!r}, {MESHES!r}
SEQ, BATCH, CACHE, GEN = {SEQ}, {BATCH}, {CACHE}, {GEN}


def flat(tree, prefix=""):
    out = {{}}
    for k in sorted(tree):
        v = tree[k]
        out.update(flat(v, prefix + k + ".") if isinstance(v, dict) else {{prefix + k: v}})
    return out


def mesh_of(name):
    shape, names = MESHES[name]
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:int(np.prod(shape))])


data = np.load(sys.argv[1])
for case, mname in {SERVE_CASES!r}:
    arch, patch = CASES[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **patch)
    mesh = mesh_of(mname)
    devices = list(mesh.devices.flat)
    model = make_model(cfg, ShardingCtx(Rules(), mesh))
    tag = case + "|" + mname
    toks = data[arch + "|tokens"]
    with mesh:
        params = jax.device_put(model.init_params(jax.random.key(0)), model.param_shardings())
        csh = model.cache_shardings()
        psh = model.input_shardings(ShapeConfig("p", SEQ, BATCH, "prefill"))
        dsh = model.input_shardings(ShapeConfig("d", CACHE, BATCH, "decode"))
        prefill = jax.jit(model.prefill_step, out_shardings=(None, csh))
        logits, pc = prefill(params, {{"tokens": jax.device_put(jnp.asarray(toks[:, :SEQ]),
                                                                psh["tokens"])}})
        save(**{{tag + "|logits|0": logits}})
        for k, v in pc.items():
            for s in v.addressable_shards:
                save(**{{tag + "|cache|" + k + "|" + str(devices.index(s.device)): s.data}})
        specs = model.cache_specs(ShapeConfig("d", CACHE, BATCH, "decode"))
        cache = {{}}
        for k, v in pc.items():
            buf = jnp.zeros(specs[k].shape, specs[k].dtype)
            cache[k] = buf.at[tuple(slice(0, n) for n in v.shape)].set(v.astype(buf.dtype))
        cache = jax.device_put(cache, csh)
        step = jax.jit(model.serve_step, out_shardings=(None, csh))
        for i in range(GEN):
            t = jax.device_put(jnp.asarray(toks[:, SEQ + i:SEQ + i + 1]), dsh["tokens"])
            logits, cache = step(params, cache, {{"tokens": t}}, jnp.int32(SEQ + i))
            save(**{{tag + "|logits|" + str(i + 1): logits}})
        for k, v in cache.items():
            for s in v.addressable_shards:
                save(**{{tag + "|dcache|" + k + "|" + str(devices.index(s.device)):
                         s.data.astype(jnp.float32)}})

# one train step of reduced llama on the three-axis mesh
cfg = get_config("llama3.2-3b").reduced()
opt = OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10)
mesh = mesh_of({TRAIN_MESH!r})
devices = list(mesh.devices.flat)
model = make_model(cfg, ShardingCtx(Rules(), mesh), opt)
save(**{{"train|spec": np.asarray(json.dumps({{k: [list(p) if isinstance(p, tuple) else p
                                                 for p in v.spec]
                                             for k, v in flat(model.param_shardings()).items()}}))}})


def step(p, o, b):
    g = jax.grad(lambda q: loss_fn(q, cfg, model.ctx, b))(p)
    p, o, metrics = model.train_step(p, o, b)
    return g, p, o, metrics["loss"]


with mesh:
    psh, osh = model.param_shardings(), model.opt_shardings()
    params = jax.device_put(model.init_params(jax.random.key(0)), psh)
    opt_state = jax.device_put(model.init_opt(params), osh)
    bsh = model.input_shardings(ShapeConfig("t", SEQ, BATCH, "train"))
    batch = jax.device_put({{"tokens": jnp.asarray(data["train|tokens"]),
                            "labels": jnp.asarray(data["train|labels"])}}, bsh)
    g, params, opt_state, loss = jax.jit(step, out_shardings=(psh, psh, osh, None))(
        params, opt_state, batch)
    save(**{{"train|loss": loss}})
    save(**{{"train|g." + k: v for k, v in flat(g).items()}})
    leaves = {{"p." + k: v for k, v in flat(params).items()}}
    leaves.update({{"mu." + k: v for k, v in flat(opt_state.mu).items()}})
    leaves.update({{"nu." + k: v for k, v in flat(opt_state.nu).items()}})
    for k, v in leaves.items():
        for s in v.addressable_shards:
            save(**{{"train|" + k + "|" + str(devices.index(s.device)): s.data}})
"""


# ---------------------------------------------------------------------- #
# the port's side, on every rank of the gloo world
# ---------------------------------------------------------------------- #
def _cfg(arch, patch=None):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch).reduced(), **(patch or {}))


def _bound_model(cfg, mname, params, opt=None):
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import make_model
    from repro_torch.parallel.sharding import Rules, ShardingCtx
    mesh = make_mesh(*MESHES[mname])
    model = make_model(cfg, ShardingCtx(Rules(), mesh), device="cpu", opt=opt)
    model.load_params({k: torch.from_numpy(v) for k, v in params.items()})
    return model


def _serve(model, toks):
    """Prefill of the rank's block of the prompt, the cache spliced into the
    rank's blocks of CACHE-position buffers, three decode steps: the last
    logits of each and the prefill cache's blocks."""
    import torch
    from repro_torch.launch.serve import splice_cache
    from repro_torch.models.config import ShapeConfig
    from repro_torch.parallel.sharding import local_shard
    mesh, t = model.ctx.mesh, torch.from_numpy(toks).long()
    psh = model.input_shardings(ShapeConfig("p", SEQ, BATCH, "prefill"))["tokens"]
    dsh = model.input_shardings(ShapeConfig("d", CACHE, BATCH, "decode"))["tokens"]
    logits, pc = model.prefill_step(local_shard(t[:, :SEQ], psh.spec, mesh))
    out = {"logits": [logits.numpy().copy()],
           "cache": {k: v.numpy().copy() for k, v in pc.items()}}
    cache = model.init_cache(ShapeConfig("d", CACHE, BATCH, "decode"))
    splice_cache(cache, pc, model.ctx)
    for i in range(GEN):
        logits, cache = model.serve_step(
            cache, local_shard(t[:, SEQ + i:SEQ + i + 1], dsh.spec, mesh), SEQ + i)
        out["logits"].append(logits.numpy().copy())
    out["dcache"] = {k: v.float().numpy().copy() for k, v in cache.items()}
    out["coord"] = list(mesh.get_coordinate())
    return out


def _train(params, batch):
    import torch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.parallel.sharding import local_shard
    from repro_torch.models.config import ShapeConfig
    cfg = _cfg("llama3.2-3b")
    model = _bound_model(cfg, TRAIN_MESH, params,
                         OptConfig(kind=cfg.optimizer, warmup=5, total_steps=10))
    mesh = model.ctx.mesh
    bsh = model.input_shardings(ShapeConfig("t", SEQ, BATCH, "train"))
    local = {k: local_shard(torch.from_numpy(v).long(), bsh[k].spec, mesh)
             for k, v in batch.items()}
    grads = {}

    def reduce(loss, g):
        loss, g = model.mean_over_batch(loss, g)
        psh = model.param_shardings()
        grads.update({k: model.gather(v, psh[k]).numpy().copy() for k, v in g.items()})
        return loss, g
    opt_state, metrics = model.train_step(model.init_opt(), local, reduce=reduce)
    shards = {"p." + k: v.numpy().copy() for k, v in model.masters().items()}
    shards.update({"mu." + k: v.numpy().copy() for k, v in opt_state.mu.items()})
    shards.update({"nu." + k: v.numpy().copy() for k, v in opt_state.nu.items()})
    return dict(loss=float(metrics["loss"]), grads=grads, shards=shards)


def _port_world(rank, world, inputs):
    out = {}
    for case, mname in SERVE_CASES:
        arch, patch = CASES[case]
        model = _bound_model(_cfg(arch, patch), mname, inputs["params"][arch])
        out[(case, mname)] = _serve(model, inputs["tokens"][arch])
    out["train"] = _train(inputs["params"]["llama3.2-3b"], inputs["train"])
    return out


def _jax_params(arch):
    import jax
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.model import make_model as jax_make_model
    from repro_torch.convert import params_from_jax
    tree = jax.device_get(jax_make_model(jax_get_config(arch).reduced()).init_params(
        jax.random.key(0)))
    return {k: v.numpy() for k, v in params_from_jax(tree).items()}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(0)
    archs = sorted({arch for arch, _ in CASES.values()})
    tokens, data = {}, {}
    for arch in archs:
        tokens[arch] = rng.integers(0, _cfg(arch).vocab, (BATCH, SEQ + GEN)).astype(np.int32)
        data[f"{arch}|tokens"] = tokens[arch]
    vocab = _cfg("llama3.2-3b").vocab
    train = {k: rng.integers(0, vocab, (BATCH, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")}
    data.update({f"train|{k}": v for k, v in train.items()})
    np.savez(tmp / "data.npz", **data)
    # the configs' patches change no parameter: one set of weights an arch
    inputs = dict(params={arch: _jax_params(arch) for arch in archs}, tokens=tokens,
                  train=train)
    code = ORACLE.replace("np.load(sys.argv[1])", f"np.load({str(tmp / 'data.npz')!r})")
    with ThreadPoolExecutor(1) as pool:
        oracle = pool.submit(run_jax_oracle, code, tmp, timeout=600.0)
        ranks = run_world(_port_world, WORLD, tmp, args=(inputs,), timeout=600.0)
        oracle = oracle.result()
    return inputs, oracle, ranks


def _close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL, err_msg=what)


def _rows(mname, coord):
    """The batch rows of the rank at mesh coordinate ``coord``."""
    shape, names = MESHES[mname]
    sizes, at = dict(zip(names, shape)), dict(zip(names, coord))
    blocks = sizes.get("pod", 1) * sizes["data"]
    i = at.get("pod", 0) * sizes["data"] + at["data"]
    return slice(i * BATCH // blocks, (i + 1) * BATCH // blocks)


@pytest.mark.parametrize("case,mesh", SERVE_CASES, ids=[_tag(c, m) for c, m in SERVE_CASES])
def test_prefill_cache_blocks_match_jax_devices(case, mesh, results):
    """Each rank's prefill cache block (its rows, and its positions of the
    KV caches or its heads of the SSM state; the conv state whole over
    "model") is JAX's device shard at its mesh coordinate."""
    _, oracle, ranks = results
    tag = _tag(case, mesh)
    for r, res in enumerate(ranks):
        got = res[(case, mesh)]
        assert got["coord"] == list(np.unravel_index(r, MESHES[mesh][0]))
        assert got["cache"].keys() == {k.split("|")[3] for k in oracle
                                       if k.startswith(f"{tag}|cache|")}
        for k, v in got["cache"].items():
            want = oracle[f"{tag}|cache|{k}|{r}"]
            assert v.shape == want.shape, (k, v.shape, want.shape)
            _close(v, want, f"{tag} cache {k} rank {r}")


@pytest.mark.parametrize("case,mesh", SERVE_CASES, ids=[_tag(c, m) for c, m in SERVE_CASES])
def test_prefill_and_decode_logits_match_jax(case, mesh, results):
    """The last logits of prefill and of three decode steps on every rank
    (its rows, whole over "model") are JAX's within ``LOGIT_TOL``: the
    model ranks' partial softmaxes combined, the window (zamba2) cutting
    keys from the third decode step on, decode's MoE on the dispatch."""
    _, oracle, ranks = results
    tag = _tag(case, mesh)
    for r, res in enumerate(ranks):
        got = res[(case, mesh)]
        rows = _rows(mesh, got["coord"])
        for i, logits in enumerate(got["logits"]):
            want = oracle[f"{tag}|logits|{i}"][rows]
            assert logits.shape == want.shape
            _close(logits, want, f"{tag} step {i} rank {r}")


@pytest.mark.parametrize("case,mesh", SERVE_CASES, ids=[_tag(c, m) for c, m in SERVE_CASES])
def test_decode_cache_blocks_match_jax_devices(case, mesh, results):
    """After three decode steps each rank's cache blocks are JAX's device
    shards: the new K and V written by the block that holds their position
    alone (bf16 entries, ``CACHE_TOL``), the SSM states of the rank's heads
    (fp32, ``LOGIT_TOL``)."""
    _, oracle, ranks = results
    tag = _tag(case, mesh)
    for r, res in enumerate(ranks):
        for k, v in res[(case, mesh)]["dcache"].items():
            want = oracle[f"{tag}|dcache|{k}|{r}"]
            assert v.shape == want.shape, (k, v.shape, want.shape)
            tol = LOGIT_TOL if k in ("conv", "ssm") else CACHE_TOL
            np.testing.assert_allclose(v, want, atol=tol, rtol=tol,
                                       err_msg=f"{tag} decode cache {k} rank {r}")


def test_window_cuts_during_decode():
    """zamba2's window of 16 under a 32-token prompt: each decode step at
    position 32 + i attends positions (16 + i, 32 + i], so the window
    excludes prompt positions the whole decode."""
    _, patch = CASES["zamba2-2.7b"]
    assert all(SEQ + i + 1 - patch["sliding_window"] > 0 for i in range(GEN))
    assert SEQ > patch["sliding_window"] and CACHE % 4 == 0 and CACHE > SEQ + GEN


# ---------------------------------------------------------------------- #
# a train step on ("pod", "data", "model")
# ---------------------------------------------------------------------- #
def _block(full, spec, coord):
    """The block of ``full`` that mesh coordinate ``coord`` owns under
    ``spec`` (JAX's order of each dimension's axes)."""
    if np.ndim(full) == 0:
        return full
    shape, names = MESHES[TRAIN_MESH]
    sizes, at = dict(zip(names, shape)), dict(zip(names, coord))
    index = []
    for d, p in enumerate(spec):
        axes = [p] if isinstance(p, str) else list(p or [])
        i, k = 0, 1
        for a in axes:
            i, k = i * sizes[a] + at[a], k * sizes[a]
        n = full.shape[d] // k
        index.append(slice(i * n, (i + 1) * n))
    return full[tuple(index)]


def test_train_step_on_pod_mesh_matches_jax(results):
    """Reduced llama on ("pod" 2, "data" 1, "model" 2) from JAX's weights:
    the global-batch loss within 1e-6, the mean gradient within 1e-5 of each
    leaf's largest |g| of JAX's (its rows split over pod x data, the mean
    over both), and every rank's shard of each master and moment after the
    AdamW step within 1e-6 of the kind's largest |value| or AdamW's slope
    times the gradient tolerance (``test_torch_model_axis._step_tolerance``)."""
    from test_torch_model_axis import _step_tolerance
    _, oracle, ranks = results
    spec = json.loads(str(oracle["train|spec"]))
    want_loss = float(oracle["train|loss"])
    step_oracle = {k.replace("train|", "t|1|", 1): v for k, v in oracle.items()
                   if k.startswith("train|g.")}
    for r, res in enumerate(ranks):
        got = res["train"]
        coord = list(np.unravel_index(r, MESHES[TRAIN_MESH][0]))
        assert abs(got["loss"] - want_loss) <= LOSS_TOL * abs(want_loss)
        for k, g in got["grads"].items():
            want = oracle[f"train|g.{k}"]
            np.testing.assert_allclose(g, want, atol=GRAD_TOL * np.abs(want).max(), rtol=0,
                                       err_msg=k)
        for kind in ("p.", "mu.", "nu."):
            keys = [k for k in got["shards"] if k.startswith(kind)]
            scale = max(np.abs(oracle[f"train|{k}|{r}"]).max() for k in keys)
            for key in keys:
                want = oracle[f"train|{key}|{r}"]
                assert got["shards"][key].shape == want.shape, key
                carried = _block(_step_tolerance(step_oracle, "t", 1, key),
                                 spec[key.split(".", 1)[1]], coord)
                err = np.abs(got["shards"][key] - want)
                assert (err <= np.maximum(SHARD_TOL * scale, carried)).all(), (key, err.max())


# ---------------------------------------------------------------------- #
# ref_decode's contract and the windowed decode
# ---------------------------------------------------------------------- #
# ref_decode attends in fp32 whatever its inputs' dtype: float64 inputs are
# held to the direct float64 softmax at fp32's rounding of the sums
REF_TOL = 1e-5


def _masked_softmax(q, k, v, lo, hi):
    """Direct float64 attention of each row over positions [lo, hi): the
    output and the logsumexp, 0 and -inf where the range is empty."""
    b, h, _, d = q.shape
    kvh = k.shape[1]
    out, lse = np.zeros((b, h, 1, d)), np.full((b, h, 1), -np.inf)
    for i in range(b):
        if hi[i] <= lo[i]:
            continue
        for j in range(h):
            s = k[i, j // (h // kvh), lo[i]:hi[i]] @ q[i, j, 0] / math.sqrt(d)
            m = s.max()
            w = np.exp(s - m)
            lse[i, j, 0] = m + np.log(w.sum())
            out[i, j, 0] = w @ v[i, j // (h // kvh), lo[i]:hi[i]] / w.sum()
    return out, lse


@pytest.mark.parametrize("b,h,kvh,S,d", [(4, 4, 2, 40, 16), (3, 8, 1, 70, 32)])
def test_ref_decode_starts_empty_rows_and_lse(b, h, kvh, S, d):
    """Row i attends [starts[i], lengths[i]); a row with starts >= lengths
    gives 0 and a logsumexp of -inf without NaN; the logsumexp is of the
    scaled scores; ``starts`` None is zeros."""
    import torch
    from repro_torch.kernels.ref import ref_decode
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal(s) for s in ((b, h, 1, d), (b, kvh, S, d), (b, kvh, S, d)))
    hi = rng.integers(1, S + 1, b).astype(np.int32)
    lo = np.maximum(hi - rng.integers(1, S, b), 0).astype(np.int32)
    lo[0] = hi[0]                                            # an empty row
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ref_decode(tq, tk, tv, torch.from_numpy(hi), torch.from_numpy(lo), lse=True)
    want, want_lse = _masked_softmax(q, k, v, lo, hi)
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert not out[0].any() and torch.isneginf(lse[0]).all()
    np.testing.assert_allclose(out.numpy(), want, atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=REF_TOL, rtol=REF_TOL)
    plain = ref_decode(tq, tk, tv, torch.from_numpy(hi))
    np.testing.assert_allclose(plain.numpy(), _masked_softmax(q, k, v, 0 * hi, hi)[0],
                               atol=REF_TOL, rtol=REF_TOL)


@pytest.mark.parametrize("window", [1, 5, 16, 64])
def test_windowed_decode_matches_jax_attention(window):
    """The port's attention in decode with a cache and a window (the
    ``starts`` of ``flash_decode``'s contract) against JAX's
    ``layers.attention`` with the same cache, window and position: output
    within 1e-5, and the new k/v written at ``cache_index``."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.configs.registry import get_config as jax_get_config
    from repro.models import layers as jl
    from repro.parallel.sharding import ShardingCtx
    from repro_torch.models import layers as tl
    jcfg = jax_get_config("llama3.2-3b").reduced()
    cfg = _cfg("llama3.2-3b")
    rng = np.random.default_rng(window)
    e, kvh, d, b, S, pos = cfg.d_model, cfg.n_kv_heads, cfg.hd, 3, 48, 30
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in tl.attn_specs(cfg).items()}
    x = rng.standard_normal((b, 1, e)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, S, kvh, d)).astype(np.float32) for _ in range(2))
    positions = np.full((b, 1), pos, np.int32)
    jo, jc = jl.attention(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                          ShardingCtx(), jnp.asarray(positions),
                          cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                          cache_index=jnp.int32(pos), window=window)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    o, c = tl.attention(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                        cfg, torch.from_numpy(positions).long(), cache={"k": tk, "v": tv},
                        cache_index=pos, window=window)
    np.testing.assert_allclose(o.numpy(), np.asarray(jax.device_get(jo)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c["k"].numpy(), np.asarray(jc["k"]), atol=1e-6, rtol=1e-6)
