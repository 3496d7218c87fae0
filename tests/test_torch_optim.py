"""Optimizer tests: AdamW / Adafactor convergence + state mirrors.

The twin of tests/test_optim.py on ``repro_torch.optim``: the same
checks in torch, where the JAX test takes ``jax.grad`` and JAX's pytrees
(the port's parameters and state are flat dicts of tensors)."""
import pytest
import torch

from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt_state
from repro_torch.optim.schedule import warmup_cosine


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_optimizer_descends_quadratic(kind):
    target = torch.tensor([[1.0, -2.0], [3.0, 0.5]])
    params = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
    cfg = OptConfig(kind=kind, lr=0.1, warmup=1, total_steps=200,
                    weight_decay=0.0)
    state = init_opt_state(params, cfg)

    def loss(p):
        return torch.sum((p["w"] - target) ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(100):
        leaves = {n: t.clone().requires_grad_() for n, t in params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves), list(leaves.values()))))
        state = apply_updates(params, g, state, cfg)
    assert float(loss(params)) < 0.05 * l0
    assert state.step == 100


def test_opt_state_structure_mirrors_params():
    params = {"a": torch.zeros((4, 8)), "nested.b": torch.zeros((3,))}
    adamw = init_opt_state(params, OptConfig(kind="adamw"))
    assert list(adamw.mu) == list(adamw.nu) == list(params)
    assert all(adamw.mu[n].shape == p.shape == adamw.nu[n].shape for n, p in params.items())
    ada = init_opt_state(params, OptConfig(kind="adafactor"))
    assert ada.mu == {}
    assert ada.nu["a"]["row"].shape == (4,) and ada.nu["a"]["col"].shape == (8,)
    assert ada.nu["nested.b"]["full"].shape == (3,)


def test_warmup_cosine_shape():
    def lr(step):
        return float(warmup_cosine(torch.tensor(step), 1e-3, warmup=10, total=100))
    lr0, lr_peak, lr_end = lr(0), lr(10), lr(100)
    assert lr0 < lr_peak
    assert abs(lr_peak - 1e-3) < 1e-9
    assert lr_end == pytest.approx(1e-4, rel=1e-3)


def test_grad_clipping_bounds_update():
    params = {"w": torch.zeros((4,))}
    cfg = OptConfig(kind="adamw", lr=1.0, clip_norm=1.0, warmup=1,
                    weight_decay=0.0)
    state = init_opt_state(params, cfg)
    huge = {"w": torch.full((4,), 1e9)}
    apply_updates(params, huge, state, cfg)
    assert float(params["w"].abs().max()) < 10.0
