"""The twin of tests/test_models_smoke.py::test_arch_smoke on ``repro_torch``:
for every architecture of ``ARCH_IDS``, at its reduced config on the CPU,
one train step, one prefill and one decode step, checking shapes, finite
values and that the step moved the parameters (the stub frontends take
embeddings [b, s, e] in place of tokens)."""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.models.model import make_model


def _batches(cfg, b=2, s=32):
    if cfg.frontend != "token":
        train = {"embeds": torch.ones(b, s, cfg.d_model),
                 "labels": torch.zeros(b, s, dtype=torch.long)}
        dec = {"embeds": torch.ones(b, 1, cfg.d_model)}
    else:
        train = {"tokens": torch.ones(b, s, dtype=torch.long),
                 "labels": torch.zeros(b, s, dtype=torch.long)}
        dec = {"tokens": torch.ones(b, 1, dtype=torch.long)}
    return train, dec


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_arch_smoke(arch_id):
    cfg = get_config(arch_id).reduced()
    model = make_model(cfg, device="cpu")
    model.init_params(torch.Generator().manual_seed(0))
    train, dec = _batches(cfg)
    b, s = train["labels"].shape

    first = next(iter(model.masters().values())).clone()
    _, metrics = model.train_step(model.init_opt(), train)
    assert np.isfinite(metrics["loss"].item())
    # params actually changed
    assert not torch.allclose(first, next(iter(model.masters().values())))

    prompt = {k: v for k, v in train.items() if k != "labels"}
    logits, cache = model.prefill_step(**prompt)
    assert logits.shape == (b, 1, cfg.vocab)
    keys = {k: (v.shape, v.dtype) for k, v in cache.items()}
    tokens = dec.pop("tokens", None)
    lg, cache2 = model.serve_step(cache, tokens, s - 1, **dec)
    assert lg.shape == (b, 1, cfg.vocab)
    assert torch.isfinite(lg).all()
    assert {k: (v.shape, v.dtype) for k, v in cache2.items()} == keys
