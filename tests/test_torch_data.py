"""Data pipeline determinism + host-sharding tests.

The twin of tests/test_data.py on ``repro_torch.data``, the port's copy
of the pipeline: only the imports are rewritten."""
import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokenPipeline
from repro_torch.models.config import ShapeConfig


def _pipe(host_id=0, n_hosts=1, seed=7):
    cfg = get_config("llama3.2-3b").reduced()
    shape = ShapeConfig("t", 16, 8, "train")
    return SyntheticTokenPipeline(cfg, shape, DataConfig(seed=seed),
                                  host_id=host_id, n_hosts=n_hosts)


def test_deterministic_per_step():
    p = _pipe()
    a = p.batch_at(3)
    b = p.batch_at(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p.batch_at(4)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_labels_are_next_tokens():
    b = _pipe().batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_shards_differ_and_partition():
    p0 = _pipe(host_id=0, n_hosts=4)
    p1 = _pipe(host_id=1, n_hosts=4)
    assert p0.host_batch == 2
    a, b = p0.batch_at(0), p1.batch_at(0)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_iterator_resumes_at_step():
    p = _pipe()
    it = p.iterate(5)
    first = next(it)
    np.testing.assert_array_equal(first["tokens"], p.batch_at(5)["tokens"])


def test_stub_frontend_embeddings():
    cfg = get_config("qwen2-vl-72b").reduced()
    shape = ShapeConfig("t", 8, 2, "train")
    p = SyntheticTokenPipeline(cfg, shape)
    b = p.batch_at(0)
    assert b["embeds"].shape == (2, 8, cfg.d_model)
    assert b["labels"].shape == (2, 8)
