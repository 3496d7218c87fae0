"""The yardstick's arithmetic pinned to the figures the port's kernel
table gives at its shapes, and the model FLOPs of the cells."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import roofline, weights
from portbench.reference import sizes

ROOT = Path(__file__).resolve().parents[2]


def _port(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_attention_backward_at_the_llama_training_shape():
    sec, flops, _ = roofline.attention_bwd(2, 24, 8, 1024, 1024, 128)
    assert flops / 1e9 == pytest.approx(32.2, abs=0.05)
    assert sec * 1e3 == pytest.approx(0.0326, abs=5e-5)


def test_ssd_backward_at_the_mamba2_training_shape():
    sec, flops, _ = roofline.ssd_bwd(2, 1024, 80, 64, 1, 128, 256)
    assert flops / 1e9 == pytest.approx(10.96, abs=0.005)
    assert sec * 1e3 == pytest.approx(0.0664, abs=5e-5)


def test_forward_bounds_at_the_serving_shapes():
    sec, _, _ = roofline.ssd_fwd(8, 512, 80, 64, 1, 128, 256)
    assert sec * 1e3 == pytest.approx(0.0660, abs=1e-4)
    sec, _, _ = roofline.attention_fwd(8, 24, 8, 512, 512, 128)
    assert sec * 1e3 == pytest.approx(0.02003, abs=5e-5)


@pytest.mark.parametrize("name, params", [("mamba2-2.7b", 2.70e9), ("phi3-medium-14b", 3.05e9)])
def test_parameter_counts(name, params):
    config = _port(name)
    lay = weights.layout(sizes(config), config)
    assert weights.n_params(lay) == pytest.approx(params, rel=0.01)


def test_model_flops_of_the_cells():
    m2, p3 = sizes(_port("mamba2-2.7b")), sizes(_port("phi3-medium-14b"))
    assert roofline.train_flops(m2, 2, 4096) / 1e12 == pytest.approx(139.2, rel=0.01)
    assert roofline.forward_flops(p3, 4, 2048) / 1e12 == pytest.approx(48.73, rel=0.01)
    assert roofline.train_flops(p3, 2, 4096) / 1e12 == pytest.approx(3 * 50.11, rel=0.01)


def test_a_leaf_is_drawn_again_alone():
    config = _port("mamba2-2.7b")
    port = dict(sizes(config), n_layers=2, d_model=64, vocab=256, ssm_state=16,
                ssm_head_dim=16)
    lay = weights.layout(port, config)
    a = {k: weights.draw(v, 99, k, "cpu") for k, v in lay.items()}
    b = weights.draw(lay["blocks.in_proj"], 99, "blocks.in_proj", "cpu")
    assert (a["blocks.in_proj"] == b).all()
    assert not (weights.draw(lay["blocks.in_proj"], 98, "blocks.in_proj", "cpu") == b).all()
    dt = __import__("torch").nn.functional.softplus(a["blocks.dt_bias"])
    assert 1e-4 <= float(dt.min()) and float(dt.max()) <= 0.1 + 1e-6


def test_an_unknown_family_raises():
    """A family without its module is refused, not priced or laid out as
    another family's."""
    config = dict(_port("phi3-medium-14b"), reference="moe")
    with pytest.raises(ValueError, match="reference/moe.py"):
        weights.layout(sizes(config), config)
    with pytest.raises(ValueError, match="reference/moe.py"):
        roofline.forward_flops(sizes(config), 4, 2048)
