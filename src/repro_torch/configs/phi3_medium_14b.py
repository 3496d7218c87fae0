"""phi3-medium-14b — dense LM, RoPE SwiGLU GQA [arXiv:2404.14219]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=10, head_dim=128, d_ff=17920, vocab=100352,
    mlp_act="swiglu", rope="rope")
