"""phi4-mini-3.8b — dense LM, RoPE SwiGLU GQA [arXiv:2412.08905]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=200064,
    mlp_act="swiglu", rope="rope")
