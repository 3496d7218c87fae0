"""qwen3-moe-30b-a3b — 128 experts top-8, every layer MoE
[hf:Qwen/Qwen3-30B-A3B]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=4, head_dim=128, d_ff=6144, vocab=151936,
    mlp_act="swiglu", rope="rope", rope_theta=1_000_000.0,
    n_experts=128, top_k=8, moe_every=1, moe_d_ff=768)
