"""llama4-maverick-400b-a17b — interleaved MoE 128e top-1 + shared expert
[hf:meta-llama/Llama-4 family].  Uses Adafactor: full AdamW moments for
400B params would not fit a single v5e pod's HBM."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
    d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=8192,
    vocab=202048, mlp_act="swiglu", rope="rope", rope_theta=500_000.0,
    n_experts=128, top_k=1, moe_every=2, moe_shared=1, moe_d_ff=8192,
    optimizer="adafactor")
