"""qwen2-vl-72b — VLM backbone, M-RoPE [arXiv:2409.12191].

The vision frontend (dynamic-resolution ViT) is a STUB: the model takes
precomputed patch embeddings [b, s, d_model] (``embeds``)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b", family="vlm", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568, vocab=152064,
    mlp_act="swiglu", rope="mrope", rope_theta=1_000_000.0,
    frontend="vision_stub")
