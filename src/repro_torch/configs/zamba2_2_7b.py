"""zamba2-2.7b — Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242].  For the long_500k shape the shared block runs with a
sliding window (see DESIGN.md §Shape skips)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
    n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab=32000,
    mlp_act="gelu", rope="rope", ssm_state=64, ssm_head_dim=64,
    ssm_expand=2, ssm_chunk=256, ssm_groups=1, shared_attn_every=6)
