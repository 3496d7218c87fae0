"""llama3.2-3b — dense LM [hf:meta-llama/Llama-3.2-1B family]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072,
    n_heads=24, n_kv_heads=8, head_dim=128, d_ff=8192, vocab=128256,
    mlp_act="swiglu", rope="rope", rope_theta=500_000.0)
