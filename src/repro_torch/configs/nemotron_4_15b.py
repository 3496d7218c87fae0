"""nemotron-4-15b — dense LM, GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b", family="dense", n_layers=32, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=24576, vocab=256000,
    mlp_act="relu2", rope="rope")
