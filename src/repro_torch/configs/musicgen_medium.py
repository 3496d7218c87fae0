"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284].

The EnCodec modality frontend is a STUB: the model takes precomputed
frame embeddings [b, s, d_model] (``embeds``)."""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, head_dim=64, d_ff=6144, vocab=2048,
    mlp_act="gelu", rope="abs_sin", frontend="audio_stub")
