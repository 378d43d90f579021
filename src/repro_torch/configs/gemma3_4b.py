"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144, 5:1 local:global (window 1024), 128k context
[hf:google/gemma-3-*-pt; unverified]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
    sliding_window=1024, swa_global_every=6, rope_theta=1e6,
    embed_scale=True, tie_embeddings=True, act="gelu",
)

SMOKE_CONFIG = ModelConfig(
    name="gemma3-smoke", family="dense", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    sliding_window=8, swa_global_every=2, embed_scale=True,
    tie_embeddings=True, act="gelu",
)
