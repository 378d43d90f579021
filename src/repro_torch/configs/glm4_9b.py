"""glm4-9b [dense]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552, RoPE, QKV bias [hf:THUDM/glm-4-9b]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, head_dim=128, d_ff=13696, vocab=151552,
    qkv_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="glm4-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    qkv_bias=True,
)
