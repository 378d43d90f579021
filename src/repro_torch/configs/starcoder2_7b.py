"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, layernorm + gelu (non-gated), QKV bias, RoPE
[arXiv:2402.19173; hf]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
    n_heads=36, n_kv_heads=4, head_dim=128, d_ff=18432, vocab=49152,
    norm="layernorm", act="gelu", gated_mlp=False, qkv_bias=True,
    rope_theta=1e5,
)

SMOKE_CONFIG = ModelConfig(
    name="starcoder2-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    norm="layernorm", act="gelu", gated_mlp=False, qkv_bias=True,
)
