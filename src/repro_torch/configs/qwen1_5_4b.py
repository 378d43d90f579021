"""qwen1.5-4b [dense]: 40L d_model=2560 20H (MHA kv=20) d_ff=6912
vocab=151936, QKV bias [hf:Qwen/Qwen1.5-4B]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense", n_layers=40, d_model=2560,
    n_heads=20, n_kv_heads=20, head_dim=128, d_ff=6912, vocab=151936,
    qkv_bias=True,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen1.5-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
    qkv_bias=True,
)
