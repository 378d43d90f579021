"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) MoE 8e top-2,
d_ff(expert)=14336, vocab=32000, SWA 4096 on every layer
[arXiv:2401.04088; hf]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, head_dim=128, vocab=32000,
    n_experts=8, top_k=2, moe_d_ff=14336,
    sliding_window=4096, rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="mixtral-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, vocab=256,
    n_experts=4, top_k=2, moe_d_ff=96,
    sliding_window=8, rope_theta=1e4,
)
