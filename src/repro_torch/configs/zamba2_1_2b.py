"""zamba2-1.2b [hybrid]: 38L d_model=2048 Mamba2 backbone (d_state=64)
+ ONE shared attention block (32H kv=32, d_ff=8192) applied every 6
layers [arXiv:2411.15242; hf]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=8192, vocab=32000,
    d_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    hybrid_attn_every=6,
)

SMOKE_CONFIG = ModelConfig(
    name="zamba2-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=256,
    d_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=8,
    hybrid_attn_every=2,
)
