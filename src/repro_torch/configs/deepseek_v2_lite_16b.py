"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H MLA kv_lora=512,
MoE 64 routed top-6 + 2 shared, expert d_ff=1408, vocab=102400
[arXiv:2405.04434; hf]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
    n_heads=16, head_dim=192, vocab=102400,
    kv_lora=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, top_k=6, n_shared_experts=2, moe_d_ff=1408,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, head_dim=48, vocab=256,
    kv_lora=32, qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    n_experts=8, top_k=2, n_shared_experts=1, moe_d_ff=64,
)
