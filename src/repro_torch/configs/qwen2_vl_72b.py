"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064, M-RoPE (16,24,24); vision frontend STUBBED — input_specs
provides 256 precomputed patch embeddings [arXiv:2409.12191; hf]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="dense", n_layers=80, d_model=8192,
    n_heads=64, n_kv_heads=8, head_dim=128, d_ff=29568, vocab=152064,
    qkv_bias=True, mrope_sections=(16, 24, 24), n_vision_tokens=256,
    rope_theta=1e6,
)

SMOKE_CONFIG = ModelConfig(
    name="qwen2-vl-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
    qkv_bias=True, mrope_sections=(2, 3, 3), n_vision_tokens=16,
)
