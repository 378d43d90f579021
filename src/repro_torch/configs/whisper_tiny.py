"""whisper-tiny [audio]: enc-dec 4L+4L d_model=384 6H d_ff=1536
vocab=51865; conv frontend STUBBED — input_specs provides precomputed
1500-frame embeddings [arXiv:2212.04356; unverified]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=4, n_enc_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536,
    vocab=51865, norm="layernorm", act="gelu", gated_mlp=False,
    qkv_bias=True, tie_embeddings=True, enc_seq=1500,
)

SMOKE_CONFIG = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=256, norm="layernorm", act="gelu", gated_mlp=False,
    qkv_bias=True, tie_embeddings=True, enc_seq=24,
)
