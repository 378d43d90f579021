"""mamba2-2.7b [ssm]: 64L d_model=2560 attention-free, SSD d_state=128,
expand=2 (d_inner=5120, 80 heads of 64), vocab=50280
[arXiv:2405.21060; unverified]."""
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
    vocab=50280, d_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_chunk=256, tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-smoke", family="ssm", n_layers=2, d_model=64,
    vocab=256, d_state=16, ssm_expand=2, ssm_head_dim=16,
    ssm_chunk=8, tie_embeddings=True,
)
