"""mamba2-370m — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 48L d_model=1024 ssm_state=128; d_inner=2*d_model,
head_dim=64 -> 32 SSD heads; no separate MLP (mamba block only)."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_heads=32, ssm_head_dim=64,
    attn_free=True,
)

SMOKE = replace(
    CONFIG, name="mamba2-smoke", n_layers=2, d_model=64, vocab=256,
    ssm_state=16, ssm_heads=4, ssm_head_dim=32,
)
