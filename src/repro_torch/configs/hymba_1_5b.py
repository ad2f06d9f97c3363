"""hymba-1.5b — hybrid: parallel attention + mamba heads per layer,
sliding-window attention on most layers. [arXiv:2411.13676]
32L d_model=1600 25H (GQA kv=5) d_ff=5504 ssm_state=16."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, ssm_state=16, ssm_heads=25, ssm_head_dim=64,
    hybrid=True, local_window=1024,
)

SMOKE = replace(
    CONFIG, name="hymba-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, ssm_state=8, ssm_heads=4,
    ssm_head_dim=16, head_dim=16, local_window=16,
)
