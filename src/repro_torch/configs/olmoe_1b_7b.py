"""olmoe-1b-7b — 64-expert top-8 MoE. [arXiv:2409.02060]
16L d_model=2048 16H (GQA kv=16) d_ff(expert)=1024 vocab=50304."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50304, moe_experts=64, moe_top_k=8,
)

SMOKE = replace(
    CONFIG, moe_capacity_factor=-1.0, name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=32, vocab=256, moe_experts=8, moe_top_k=2,
    head_dim=16,
)
