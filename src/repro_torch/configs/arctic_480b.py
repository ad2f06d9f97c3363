"""arctic-480b — 128-expert top-2 MoE with dense residual MLP.
[hf:Snowflake/snowflake-arctic-base] 35L d_model=7168 56H (GQA kv=8)
d_ff(expert)=4864 vocab=32000."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
    vocab=32000, moe_experts=128, moe_top_k=2, moe_dense_residual=True,
)

SMOKE = replace(
    CONFIG, moe_capacity_factor=-1.0, name="arctic-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=32, vocab=256, moe_experts=8, moe_top_k=2,
    head_dim=16,
)
