"""qwen1.5-110b — dense with QKV bias. [hf:Qwen/Qwen1.5-0.5B family]
80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49152,
    vocab=152064, qkv_bias=True,
)

SMOKE = replace(
    CONFIG, name="qwen110b-smoke", n_layers=2, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=192, vocab=256, head_dim=8,
)
