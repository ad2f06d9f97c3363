"""stablelm-3b — dense llama-family. [hf:stabilityai/stablelm-2-1_6b]
32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304,
)

SMOKE = replace(
    CONFIG, name="stablelm-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, head_dim=16,
)
