"""smollm-135m — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152,
)

SMOKE = replace(
    CONFIG, name="smollm-smoke", n_layers=2, d_model=48, n_heads=3,
    n_kv_heads=1, d_ff=96, vocab=256, head_dim=16,
)
