"""qwen2-vl-2b — VLM backbone with M-RoPE; patch frontend is a STUB:
prefill consumes precomputed patch/text embeddings (assignment spec).
[arXiv:2409.12191] 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab=151936, mrope=True, qkv_bias=True, embedding_inputs=True,
)

SMOKE = replace(
    CONFIG, name="qwen2vl-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16,
)
