"""whisper-medium — encoder-decoder; conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (assignment spec).
[arXiv:2212.04356] 24L(dec)+24L(enc) d_model=1024 16H d_ff=4096 vocab=51865."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, enc_layers=24, enc_frames=1500, act="gelu",
    embedding_inputs=True,
)

SMOKE = replace(
    CONFIG, name="whisper-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=256, enc_layers=2, enc_frames=32,
    head_dim=16,
)
