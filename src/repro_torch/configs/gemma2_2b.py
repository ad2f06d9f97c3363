"""gemma2-2b — local+global alternating attention, logit softcap.
[arXiv:2408.00118] 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
head_dim=256, attn softcap 50, final-logit softcap 30, window 4096."""
from .base import ModelConfig
from dataclasses import replace

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, d_ff=9216,
    vocab=256000, head_dim=256,
    attn_softcap=50.0, logit_softcap=30.0,
    local_window=4096, alt_local_global=True, post_norms=True,
    act="gelu",
)

SMOKE = replace(
    CONFIG, name="gemma2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=256, head_dim=16, local_window=16,
)
