"""Decoder LM of the dense family (smollm, stablelm, qwen1.5, gemma-2).

The port of the JAX package's ``models/transformer.py`` for the dense
family: parameters have the reference's names, shapes and dtypes, with
layers stacked along a leading L axis; the reference's ``lax.scan`` over
the stack becomes a Python loop over it, and the per-layer window reaches
each layer as a Python int.  There is one card, so the reference's
sharding constraints have no counterpart.  Mixture-of-experts, state-space,
encoder-decoder and multimodal families belong to later slices and raise.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    unsupported = [
        name
        for name, on in (
            ("moe", cfg.moe_experts),
            ("ssm", cfg.ssm_state or cfg.attn_free),
            ("encoder-decoder", cfg.enc_layers),
            ("mrope", cfg.mrope),
            ("embedding inputs", cfg.embedding_inputs),
        )
        if on
    ]
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(unsupported)} not in this slice "
            "(dense family only)"
        )


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig, seed: int = 0, device: str = "cuda"
) -> Params:
    """Random parameters from a seeded ``torch.Generator``, with the
    reference's shapes and dtypes (bf16 weights, f32 norm scales).  The
    values differ from the reference's ``jax.random`` ones; to run both on
    the same weights convert the reference's with ``models/convert.py``.
    ``device="meta"`` allocates nothing."""
    _check_family(cfg)
    dev = torch.device(device) if str(device) == "meta" else resolve_device(device)
    gen = None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    Ln, D = cfg.n_layers, cfg.d_model

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    layers: Params = {"ln1": ones(Ln, D)}
    layers["attn"] = L.attention_init(gen, cfg, device=dev, layers=Ln)
    if cfg.post_norms:
        layers["post_ln1"] = ones(Ln, D)
    if cfg.d_ff:
        layers["ln2"] = ones(Ln, D)
        layers["mlp"] = L.mlp_init(gen, D, cfg.d_ff, device=dev, layers=Ln)
        if cfg.post_norms:
            layers["post_ln2"] = ones(Ln, D)
    return {
        "embed": L.embed_init(gen, cfg.vocab, D, device=dev),
        "layers": layers,
        "final_ln": ones(D),
    }


# ---------------------------------------------------------------------------
# Per-layer metadata (window pattern)
# ---------------------------------------------------------------------------


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """(L,) int32; 0 = global attention, >0 = sliding window size."""
    Ln = cfg.n_layers
    if cfg.alt_local_global and cfg.local_window:
        w = [(cfg.local_window if i % 2 == 0 else 0) for i in range(Ln)]
    elif cfg.hybrid and cfg.local_window:
        # hymba: global attention on first / middle / last layers
        glb = {0, Ln // 2, Ln - 1}
        w = [(0 if i in glb else cfg.local_window) for i in range(Ln)]
    elif cfg.local_window:
        w = [cfg.local_window] * Ln
    else:
        w = [0] * Ln
    return np.asarray(w, dtype=np.int32)


MAX_WINDOW_PERIOD = 4


def window_period(windows: np.ndarray, max_period: int = MAX_WINDOW_PERIOD):
    """Smallest period ``p <= max_period`` of the window pattern, or None.

    ``p`` divides the layer count and ``windows[i] == windows[i % p]`` for
    all i — uniform models give 1, gemma-2 local/global alternation 2.
    The layer loop here needs no period (every window is a Python int);
    the function is kept for callers that group layers by pattern.
    """
    Ln = len(windows)
    for p in range(1, min(max_period, Ln) + 1):
        if Ln % p == 0 and all(
            int(windows[i]) == int(windows[i % p]) for i in range(Ln)
        ):
            return p
    return None


def _layer(tree: Params, i: int) -> Params:
    """Layer ``i`` of the stacked (L, ...) parameter tree."""
    return {
        k: (_layer(v, i) if isinstance(v, dict) else v[i]) for k, v in tree.items()
    }


# ---------------------------------------------------------------------------
# Forward (full sequence)
# ---------------------------------------------------------------------------


def _positions(B: int, S: int, device, offset: int = 0) -> torch.Tensor:
    pos = offset + torch.arange(S, dtype=torch.int32, device=device)
    return pos.expand(B, S)


def _attn_full(cfg, p, x, pos, window: Optional[int], chunk=1024):
    B, S, _ = x.shape
    q, k, v = L.qkv_proj(p, x, cfg)
    q = L.apply_rope(q, pos[:, None], theta=cfg.rope_theta)
    k = L.apply_rope(k, pos[:, None], theta=cfg.rope_theta)
    out = L.chunked_attention(
        q, k, v,
        causal=True,
        window=window,
        softcap=cfg.attn_softcap,
        chunk=min(chunk, S),
    )
    out = out.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim)
    return L.dense_op(out, p["wo"])


def _layer_fwd(cfg: ModelConfig, p: Params, x, pos, window: Optional[int]):
    """One decoder layer: attention → FFN, each with a residual."""
    h = L.rmsnorm(x, p["ln1"], cfg.norm_eps)
    a = _attn_full(cfg, p["attn"], h, pos, window)
    if cfg.post_norms:
        a = L.rmsnorm(a, p["post_ln1"], cfg.norm_eps)
    x = x + a
    if cfg.d_ff:
        h2 = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        f = L.mlp(p["mlp"], h2, cfg.act)
        if cfg.post_norms:
            f = L.rmsnorm(f, p["post_ln2"], cfg.norm_eps)
        x = x + f
    return x


def forward(
    cfg: ModelConfig, params: Params, tokens: torch.Tensor
) -> torch.Tensor:
    """Full-sequence forward -> logits (B, S, V)."""
    _check_family(cfg)
    x = L.embed(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    B, S, _ = x.shape
    pos = _positions(B, S, x.device)
    windows: List[Optional[int]] = [int(w) or None for w in layer_windows(cfg)]
    for i in range(cfg.n_layers):
        x = _layer_fwd(cfg, _layer(params["layers"], i), x, pos, windows[i])
    x = L.rmsnorm(x, params["final_ln"], cfg.norm_eps)
    logits = L.unembed(x, params["embed"])
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
