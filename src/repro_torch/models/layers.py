"""Building blocks of the dense decoder family, as plain functions on tensors.

Parameters are nested dicts of tensors, under the JAX package's names and
shapes (``models/convert.py`` carries the reference's parameters across).
The tuned-kernel hooks keep the reference's names — ``dense_op``,
``bmm_op``, ``rmsnorm``, ``chunked_attention``, ``unembed`` — and find the
active :class:`~repro_torch.integration.dispatch.DispatchContext` (or the
extraction recorder) through ``sys.modules`` under ``repro_torch.…``.
Attention is the chunked online-softmax over kv blocks, whose score and
value contractions go through :func:`bmm_op`.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Tuned-kernel dispatch hooks
# ---------------------------------------------------------------------------


def _dispatch_ctx():
    """Active ``repro_torch.integration.dispatch.DispatchContext``, or None.

    Read through ``sys.modules`` instead of an import: a context can only
    be active if the integration module is already imported, and this
    keeps the model layers import-light and cycle-free.
    """
    mod = sys.modules.get("repro_torch.integration.dispatch")
    return mod.current() if mod is not None else None


def _site_recorder():
    """Active task-extraction recorder, or None (same ``sys.modules``
    pattern: a recorder is only active while ``repro_torch.integration.
    extract`` runs the model on meta tensors)."""
    mod = sys.modules.get("repro_torch.integration.extract")
    return mod.current_recorder() if mod is not None else None


def _rows(x: torch.Tensor) -> int:
    m = 1
    for s in x.shape[:-1]:
        m *= int(s)
    return m


def dense_op(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Last-dim contraction ``x @ w`` — the tuned-kernel dispatch point.

    Under an active DispatchContext whose database holds a tuned trace for
    this (m, n, k), the search's best schedule executes here; otherwise
    (no context, no record, shape mismatch) the plain product runs.
    """
    rec = _site_recorder()
    if rec is not None:
        rec.add_dot("dense", m=_rows(x), n=int(w.shape[1]), k=int(w.shape[0]))
    ctx = _dispatch_ctx()
    if ctx is not None:
        out = ctx.dense(x, w)
        if out is not None:
            return out
    return torch.matmul(x, w)


def bmm_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched matmul ``a @ b`` — the batched dispatch point.

    a: (..., M, K), b: (..., K, N), identical leading batch dims; returns
    float32 (the attention online-softmax needs f32 scores).  Under an
    active DispatchContext with a tuned ``batch_matmul`` record for this
    (B, M, N, K), the tuned kernel executes; otherwise the plain product
    runs with f32 accumulation.
    """
    rec = _site_recorder()
    if rec is not None:
        bsz = 1
        for s in a.shape[:-2]:
            bsz *= int(s)
        rec.add_dot(
            "batch_matmul", b=bsz, m=int(a.shape[-2]), n=int(b.shape[-1]),
            k=int(a.shape[-1]),
        )
    ctx = _dispatch_ctx()
    if ctx is not None:
        out = ctx.batch_matmul(a, b)
        if out is not None:
            return out
    return torch.matmul(a.float(), b.float())


def _init(gen, shape, scale=None, dtype=torch.bfloat16, device="cpu"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    ctx = _dispatch_ctx()
    if ctx is not None:
        out = ctx.rmsnorm(x, w, eps)
        if out is not None:
            return out
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 10000.0, device="cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x: (..., S, D); positions: (..., S) integer."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)  # (D/2,)
    ang = positions[..., None].float() * freqs  # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : D // 2], x[..., D // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked flash attention (plain PyTorch, loop over KV blocks)
# ---------------------------------------------------------------------------


def chunked_attention(
    q: torch.Tensor,  # (B, H, S, D)
    k: torch.Tensor,  # (B, KVH, T, D)
    v: torch.Tensor,  # (B, KVH, T, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    q_offset: int = 0,
    chunk: int = 1024,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention, O(S·chunk) memory, GQA by grouping.

    Two tuned-kernel dispatch points: under an active DispatchContext the
    whole call may swap to the backend's fused flash-attention kernel, and
    otherwise the score and value contractions route through
    :func:`bmm_op` so tuned ``batch_matmul`` records swap into the loop.
    ``window`` <= 0 or None means global attention."""
    rec = _site_recorder()
    if rec is not None:
        rec.add(
            q_shape=tuple(q.shape), kvh=int(k.shape[1]), kv_seq=int(k.shape[2]),
            causal=causal, window=window, softcap=softcap, scale=scale,
            q_offset=q_offset,
        )
    ctx = _dispatch_ctx()
    if ctx is not None:
        fused = ctx.attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset,
        )
        if fused is not None:
            return fused
    B, H, S, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    chunk = min(chunk, T)
    T_valid = T  # un-padded key count: zero-padded positions must mask out
    if T % chunk:
        pad = chunk - T % chunk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        T = T + pad
    nc = T // chunk
    dev = q.device
    q_pos = q_offset + torch.arange(S, device=dev)
    # (B·KVH, G·S, D): the canonical batched-matmul layout — the same
    # (b, m, k) the task extractor keys the contraction under
    qf = q.reshape(B * KVH, G * S, D)

    m = torch.full((B, KVH, G, S, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, G, S, D), dtype=torch.float32, device=dev)
    for ci in range(nc):
        kb = k[:, :, ci * chunk:(ci + 1) * chunk]
        vb = v[:, :, ci * chunk:(ci + 1) * chunk]
        kt = kb.reshape(B * KVH, chunk, D).transpose(1, 2)  # (B·KVH, D, chunk)
        s = bmm_op(qf, kt).reshape(B, KVH, G, S, chunk) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        k_pos = ci * chunk + torch.arange(chunk, device=dev)
        mask = (k_pos[None, :] < T_valid).expand(S, chunk)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window is not None and window > 0:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(mask[None, None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = bmm_op(
            p.reshape(B * KVH, G * S, chunk).to(vb.dtype),
            vb.reshape(B * KVH, chunk, D),
        ).reshape(B, KVH, G, S, D)
        acc = acc * alpha + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(B, H, S, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention block (projections + rope)
# ---------------------------------------------------------------------------


def attention_init(gen, cfg, device="cpu", layers: int = 1) -> Dict:
    D, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = (layers,)
    p = {
        "wq": _init(gen, L + (D, H * hd), device=device),
        "wk": _init(gen, L + (D, KVH * hd), device=device),
        "wv": _init(gen, L + (D, KVH * hd), device=device),
        "wo": _init(gen, L + (H * hd, D), scale=1.0 / math.sqrt(H * hd),
                    device=device),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", KVH * hd), ("bv", KVH * hd)):
            p[name] = torch.zeros(L + (width,), dtype=torch.float32, device=device)
    return p


def qkv_proj(p: Dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, ...]:
    B, S, _ = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense_op(x, p["wq"])
    k = dense_op(x, p["wk"])
    v = dense_op(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = q.reshape(B, S, H, hd).transpose(1, 2)
    k = k.reshape(B, S, KVH, hd).transpose(1, 2)
    v = v.reshape(B, S, KVH, hd).transpose(1, 2)
    return q, k, v


# ---------------------------------------------------------------------------
# MLP (gated)
# ---------------------------------------------------------------------------


def mlp_init(gen, d_model: int, d_ff: int, device="cpu", layers: int = 1,
             gated: bool = True) -> Dict:
    L = (layers,)
    p = {
        "wi": _init(gen, L + (d_model, d_ff), device=device),
        "wo": _init(gen, L + (d_ff, d_model), device=device),
    }
    if gated:
        p["wg"] = _init(gen, L + (d_model, d_ff), device=device)
    return p


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def mlp(p: Dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = dense_op(x, p["wi"])
    actf = _ACTS[act]
    if "wg" in p:
        h = actf(dense_op(x, p["wg"])) * h
    else:
        h = actf(h)
    return dense_op(h, p["wo"])


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_init(gen, vocab: int, d_model: int, device="cpu") -> torch.Tensor:
    # N(0, 1/sqrt(d)): embeds*sqrt(d) ~ N(0,1), tied unembed logits ~ O(1)
    return _init(gen, (vocab, d_model), scale=1.0 / math.sqrt(d_model),
                 device=device)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied-embedding unembed ``bsd,vd->bsv`` — a transposed-weight
    dispatch point: the table is stored (vocab, d), so a tuned ``dense``
    record for (m, n=vocab, k=d) serves it by reading the table
    transposed."""
    rec = _site_recorder()
    if rec is not None:
        rec.add_dot(
            "dense", m=_rows(x), n=int(table.shape[0]), k=int(table.shape[1])
        )
    ctx = _dispatch_ctx()
    if ctx is not None:
        out = ctx.dense(x, table, transpose_w=True)
        if out is not None:
            return out
    return torch.matmul(x, table.t())
