"""Building blocks of the decoder families, as plain functions on tensors.

Parameters are nested dicts of tensors, under the JAX package's names and
shapes (``models/convert.py`` carries the reference's parameters across).
The tuned-kernel hooks keep the reference's names — ``dense_op``,
``bmm_op``, ``rmsnorm``, ``chunked_attention``, ``decode_attention``,
``unembed`` — and find the
active :class:`~repro_torch.integration.dispatch.DispatchContext` (or the
extraction recorder) through ``sys.modules`` under ``repro_torch.…``.
Attention is the chunked online-softmax over kv blocks, whose score and
value contractions go through :func:`bmm_op`, as do the three expert FFN
products of the mixture-of-experts layer (:func:`moe`).  The Mamba-2 SSD
mixer runs its chunked scan through ``kernels/ops.py:ssd`` (K7 on the
card).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed.sharding import shard

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


class TracedWindow(int):
    """A layer's attention window (0 = global) that the JAX package traces
    through its layer scan: every window of a model whose window pattern
    has no period (``transformer.window_period``; hymba's first, middle and
    last layers global).  It masks as the int it holds; the dispatch hooks
    read the type and keep the chunked path (``fallback traced_window``),
    as the reference's do for a traced value."""


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
        rec.add_site("dense", m=_rows(x), n=int(w.shape[1]), k=int(w.shape[0]))
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
        rec.add_bmm(tuple(a.shape), tuple(b.shape))
    ctx = _dispatch_ctx()
    if ctx is not None:
        out = ctx.batch_matmul(a, b)
        if out is not None:
            return out
    return _plain_bmm(a, b)


# the plain batched product casts its operands to f32; a low-precision b of
# more elements than this is cast and multiplied in slices of its leading
# batch axis, so that the f32 copy is one slice, not the whole operand
# (arctic-480b's (128, 7168, 4864) bf16 experts would take 17.85 GB as one
# f32 copy, beside the 54.9 GB of its two layers' parameters)
PLAIN_BMM_SLICE_ELEMS = 1 << 28


def _plain_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32, each batch entry the same product as in one call."""
    if b.dtype == torch.float32 or b.dim() < 3 or b.numel() <= PLAIN_BMM_SLICE_ELEMS:
        return torch.matmul(a.float(), b.float())
    per = max(1, PLAIN_BMM_SLICE_ELEMS // (b.numel() // b.shape[0]))
    return torch.cat([torch.matmul(a[i:i + per].float(), b[i:i + per].float())
                      for i in range(0, b.shape[0], per)])


# Logical axes of each parameter, keyed by the path suffix the sharding
# rules look up (``distributed/sharding.py:param_shardings``).  The
# reference fills the same registry from its init functions as they run;
# here it is a table, with the same keys and axes.
PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "embed": ("vocab", "embed"),
    "ln": ("embed",),
    "attn/wq": ("embed", "heads"),
    "attn/wk": ("embed", "heads"),
    "attn/wv": ("embed", "heads"),
    "attn/wo": ("heads", "embed"),
    "attn/bq": ("heads",),
    "attn/bk": ("heads",),
    "attn/bv": ("heads",),
    "mlp/wi": ("embed", "mlp"),
    "mlp/wg": ("embed", "mlp"),
    "mlp/wo": ("mlp", "embed"),
    "moe/router": ("embed", None),
    "moe/wi": ("experts", "embed", None),
    "moe/wg": ("experts", "embed", None),
    "moe/wo": ("experts", None, "embed"),
    "ssd/wx": ("embed", "heads"),
    "ssd/wz": ("embed", "heads"),
    "ssd/wB": ("embed", None),
    "ssd/wC": ("embed", None),
    "ssd/wdt": ("embed", None),
    "ssd/A_log": (None,),
    "ssd/dt_bias": (None,),
    "ssd/wo": ("heads", "embed"),
}


def _init(gen, shape, scale=None, dtype=torch.bfloat16, device="cpu"):
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # scaled in place: the draw's transient is one f32 copy of the tensor
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last axis — the ``rmsnorm`` dispatch point, keyed
    (tokens = rows of x, d, eps)."""
    rec = _site_recorder()
    if rec is not None:
        rec.add_site("rmsnorm", tokens=_rows(x), d=int(x.shape[-1]), eps=eps)
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


def mrope_sections(head_dim: int, sections=(16, 24, 24)) -> list:
    """The (temporal, height, width) split of the head_dim/2 frequency
    slots: ``sections`` rescaled to head_dim/2, the last taking the
    remainder."""
    n = head_dim // 2
    total = sum(sections)
    sec = [s * n // total for s in sections]
    sec[-1] = n - sum(sec[:-1])
    return sec


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections=(16, 24, 24),
                theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE.  x: (..., S, D); positions_3d (..., S, 3)
    = (t, h, w) ids.  Frequency slot f rotates by the id of its section's
    channel; text tokens carry identical t/h/w ids, which reduces to
    :func:`apply_rope`."""
    D = x.shape[-1]
    freqs = rope_freqs(D, theta, device=x.device)  # (D/2,)
    sel = torch.cat([
        torch.full((s,), i, dtype=torch.long, device=x.device)
        for i, s in enumerate(mrope_sections(D, sections))
    ])  # (D/2,) in {0, 1, 2}
    pos = positions_3d[..., sel]  # (..., S, D/2): channel sel[f] per slot
    ang = pos.float() * freqs
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
        if rec is not None:
            # the softmax rows of this chunk step: a tuning-only sfm site
            rec.add_site("sfm", dispatchable=False, m=_rows(s), n=chunk)
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


def _record_cache_contractions(rec, B, KVH, G, S, T, D) -> None:
    """Report the two cache contractions of :func:`decode_attention`'s
    plain path to the extraction recorder as ``batch_matmul`` sites, with
    the JAX package's layout rule for ``dispatchable``: its einsums trace
    to ``dot_general`` equations that its jaxpr walk extracts, and only the
    single-token value contraction has the canonical (…, m, k) @ (…, k, n)
    layout.  Neither runs through :func:`bmm_op` in either package."""
    m = G * S
    rec.add_site("batch_matmul", dispatchable=False, b=B * KVH, m=m, n=T, k=D)
    rec.add_site("batch_matmul", dispatchable=(S == 1), b=B * KVH, m=m, n=D, k=T)


def decode_attention(
    q: torch.Tensor,  # (B, H, S, D) — S = 1 (decode) or a prefill chunk
    k: torch.Tensor,  # (B, KVH, T, D) — full cache
    v: torch.Tensor,
    *,
    length: torch.Tensor,  # valid cache length: scalar or per-slot (B,)
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention against a KV cache (serving decode / chunked prefill).

    ``length`` may be a scalar (every lane at the same position) or a
    per-slot ``(B,)`` vector (continuous-batching arena: each slot at its
    own position).  It is the valid cache length for the *first* query
    position; when ``S > 1`` (an in-tick prefill chunk whose keys were just
    written to the cache) query ``c`` sees one more cache position than
    query ``c - 1`` — the causal staircase of a chunk, capped at ``T``.
    Under an active DispatchContext the single-token case can swap to a
    tuned ``attention_decode`` kernel: its key is static in the cache
    length ``T``, and the per-slot lengths enter the kernel as an additive
    bias, so one tuned kernel serves every decode step.  ``window`` <= 0
    or None means global attention."""
    B, H, S, D = q.shape
    KVH, T = k.shape[1], k.shape[2]
    G = H // KVH
    rec = _site_recorder()
    if rec is not None:
        rec.add(
            q_shape=tuple(q.shape), kvh=int(KVH), kv_seq=int(T),
            causal=True, window=window, softcap=softcap, scale=scale,
            q_offset=0, kind="decode",
        )
    ctx = _dispatch_ctx()
    if ctx is not None:
        tuned = ctx.decode_attention(
            q, k, v, length=length, window=window, softcap=softcap,
            scale=scale,
        )
        if tuned is not None:
            return tuned
    if rec is not None:
        _record_cache_contractions(rec, B, KVH, G, S, T, D)
        # the softmax's exp over the cache: a tuning-only sfm site of B·H·S
        # rows, as the reference's jaxpr walk finds it
        rec.add_exp((B, KVH, G, S, T))
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    pos = torch.arange(T, device=dev)
    lv = torch.as_tensor(length, device=dev).expand(B)
    w = int(window or 0)
    qg = q.reshape(B, KVH, G, S, D).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    # per-row valid lengths: a single token sees ``length`` positions, a
    # chunk's rows walk the causal staircase
    lens = torch.clamp(lv[:, None] + torch.arange(S, device=dev)[None, :], max=T)
    mask = pos[None, None, :] < lens[:, :, None]  # (B, S, T)
    if w > 0:
        mask = mask & (pos[None, None, :] > lens[:, :, None] - 1 - w)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p.to(v.dtype), v[:, :, None])
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
# MLP (gated) and MoE
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


def moe_init(gen, cfg, device="cpu", layers: int = 1) -> Dict:
    """The reference's MoE subtree: ``router`` (D, E) f32, ``wi`` and
    ``wg`` (E, D, F) bf16, ``wo`` (E, F, D) bf16, each stacked on L.  The
    expert weights are drawn one expert at a time, layer by layer, straight
    into the bf16 stack, at the fan-in scale 1/sqrt(D); ``wo`` at the
    reference's 1/sqrt(F).  The draw's f32 transient is one (D, F) slice:
    a whole layer's (E, D, F) tensor would be 17.85 GB in f32 at
    arctic-480b's width (128 experts of 7168 x 4864), and its scaled copy
    as much again."""
    D, E, F_ = cfg.d_model, cfg.moe_experts, cfg.d_ff
    L = (layers,)
    dev = torch.device(device)

    def experts(shape, scale):
        out = torch.empty(L + shape, dtype=torch.bfloat16, device=dev)
        if dev.type != "meta":
            for i in range(layers):
                for e in range(shape[0]):
                    out[i, e] = _init(gen, shape[1:], scale=scale, device=dev)
        return out

    return {
        "router": _init(gen, L + (D, E), dtype=torch.float32, device=dev),
        "wi": experts((E, D, F_), 1.0 / math.sqrt(D)),
        "wg": experts((E, D, F_), 1.0 / math.sqrt(D)),
        "wo": experts((E, F_, D), 1.0 / math.sqrt(F_)),
    }


def moe_route(p: Dict, xt: torch.Tensor, top_k: int):
    """The router of :func:`moe` on tokens ``xt`` (T, D): f32 logits
    through the plain einsum (as in the reference, no ``dense_op``), the
    softmax with its exp recorded, then the top ``top_k`` experts of each
    token, the lower index first on a tie as ``jax.lax.top_k`` takes them
    (a stable descending sort), and their renormalised gates.  Returns
    (gate_vals, gate_idx), each (T, k)."""
    logits = _einsum("td,de->te", xt.float(), p["router"])
    e = _exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = gate_vals[:, :top_k], gate_idx[:, :top_k]
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)
    return gate_vals, gate_idx


def moe_capacity(T: int, top_k: int, E: int, capacity_factor: float) -> int:
    """Slots an expert takes: ``max(int(cf·k·T/E), 4)``, or every token
    (dropless) when ``capacity_factor <= 0``."""
    if capacity_factor <= 0:
        return T
    return max(int(capacity_factor * top_k * T / E), 4)


def moe(
    p: Dict,
    x: torch.Tensor,
    top_k: int,
    capacity_factor: float = 2.0,
    act: str = "silu",
) -> torch.Tensor:
    """Capacity-bounded top-k MoE with scatter dispatch, step for step the
    reference's ``moe``: route (:func:`moe_route`), place each (token,
    slot) pair at its position in its expert's queue (a cumsum over the
    pairs in token order), scatter the kept pairs into an (E, C, D)
    buffer, run the expert FFNs as three :func:`bmm_op` calls (``wi``,
    ``wg``, then ``wo`` after the activation; f32 accumulate cast back to
    x's dtype), gather, weight and combine in f32.

    A pair past its expert's capacity is dropped: the reference scatters it
    to expert E (out of bounds, dropped) and gathers it back from there,
    which JAX clamps to ``out_e[E-1, C-1]``, weighted by a gate of 0.  The
    port writes the dropped pairs to a spare row of the buffer and clamps
    the gather the same way, so a non-finite expert output reaches the
    result as it does in the reference.  The k contributions of a token
    are summed in f32 over a (T, k, D) view, with no atomics: the same
    bits every run."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, gate_idx = moe_route(p, xt, top_k)
    C = moe_capacity(T, top_k, E, capacity_factor)
    eid = gate_idx.reshape(T * top_k)
    # position of each (token, slot) pair within its expert's queue
    flat = (eid[:, None] == torch.arange(E, device=x.device)).to(torch.int32)
    pos = (torch.cumsum(flat, dim=0) - flat).gather(1, eid[:, None])[:, 0]
    keep = pos < C
    src = xt[:, None].expand(T, top_k, D).reshape(T * top_k, D)  # token-major
    # kept pairs take distinct slots; every dropped one lands on the spare
    # row E·C, which is cut off
    dst = torch.where(keep, eid * C + pos, torch.full_like(eid, E * C))
    # sharding, as in the reference: token rows data-parallel, expert
    # buffers expert-parallel
    src = shard(src, "tokens")
    buf = x.new_zeros((E * C + 1, D))
    buf[dst] = src
    buf = shard(buf[: E * C].reshape(E, C, D), "experts")
    h = bmm_op(buf, p["wi"]).to(buf.dtype)
    g = bmm_op(buf, p["wg"]).to(buf.dtype)
    h = _ACTS[act](g) * h
    out_e = shard(bmm_op(h, p["wo"]).to(buf.dtype), "experts")  # (E, C, D)
    # the reference's gather at (E, C) for a dropped pair, clamped as JAX
    # clamps an out-of-bounds gather
    e_g = torch.where(keep, eid, torch.full_like(eid, E - 1))
    p_g = torch.where(keep, pos, torch.full_like(pos, C - 1))
    gathered = shard(out_e.reshape(E * C, D)[e_g * C + p_g], "tokens")
    w = torch.where(keep, gate_vals.reshape(T * top_k), 0.0)
    gathered = gathered * w[:, None].to(gathered.dtype)
    out = shard(gathered.float().reshape(T, top_k, D).sum(dim=1), "tokens")
    return out.reshape(B, S, D).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD mixer
# ---------------------------------------------------------------------------
#
# The reference writes the mixer's projections and its chunked scan as plain
# ``jnp.einsum`` (no ``dense_op`` hook), so nothing here dispatches; its
# jaxpr walk still extracts their contractions and exps as tuning tasks.
# ``_einsum`` / ``_exp`` / ``_softplus`` report the same sites to the
# extraction recorder from the operand shapes, and ``_record_ssd_scan``
# those of the reference's ``ssd_chunked``, which its mixer runs.


def _einsum(spec: str, *ops: torch.Tensor) -> torch.Tensor:
    rec = _site_recorder()
    if rec is not None:
        rec.add_einsum(spec, *(tuple(o.shape) for o in ops))
    return torch.einsum(spec, *ops)


def _exp(x: torch.Tensor) -> torch.Tensor:
    rec = _site_recorder()
    if rec is not None:
        rec.add_exp(tuple(x.shape))
    return torch.exp(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``: one exp over x's shape)."""
    rec = _site_recorder()
    if rec is not None:
        rec.add_exp(tuple(x.shape))
    return F.softplus(x)


def _record_ssd_scan(rec, b: int, S: int, H: int, P: int, N: int, L: int) -> None:
    """The sites of the reference's ``kernels/ref.py:ssd_chunked`` at
    chunk L, the scan its SSD mixer runs: four exps and four einsums."""
    nc = S // L
    bl, lh = (b, nc, L, N), (b, nc, L, H)
    dec, xc = (b, nc, L, L, H), (b, nc, L, H, P)
    rec.add_exp(dec)  # the decay of each (i, j) pair
    rec.add_einsum("bcin,bcjn->bcij", bl, bl)
    rec.add_einsum("bcij,bcijh,bcjhp->bcihp", (b, nc, L, L), dec, xc)
    rec.add_exp(lh)  # the decay to the chunk's end
    rec.add_einsum("bcjn,bcjh,bcjhp->bchnp", bl, lh, xc)
    rec.add_exp((b, nc, H))  # each chunk's total decay
    rec.add_exp(lh)  # exp(cum), the state's decay into the chunk
    rec.add_einsum("bcin,bcih,bchnp->bcihp", bl, lh, (b, nc, H, N, P))


def ssd_init(gen, cfg, device="cpu", layers: int = 1) -> Dict:
    D = cfg.d_model
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    inner = H * P
    L = (layers,)
    return {
        "wx": _init(gen, L + (D, inner), device=device),
        "wz": _init(gen, L + (D, inner), device=device),
        "wB": _init(gen, L + (D, N), device=device),
        "wC": _init(gen, L + (D, N), device=device),
        "wdt": _init(gen, L + (D, H), dtype=torch.float32, device=device),
        "A_log": torch.zeros(L + (H,), dtype=torch.float32, device=device),
        "dt_bias": torch.full(L + (H,), -2.0, dtype=torch.float32, device=device),
        "wo": _init(gen, L + (inner, D), scale=1.0 / math.sqrt(inner),
                    device=device),
    }


def _ssd_common(p: Dict, x: torch.Tensor, cfg):
    """Projections of the SSD mixer: the scan input ``xin`` (x's dtype:
    ``dt`` is cast to it), the gate ``z``, B and C shared across heads, and
    the f32 log decay ``log_a = -exp(A_log)·dt`` (negative)."""
    B, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    xv = _einsum("bsd,di->bsi", x, p["wx"]).reshape(B, S, H, P)
    z = _einsum("bsd,di->bsi", x, p["wz"]).reshape(B, S, H, P)
    Bm = _einsum("bsd,dn->bsn", x, p["wB"])
    Cm = _einsum("bsd,dn->bsn", x, p["wC"])
    dt = _softplus(_einsum("bsd,dh->bsh", x.float(), p["wdt"]) + p["dt_bias"])
    log_a = -_exp(p["A_log"])[None, None, :] * dt  # (B, S, H)
    xin = xv * dt[..., None].to(xv.dtype)  # ZOH-ish input scaling
    return xin, z, Bm, Cm, log_a


def _ssd_scan(xin, log_a, Bm, Cm, chunk: int, backend: str, return_state: bool):
    """The scan through ``kernels/ops.py:ssd``: K7 for CUDA tensors, its
    plain version for CPU ones (or everywhere with ``backend="torch"``).
    Task extraction runs on meta tensors, which carry shapes only: there
    the plain version computes the shapes and the reference's scan sites
    are recorded."""
    from ..kernels import ops

    if xin.device.type == "meta":
        backend = "torch"
    out = ops.ssd(xin, log_a, Bm, Cm, chunk=chunk, backend=backend,
                  return_state=return_state)
    rec = _site_recorder()
    if rec is not None:
        b, S, H, P = xin.shape
        _record_ssd_scan(rec, b, S, H, P, int(Bm.shape[-1]), chunk)
    return out


def _ssd_out(p: Dict, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    B, S = y.shape[:2]
    y = y * F.silu(z.float()).to(y.dtype)
    inner = cfg.ssm_heads * cfg.ssm_head_dim
    return _einsum("bsi,id->bsd", y.reshape(B, S, inner), p["wo"])


def ssd_mixer(p: Dict, x: torch.Tensor, cfg, chunk: int = 64,
              backend: str = "cuda") -> torch.Tensor:
    """Mamba-2 SSD sequence mixer (forward / prefill path), chunk
    ``min(chunk, S)``, which must divide S (as in the reference)."""
    xin, z, Bm, Cm, log_a = _ssd_common(p, x, cfg)
    y = _ssd_scan(xin, log_a, Bm, Cm, min(chunk, x.shape[1]), backend, False)
    return _ssd_out(p, y, z, cfg)


def ssd_mixer_with_state(p: Dict, x: torch.Tensor, cfg, chunk: int = 64,
                         backend: str = "cuda"):
    """Like :func:`ssd_mixer` but also returns the final SSM state
    (B, H, N, P) in f32 — the prefill → decode handoff."""
    xin, z, Bm, Cm, log_a = _ssd_common(p, x, cfg)
    y, state = _ssd_scan(xin, log_a, Bm, Cm, min(chunk, x.shape[1]), backend,
                         True)
    return _ssd_out(p, y, z, cfg), state


def ssd_decode_step(p: Dict, x: torch.Tensor, state: torch.Tensor, cfg):
    """Single-token SSD recurrence in plain tensor ops.  x: (B, 1, D);
    state: (B, H, N, P) f32.  Returns the mixer output (B, 1, D) and the
    new state."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    xv = _einsum("bsd,di->bsi", x, p["wx"]).reshape(B, H, P)
    z = _einsum("bsd,di->bsi", x, p["wz"]).reshape(B, H, P)
    Bm = _einsum("bsd,dn->bn", x, p["wB"])
    Cm = _einsum("bsd,dn->bn", x, p["wC"])
    dt = _softplus(_einsum("bsd,dh->bh", x.float(), p["wdt"]) + p["dt_bias"])
    a = _exp(-_exp(p["A_log"])[None] * dt)  # (B, H)
    xin = (xv * dt[..., None]).float()
    state = a[:, :, None, None] * state + Bm[:, None, :, None] * xin[:, :, None, :]
    y = _einsum("bn,bhnp->bhp", Cm.float(), state)
    y = y * F.silu(z.float())
    y = y.reshape(B, 1, H * P).to(x.dtype)
    return _einsum("bsi,id->bsd", y, p["wo"]), state


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
        rec.add_site(
            "dense", m=_rows(x), n=int(table.shape[0]), k=int(table.shape[1])
        )
    ctx = _dispatch_ctx()
    if ctx is not None:
        out = ctx.dense(x, table, transpose_w=True)
        if out is not None:
            return out
    return torch.matmul(x, table.t())
