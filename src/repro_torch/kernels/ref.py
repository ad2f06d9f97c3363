"""Plain PyTorch versions of the hand-written kernels (correctness ground
truth).  Each mirrors the JAX package's ``kernels/ref.py`` function of the
same name: exact (erf) gelu, masked scores at -1e30 rather than -inf, and
the softcap applied before the mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def apply_epilogue(y, epilogue: str, bias=None, softcap: float = 30.0):
    if bias is not None:
        y = y + bias
    if epilogue in ("none", "bias", None):
        return y
    if epilogue.endswith("relu"):
        return torch.clamp_min(y, 0.0)
    if epilogue.endswith("gelu"):
        return F.gelu(y, approximate="none")
    if epilogue.endswith("silu"):
        return F.silu(y)
    if epilogue == "softcap":
        return softcap * torch.tanh(y / softcap)
    raise ValueError(epilogue)


def matmul(x, w, bias=None, epilogue: str = "none", softcap: float = 30.0):
    """y = epilogue(x @ w + bias), fp32 accumulation."""
    y = torch.matmul(x.float(), w.float())
    if bias is not None:
        bias = bias.float()
    y = apply_epilogue(y, epilogue, bias, softcap)
    return y.to(x.dtype)


def batch_matmul(x, w):
    """y[b] = x[b] @ w[b], fp32 accumulation."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def row_softmax(x):
    """Softmax over the last axis: the row max subtracted, exponentiated and
    divided by the row sum, all in f32; returned in ``x.dtype``."""
    xf = x.float()
    e = torch.exp(xf - xf.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
):
    """Reference attention.

    q: (B, H, S, D); k/v: (B, KVH, S, D) with H % KVH == 0 (GQA).
    ``window``: sliding-window size (local attention); None = global.
    ``softcap``: gemma-2 style logit cap.
    """
    B, H, S, D = q.shape
    KVH = k.shape[1]
    G = H // KVH
    scale = scale if scale is not None else 1.0 / (D**0.5)
    kk = torch.repeat_interleave(k, G, dim=1)
    vv = torch.repeat_interleave(v, G, dim=1)
    scores = torch.matmul(q.float(), kk.float().transpose(-1, -2))
    scores = scores * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    si = torch.arange(S, device=q.device)[:, None]
    ti = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (ti <= si)
    if window is not None:
        mask = mask & (si - ti < window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p.to(vv.dtype), vv)
    return out.to(q.dtype)


def decode_attention(q, k, v, bias, softcap: Optional[float] = None,
                     scale: Optional[float] = None):
    """Single-token decode attention over a fixed-shape cache.

    q: (B, KVH, G, D), one query token per sequence, GQA-grouped;
    k, v: (B, KVH, T, D); bias: (B, T) additive mask (0 attendable, -1e30
    masked), shared across heads.  The numerics of the JAX package's
    Pallas decode body: scores in f32 scaled by 1/sqrt(D), the softcap
    before the bias, the bias added as data, and the output divided by
    the row sum clamped at 1e-30.  Returns (B, KVH, G, D) in q's dtype.
    """
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / (D**0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s + bias.float()[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p, v.float()) / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, table, bias,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None):
    """:func:`decode_attention` read through a page table.

    k_pool, v_pool: (n_pages, KVH, ps, D); table: (B, P) physical page ids,
    where the sentinel ``n_pages`` marks an unallocated entry; bias:
    (B, P·ps).  Sentinel entries are clamped to the last page, as the
    Pallas kernel does; the bias must mask their positions.
    """
    n_pages, KVH, ps, D = k_pool.shape
    B, P = table.shape
    idx = torch.clamp(table.long(), max=n_pages - 1)
    k = k_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D)
    v = v_pool[idx].permute(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D)
    return decode_attention(q, k, v, bias, softcap=softcap, scale=scale)


def ssd_scan(x, log_a, B, C):
    """Mamba-2 SSD by its naive recurrence (the ground truth of
    :func:`ssd_chunked`).

    x: (batch, S, H, P) inputs, log_a: (batch, S, H) log decay,
    B, C: (batch, S, N), shared across heads.  Returns y: (batch, S, H, P)
    in x's dtype::

        h_t = exp(log_a_t) * h_{t-1} + B_t ⊗ x_t       (h: (H, N, P), f32)
        y_t = C_t · h_t
    """
    batch, S, H, P = x.shape
    N = B.shape[-1]
    xf, Bf, Cf = x.float(), B.float(), C.float()
    h = torch.zeros((batch, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(log_a[:, t].float())[:, :, None, None]
        h = a * h + Bf[:, t, None, :, None] * xf[:, t, :, None, :]
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunk_pass(x, log_a, B, C, chunk: int):
    """The part of :func:`ssd_chunked` that needs no earlier chunk (K7's
    chunk kernel).  Returns ``cum`` = cumsum(log_a) within each chunk
    (batch, nc, L, H); ``y_intra`` (batch, S, H, P) f32, the decay-masked
    quadratic form ``Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) x_j``; and each
    chunk's own state at its end, ``Σ_j exp(cum_L - cum_j) B_j x_jᵀ``
    (batch, nc, H, N, P) f32.  ``chunk`` must divide S."""
    batch, S, H, P = x.shape
    N = B.shape[-1]
    if chunk < 1 or S % chunk:
        raise ValueError(
            f"ssd_chunked: chunk {chunk} must divide the sequence length {S}"
        )
    nc = S // chunk
    xc = x.reshape(batch, nc, chunk, H, P).float()
    lac = log_a.reshape(batch, nc, chunk, H)
    Bc = B.reshape(batch, nc, chunk, N).float()
    Cc = C.reshape(batch, nc, chunk, N).float()
    cum = torch.cumsum(lac, dim=2)  # (b, nc, L, H)

    # exp is taken where the mask keeps it (cum_i - cum_j > 0 above the
    # diagonal may overflow)
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b, nc, L, L, H)
    dec = torch.where(tri, torch.exp(diff), torch.zeros_like(diff))
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y_intra = torch.einsum("bcij,bcijh,bcjhp->bcihp", scores, dec, xc)

    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b, nc, L, H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, decay_to_end, xc)
    return cum, y_intra.reshape(batch, S, H, P), states


def ssd_state_pass(states, cum):
    """The pass over chunks (K7's pass kernel, its state half):
    ``h_c = exp(cum_L) h_{c-1} + s_c`` from h = 0.  ``states`` (batch, nc,
    H, N, P) and ``cum`` (batch, nc, L, H) from :func:`ssd_chunk_pass`.
    Returns the state before each chunk (batch, nc, H, N, P) and the final
    state (batch, H, N, P), both f32."""
    batch, nc, H, N, P = states.shape
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, H)
    h = torch.zeros((batch, H, N, P), dtype=torch.float32, device=states.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + states[:, c]
    return torch.stack(h_prev, dim=1), h


def ssd_inter(C, cum, h_prev):
    """The state's share of y (K7's pass kernel, its output half):
    ``y_inter_i = exp(cum_i) C_i·h_{c-1}``, (batch, S, H, P) f32, from C
    (batch, S, N), ``cum`` (batch, nc, L, H) and the states before each
    chunk (batch, nc, H, N, P)."""
    batch, nc, L, H = cum.shape
    P = h_prev.shape[-1]
    Cc = C.reshape(batch, nc, L, C.shape[-1]).float()
    y = torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum), h_prev)
    return y.reshape(batch, nc * L, H, P)


def ssd_chunked(x, log_a, B, C, chunk: int = 16, return_state: bool = False):
    """Chunked (state-space duality) SSD — the algorithm K7 implements,
    mathematically equal to :func:`ssd_scan`, composed of its three passes
    :func:`ssd_chunk_pass`, :func:`ssd_state_pass` and :func:`ssd_inter`.

    Within a chunk of L steps the recurrence is a decay-masked quadratic
    form, ``y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) x_j`` with
    ``cum = cumsum(log_a)``; across chunks an (N, P) f32 state per
    (batch, head) carries ``h = exp(cum_L) h + Σ_j exp(cum_L - cum_j)
    B_j x_jᵀ``, and ``y_i += exp(cum_i) C_i·h`` reads the state from
    before the chunk.  x, B and C are computed in f32; y is returned in
    x's dtype.  ``return_state=True`` also returns the final state
    (batch, H, N, P) in f32, the prefill -> decode handoff.  ``chunk``
    must divide S.
    """
    cum, y_intra, states = ssd_chunk_pass(x, log_a, B, C, chunk)
    h_prev, h = ssd_state_pass(states, cum)
    y = (y_intra + ssd_inter(C, cum, h_prev)).to(x.dtype)
    if return_state:
        return y, h
    return y
