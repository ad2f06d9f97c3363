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
