"""Kernel entry points for models, with MetaSchedule-tuned parameters.

The port of the JAX package's ``kernels/ops.py``.  Each op chooses between
the plain PyTorch version (``backend="torch"``) and the hand-written CUDA
kernel (``backend="cuda"``, the default); the kernel wrappers run their
plain version for CPU tensors and launch the kernel (or raise) for CUDA
tensors, so a call on the card never falls back silently.  Tuned matmul
tiles are looked up in the tuning database by workload key (paper
Appendix A.6): the one set with :func:`set_database`, else the file named
by ``REPRO_TUNING_DB``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from . import flash_attention as _fa
from . import matmul as _mm
from . import ref
from . import ssd as _ssd

BACKENDS = ("cuda", "torch")

_DB = None
_DB_PATH = os.environ.get("REPRO_TUNING_DB", "")


def set_database(db) -> None:
    global _DB
    _DB = db


def _db():
    global _DB
    if _DB is None and _DB_PATH:
        from ..search.database import Database

        _DB = Database(_DB_PATH)
    return _DB


def tuned_matmul_blocks(m: int, n: int, k: int) -> Tuple[int, int, int]:
    """Tuned (bm, bn, bk) for a matmul shape: the ``blocks`` of the best
    ``dense`` record for (m, n, k), else the kernel's default tiles."""
    db = _db()
    if db is not None:
        from ..search.database import workload_key

        rec = db.best(workload_key("dense", k=k, m=m, n=n))
        if rec is not None and "blocks" in rec.meta:
            return tuple(rec.meta["blocks"])
    return _mm.DEFAULT_BLOCKS


def _plain(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend == "torch"


def matmul(
    x,
    w,
    bias=None,
    *,
    epilogue: str = "none",
    softcap: float = 30.0,
    backend: str = "cuda",
    block_sizes: Optional[Tuple[int, int, int]] = None,
):
    """2-D matmul with fused epilogue.  x: (M, K), w: (K, N)."""
    if _plain(backend):
        return ref.matmul(x, w, bias, epilogue, softcap)
    bs = block_sizes or tuned_matmul_blocks(x.shape[0], w.shape[1], x.shape[1])
    return _mm.matmul(
        x, w, bias, epilogue=epilogue, softcap=softcap, block_sizes=bs,
    )


def attention(
    q,
    k,
    v,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    backend: str = "cuda",
    block_q: int = 128,
    block_kv: int = 128,
):
    """Prefill attention.  q: (B, H, S, D); k, v: (B, KVH, S, D)."""
    if _plain(backend):
        return ref.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap
        )
    return _fa.flash_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        block_q=block_q, block_kv=block_kv,
    )


def ssd(
    x,
    log_a,
    B,
    C,
    *,
    chunk: int = 64,
    backend: str = "cuda",
    return_state: bool = False,
):
    """Chunked SSD scan with chunk ``min(chunk, S)``; ``return_state``
    also returns the final (batch, H, N, P) f32 state.

    K7 fills y (and the state) through ``ctypes``, so its outputs carry no
    ``grad_fn``.  A call that needs a gradient (grad mode on and an input
    that requires one) therefore launches it inside
    :class:`_SSDWithReferenceGrad`, whose backward is the autograd of the
    plain scan, as dispatch does for its kernels and as the reference's
    model trains through the jnp scan.  Any other call is one raw launch."""
    if _plain(backend):
        return ref.ssd_chunked(x, log_a, B, C, chunk=min(chunk, x.shape[1]),
                               return_state=return_state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, log_a, B, C)):
        return _SSDWithReferenceGrad.apply(x, log_a, B, C, chunk, return_state)
    return _ssd.ssd(x, log_a, B, C, chunk=chunk, return_state=return_state)


class _SSDWithReferenceGrad(torch.autograd.Function):
    """Forward: the K7 wrapper (its plain version for CPU tensors).
    Backward: autograd of ``ref.ssd_chunked`` on the saved inputs, for y's
    gradient and, with ``return_state``, the state's where one is given."""

    @staticmethod
    def forward(ctx, x, log_a, B, C, chunk, return_state):
        ctx.save_for_backward(x, log_a, B, C)
        ctx.chunk, ctx.return_state = chunk, return_state
        ctx.set_materialize_grads(False)
        return _ssd.ssd(x, log_a, B, C, chunk=chunk, return_state=return_state)

    @staticmethod
    def backward(ctx, *grads):
        args = [a.detach().requires_grad_(True) for a in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.ssd_chunked(*args, chunk=min(ctx.chunk, args[0].shape[1]),
                                  return_state=ctx.return_state)
        outs = out if ctx.return_state else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        got = torch.autograd.grad([o for o, _ in pairs], args,
                                  [g for _, g in pairs], allow_unused=True)
        return (*got, None, None)
