"""K3 ``flash_attention``: online-softmax prefill attention.

Source: ``csrc/flash_attention.cu``, CUDA C++ for ``sm_90a``.  It replaces
the Pallas kernel ``flash_attention`` of the JAX package's
``kernels/flash_attention.py`` (prefill only; the decode kernels belong to
a later slice).  One CTA owns one (batch·head, block of ``block_q`` query
rows) and loops over the kv blocks of ``block_kv`` itself, with the running
max, sum and accumulator in shared memory; GQA maps head h to kv head
h // G by offset.  The tuned (block_q, block_kv) are runtime arguments that
set the grid (S/block_q, B·H) and the shared memory of a CTA.  The note at
the top of the source says what bounds the kernel and what its design does
about it.

Beside the wrapper: the plain PyTorch version (``kernels/ref.py``), which
the wrapper runs for CPU tensors only, and the launch counter
``flash_attention.launches``; ``last_launch`` records the latest launch
configuration.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ScheduleRejected, ref

NEG_INF = ref.NEG_INF
MAX_SMEM_BYTES = 227 * 1024
THREADS = 256  # fixed CTA size of the kernel (csrc/flash_attention.cu)
_GRID_Y_MAX = 65535


def best_divisor(n: int, target: int) -> int:
    """Divisor of ``n`` nearest to ``target`` (the kernel needs exact tiling)."""
    best, bd = 1, abs(target - 1)
    d = 1
    while d * d <= n:
        if n % d == 0:
            for c in (d, n // d):
                if abs(c - target) < bd:
                    best, bd = c, abs(c - target)
        d += 1
    return best


def smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory of one CTA: q and acc (bq·D each), the K tile padded to
    D+1 a row, the V tile, the bq·bkv score tile and three bq-vectors."""
    return 4 * (2 * bq * d + bkv * (d + 1) + bkv * d + bq * bkv + 3 * bq)


def launch_config(B: int, H: int, S: int, D: int, bq: int, bkv: int) -> dict:
    """Grid, threads and shared memory of a launch with (bq, bkv); raises
    ``ScheduleRejected`` for blocks the card cannot run."""
    if S % bq or S % bkv:
        raise ScheduleRejected("divide", f"blocks ({bq}, {bkv}) must divide S={S}")
    smem = smem_bytes(bq, bkv, D)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"attention blocks ({bq}, {bkv}) at D={D} need {smem} bytes of "
            f"shared memory; cap {MAX_SMEM_BYTES}"
        )
    grid = (S // bq, B * H)
    if grid[1] > _GRID_Y_MAX:
        raise ScheduleRejected("grid", f"grid {grid} exceeds the card's limits")
    return {
        "blocks": (bq, bkv),
        "grid": grid,
        "threads": THREADS,
        "smem_bytes": smem,
    }


def _lib():
    from ._build import load

    lib = load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_flash_attention.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, Fl, I, I, Fl, P
        ]
        lib.repro_flash_attention.restype = I
        lib._repro_typed = True
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KVH, S, D); returns (B, H, S, D)."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    if k.shape != (B, KVH, S, D) or v.shape != k.shape or H % KVH:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}"
        )
    scale = scale if scale is not None else 1.0 / (D**0.5)
    # snap requested blocks to divisors of S: tuned (block_q, block_kv) may
    # come from a trace sampled on a different-shaped relative of this call
    bq = best_divisor(S, min(block_q, S))
    bkv = best_divisor(S, min(block_kv, S))
    if q.device.type == "cpu":
        return ref.flash_attention(
            q, k, v, causal=causal, window=window, softcap=softcap, scale=scale
        )
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: no kernel for device {q.device}")
    for t in (q, k, v):
        if t.device != q.device:
            raise RuntimeError("flash_attention: operands on different devices")
        if t.dtype != torch.float32:
            raise TypeError(
                f"flash_attention: the CUDA kernel takes float32, got {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError("flash_attention: operands must be contiguous")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be > 0, got {softcap}")
    cfg = launch_config(B, H, S, D, bq, bkv)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, KVH, S, D, bq, bkv, float(scale), int(bool(causal)),
            int(window or 0), float(softcap or 0.0), stream,
        )
    from ._build import check

    check(err, f"flash_attention ({bq}, {bkv}) on {tuple(q.shape)}")
    flash_attention.launches += 1
    flash_attention.last_launch = cfg
    return o


flash_attention.launches = 0
flash_attention.last_launch = None
