"""The attention kernels: K3 prefill, K5 decode and K6 paged decode.

K3 ``flash_attention`` (source ``csrc/flash_attention.cu``, CUDA C++ for
``sm_90a``) replaces the Pallas kernel ``flash_attention`` of the JAX
package's ``kernels/flash_attention.py``.  One CTA owns one (batch·head,
block of ``block_q`` query rows) and loops over the kv blocks of
``block_kv`` itself, with the running max, sum and accumulator in shared
memory; GQA maps head h to kv head h // G by offset.  The tuned (block_q,
block_kv) are runtime arguments that set the grid (S/block_q, B·H) and the
shared memory of a CTA.

K5 ``decode_flash_attention`` and K6 ``paged_decode_flash_attention``
(source ``csrc/decode_attention.cu``) replace the Pallas kernels of the
same names: one query token per sequence against a fixed-shape cache, the
length and window masks arriving as an additive bias row.  The kv axis is
split over CTAs (flash-decoding): the grid is (batch·kv head, splits), a
CTA takes the G query rows of its group over a contiguous run of kv rows,
whole tiles of ``block_kv`` (K5, a runtime divisor of T) or pages read
through the page table (K6) where there are enough of them and part of one
otherwise, and the last CTA of a (batch, kv head) combines the splits'
partial (max, sum, accumulator) in split order, in the same launch.
The split count is a pure function of the shape, the tile and the card's SM
count (:func:`decode_splits`).  The note at the top of each source says what
bounds the kernel and what its design does about it.

Beside each wrapper: the plain PyTorch version (``kernels/ref.py``), which
the wrapper runs for CPU tensors only, and the launch counter
``<wrapper>.launches``; ``last_launch`` records the latest launch
configuration.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ScheduleRejected, ref, sm_count, tile_counters

NEG_INF = ref.NEG_INF
MAX_SMEM_BYTES = 227 * 1024
THREADS = 256  # fixed CTA size of the kernel (csrc/flash_attention.cu)
_GRID_Y_MAX = 65535
_GRID_X_MAX = 2**31 - 1


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


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_cuda_operands(name: str, tensors, dtypes) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise RuntimeError(f"{name}: operands on different devices")
        if t.dtype != dt:
            raise TypeError(f"{name}: the CUDA kernel takes {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


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
    _check_cuda_operands("flash_attention", (q, k, v), (torch.float32,) * 3)
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


# ---------------------------------------------------------------------------
# K5 / K6: single-token decode attention
# ---------------------------------------------------------------------------


def decode_splits(bh: int, T: int, bkv: int, sms: int):
    """(rows a split, splits) of a decode launch over ``bh`` = batch·kv
    heads and ``T`` kv rows in tiles of ``bkv`` on a card of ``sms`` SMs.
    The card wants ceil(sms / bh) splits a (batch, kv head).  Where the
    tiles are as many, a split is a run of whole tiles, as many as still
    leave that count; where they are fewer (a large tile), a split is
    ceil(T / wanted) rows, part of one tile.  One split when ``bh`` alone
    fills the card."""
    want = -(-sms // bh)
    n_tiles = T // bkv
    rows = bkv * (n_tiles // want) if n_tiles >= want else -(-T // want)
    return rows, -(-T // rows)


def decode_smem_bytes(g: int, bkv: int, d: int) -> int:
    """Shared memory of one decode CTA: q and acc (G·D each), the V tile,
    the K tile padded to D+1 a row, the G·bkv score tile and three
    G-vectors."""
    return 4 * (2 * g * d + bkv * (d + 1) + bkv * d + g * bkv + 3 * g)


def check_decode_tile(G: int, T: int, D: int, bkv: int) -> int:
    """The shared memory of a decode CTA with kv tile ``bkv``; raises
    ``ScheduleRejected`` for a tile that does not divide T or does not fit
    in shared memory.  Whether a tile runs does not depend on the card's
    SM count, so the lowering checks it with no card."""
    if T % bkv:
        raise ScheduleRejected("divide", f"block_kv {bkv} must divide T={T}")
    smem = decode_smem_bytes(G, bkv, D)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"decode block_kv {bkv} at G={G}, D={D} needs {smem} bytes of "
            f"shared memory; cap {MAX_SMEM_BYTES}"
        )
    return smem


def decode_launch_config(B: int, KVH: int, G: int, T: int, D: int, bkv: int,
                         sms: int) -> dict:
    """Grid (B·KVH, splits), threads, shared memory, the rows a split
    (:func:`decode_splits`) and the f32 scratch of the partials
    (B·KVH·splits·(2G + G·D), none with one split) of a decode launch with
    kv tile ``bkv`` on a card of ``sms`` SMs; raises ``ScheduleRejected``
    for a tile the card cannot run (:func:`check_decode_tile`)."""
    smem = check_decode_tile(G, T, D, bkv)
    rows, splits = decode_splits(B * KVH, T, bkv, sms)
    grid = (B * KVH, splits)
    if grid[0] > _GRID_X_MAX or grid[1] > _GRID_Y_MAX:
        raise ScheduleRejected("grid", f"grid {grid} exceeds the card's limits")
    scratch = 4 * B * KVH * splits * (2 * G + G * D) if splits > 1 else 0
    return {"blocks": (bkv,), "grid": grid, "threads": THREADS, "smem_bytes": smem,
            "splits": splits, "rows_per_split": rows, "scratch_bytes": scratch}


def _decode_lib():
    from ._build import load

    lib = load("decode_attention")
    if not getattr(lib, "_repro_typed", False):
        P, I, Fl, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.repro_decode_attention.argtypes = [P] * 7 + [I] * 8 + [Fl, Fl, L, P]
        lib.repro_decode_attention.restype = I
        lib.repro_paged_decode_attention.argtypes = [P] * 8 + [I] * 9 + [Fl, Fl, L, P]
        lib.repro_paged_decode_attention.restype = I
        lib._repro_typed = True
    return lib


def _decode_buffers(cfg: dict, q: torch.Tensor, stream: int):
    """The output, the partials' scratch behind it in one allocation, and
    the per-(batch, kv head) counters of a decode launch; no scratch and no
    counters with one split.  The counters are K1's split-K
    ones (:func:`tile_counters`): kept per device and stream, each launch
    leaves them zero."""
    if cfg["splits"] == 1:
        return torch.empty_like(q), None, None
    buf = torch.empty(q.numel() + cfg["scratch_bytes"] // 4, dtype=torch.float32,
                      device=q.device)
    counters = tile_counters(q.device, stream, cfg["grid"][0])
    return buf[: q.numel()].view(q.shape), buf[q.numel():], counters


def decode_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
    block_kv: int = 128,
) -> torch.Tensor:
    """K5. q: (B, KVH, G, D); k, v: (B, KVH, T, D); bias: (B, T) additive
    mask (0 attendable, -1e30 masked) shared across heads.  Returns
    (B, KVH, G, D).  ``block_kv`` snaps to the divisor of T nearest it."""
    B, KVH, G, D = q.shape
    T = k.shape[2]
    if k.shape != (B, KVH, T, D) or v.shape != k.shape or bias.shape != (B, T):
        raise ValueError(
            f"decode_flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)}"
        )
    scale = scale if scale is not None else 1.0 / (D**0.5)
    bkv = best_divisor(T, min(block_kv, T))
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, bias, softcap=softcap, scale=scale)
    _check_cuda_operands("decode_flash_attention", (q, k, v, bias),
                         (torch.float32,) * 4)
    if softcap is not None and softcap <= 0:
        raise ValueError(f"decode_flash_attention: softcap must be > 0, got {softcap}")
    cfg = decode_launch_config(B, KVH, G, T, D, bkv, sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        o, part, counters = _decode_buffers(cfg, q, stream)
        err = _decode_lib().repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            o.data_ptr(), _ptr(part), _ptr(counters), B, KVH, G, T, D, bkv,
            cfg["rows_per_split"], cfg["splits"], float(scale),
            float(softcap or 0.0), cfg["smem_bytes"], stream,
        )
    from ._build import check

    check(err, f"decode_flash_attention ({bkv},) on {tuple(k.shape)}")
    decode_flash_attention.launches += 1
    decode_flash_attention.last_launch = cfg
    return o


decode_flash_attention.launches = 0
decode_flash_attention.last_launch = None


def paged_decode_flash_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    bias: torch.Tensor,
    *,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """K6. q: (B, KVH, G, D); k_pool, v_pool: (n_pages, KVH, ps, D);
    page_table: (B, P) int32 physical page ids, the sentinel ``n_pages``
    marking unallocated entries (clamped to the last page; the bias must
    mask their positions); bias: (B, P·ps).  Returns (B, KVH, G, D), the
    same as :func:`decode_flash_attention` over the gathered view.  The kv
    tile is the page."""
    B, KVH, G, D = q.shape
    n_pages, _, ps, _ = k_pool.shape
    P = page_table.shape[1]
    if (k_pool.shape != (n_pages, KVH, ps, D) or v_pool.shape != k_pool.shape
            or page_table.shape != (B, P) or bias.shape != (B, P * ps)):
        raise ValueError(
            f"paged_decode_flash_attention: q {tuple(q.shape)}, pools "
            f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
            f"{tuple(page_table.shape)}, bias {tuple(bias.shape)}"
        )
    scale = scale if scale is not None else 1.0 / (D**0.5)
    if q.device.type == "cpu":
        return ref.paged_decode_attention(
            q, k_pool, v_pool, page_table, bias, softcap=softcap, scale=scale
        )
    _check_cuda_operands(
        "paged_decode_flash_attention", (q, k_pool, v_pool, page_table, bias),
        (torch.float32, torch.float32, torch.float32, torch.int32, torch.float32),
    )
    if softcap is not None and softcap <= 0:
        raise ValueError(
            f"paged_decode_flash_attention: softcap must be > 0, got {softcap}"
        )
    cfg = decode_launch_config(B, KVH, G, P * ps, D, ps, sm_count(q.device))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        o, part, counters = _decode_buffers(cfg, q, stream)
        err = _decode_lib().repro_paged_decode_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), bias.data_ptr(), o.data_ptr(), _ptr(part),
            _ptr(counters), B, KVH, G, D, ps, P, cfg["rows_per_split"],
            cfg["splits"], n_pages, float(scale), float(softcap or 0.0),
            cfg["smem_bytes"], stream,
        )
    from ._build import check

    check(err, f"paged_decode_flash_attention (ps {ps}) on {tuple(k_pool.shape)}")
    paged_decode_flash_attention.launches += 1
    paged_decode_flash_attention.last_launch = cfg
    return o


paged_decode_flash_attention.launches = 0
paged_decode_flash_attention.last_launch = None
