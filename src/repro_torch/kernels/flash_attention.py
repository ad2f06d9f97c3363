"""The attention kernels: K3 prefill, K5 decode and K6 paged decode.

K3 ``flash_attention`` (source ``csrc/flash_attention.cu``, CUDA C++ for
``sm_90a``) replaces the Pallas kernel ``flash_attention`` of the JAX
package's ``kernels/flash_attention.py``.  The tuned (block_q, block_kv)
are runtime arguments that set the grid and the shared memory of a CTA, and
:func:`variant` picks one of two kernels from the head dim and the kv tile:

* ``tc`` for block_kv % 8 == 0 and D of 8, 16, 32 or 64: 3xTF32 tensor
  cores.  A CTA takes the G query heads of one kv head over one q block,
  its G·block_q rows position-major in m16 tiles (one or two a CTA,
  ``groups`` CTAs a q block), with ``splits`` warps a tile, each over a
  contiguous share of the CTA's kv range (runs of whole kv tiles, or parts
  of a tile where the tiles are few), combined in split order
  (:func:`launch_config`);
* ``fma`` otherwise: the first kernel, one CTA per (batch·head, block of
  block_q query rows) with plain FMAs, grid (S/block_q, B·H).

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
``<wrapper>.launches`` (K3's also ``launches_by_variant``);
``last_launch`` records the latest launch configuration.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ScheduleRejected, ref, sm_count, tile_counters

NEG_INF = ref.NEG_INF
MAX_SMEM_BYTES = 227 * 1024
THREADS = 256  # the fma kernel's CTA, and K5/K6's (csrc/*attention.cu)
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


VARIANTS = ("tc", "fma")
TC_HEAD_DIMS = (8, 16, 32, 64)  # compiled tc head dims (Q's fragments in registers)
TC_MAX_WARPS = 8  # m16 tiles x kv splits a CTA (kTcMaxWarps in the source)
TC_WARPS_PER_SM = 8  # the splits aim at this many warps an SM
TC_PAD = 4  # floats a K or V row is padded by in shared memory


def smem_bytes(bq: int, bkv: int, d: int) -> int:
    """Shared memory of one ``fma`` CTA: q and acc (bq·D each), the K tile
    padded to D+1 a row, the V tile, the bq·bkv score tile and three
    bq-vectors."""
    return 4 * (2 * bq * d + bkv * (d + 1) + bkv * d + bq * bkv + 3 * bq)


def variant(D: int, bkv: int) -> str:
    """K3's variant for head dim ``D`` and kv tile ``bkv``."""
    if bkv % 8 == 0 and D in TC_HEAD_DIMS:
        return "tc"
    return "fma"


def kv_step(span: int) -> int:
    """Keys a ``tc`` warp takes a softmax step: 32, 16 or 8, the largest
    that divides ``span``, the keys it takes of a staged kv tile."""
    return 32 if span % 32 == 0 else 16 if span % 16 == 0 else 8


def tc_smem_bytes(bkv: int, d: int, m_warps: int, tiles: int, splits: int,
                  stages: int) -> int:
    """Shared memory of one ``tc`` CTA: Q's 16 rows an m16 tile, then the
    larger of the ring (``stages`` x ``tiles`` x a K and a V tile of bkv
    rows) and, with more than one split, the partials every split hands
    over after it (16 rows of acc, 16 maxima and 16 sums an m16 tile);
    rows of D + 4 floats."""
    ld = d + TC_PAD
    ring = stages * tiles * 2 * bkv * ld
    partials = splits * m_warps * (16 * ld + 32) if splits > 1 else 0
    return 4 * (m_warps * 16 * ld + max(ring, partials))


def tc_splits(n_tiles: int, bkv: int, d: int, m_warps: int, want: int):
    """(tiles, sub, stages) of a ``tc`` CTA: ``want`` kv splits (at most
    ``TC_MAX_WARPS`` warps a CTA) as ``tiles`` runs of whole kv tiles, one
    tile of each staged a round, each tile shared by ``sub`` warps that take
    a contiguous part of it of whole 8-key steps.  As many runs as the
    CTA's ``n_tiles`` allow and shared memory holds, the rest of the splits
    as parts; two stages unless a run is one tile long or two do not fit."""
    splits = max(1, min(TC_MAX_WARPS // m_warps, want))
    for tiles in range(min(n_tiles, splits), 0, -1):
        sub = splits // tiles
        while bkv % (8 * sub):
            sub -= 1
        rounds = -(-n_tiles // tiles)
        for stages in ((2, 1) if rounds > 1 else (1,)):
            smem = tc_smem_bytes(bkv, d, m_warps, tiles, tiles * sub, stages)
            if smem <= MAX_SMEM_BYTES:
                return tiles, sub, stages
    return 1, 1, 1


def launch_config(B: int, H: int, KVH: int, S: int, D: int, bq: int, bkv: int,
                  sms: int) -> dict:
    """The :func:`variant`, grid, threads, shared memory, kv splits and
    stages of a K3 launch with (bq, bkv) on a card of ``sms`` SMs; the same
    keys for both variants.

    ``tc``: the G·bq rows of a q block fill ceil(G·bq/16) m16 tiles, two a
    CTA where they pair up and one otherwise (``m_warps``), ``groups`` CTAs
    a q block; grid (S/bq · B·KVH · groups,), the heaviest q blocks first.
    ``splits`` warps a tile, as many as bring the card to
    ``TC_WARPS_PER_SM`` warps an SM within ``TC_MAX_WARPS`` a CTA, laid
    out by :func:`tc_splits`; ``kv_step`` keys a softmax step.  ``fma``:
    grid (S/bq, B·H), 256 threads.

    Raises ``ScheduleRejected`` for a tile that does not divide S, or that
    the card cannot run (shared memory, grid)."""
    if S % bq or S % bkv:
        raise ScheduleRejected("divide", f"blocks ({bq}, {bkv}) must divide S={S}")
    var = variant(D, bkv)
    cfg = {"variant": var, "blocks": (bq, bkv), "splits": 1, "tiles": 1, "sub": 1,
           "stages": 1, "groups": 1, "m_warps": None, "kv_step": None}
    if var == "fma":
        smem = smem_bytes(bq, bkv, D)
        grid = (S // bq, B * H)
        cfg.update(grid=grid, threads=THREADS, smem_bytes=smem)
    else:
        m_tiles = -(-(H // KVH) * bq // 16)
        mw = 2 if m_tiles % 2 == 0 else 1
        groups = m_tiles // mw
        ctas = (S // bq) * B * KVH * groups
        want = -(-TC_WARPS_PER_SM * sms // (ctas * mw))
        tiles, sub, stages = tc_splits(S // bkv, bkv, D, mw, want)
        smem = tc_smem_bytes(bkv, D, mw, tiles, tiles * sub, stages)
        grid = (ctas,)
        cfg.update(grid=grid, threads=32 * mw * tiles * sub, smem_bytes=smem,
                   splits=tiles * sub, tiles=tiles, sub=sub, stages=stages,
                   groups=groups, m_warps=mw, kv_step=kv_step(bkv // sub))
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"attention blocks ({bq}, {bkv}) at D={D} need {smem} bytes of "
            f"shared memory ({var}); cap {MAX_SMEM_BYTES}"
        )
    if grid[0] > _GRID_X_MAX or (len(grid) > 1 and grid[1] > _GRID_Y_MAX):
        raise ScheduleRejected("grid", f"grid {grid} exceeds the card's limits")
    return cfg


def check_tile(B: int, H: int, KVH: int, S: int, D: int, bq: int, bkv: int) -> dict:
    """The launch plan of (bq, bkv) on a card of one SM; raises
    ``ScheduleRejected`` for a tile the card cannot run.  The SM count
    only adds kv splits, and splits shrink to what fits, so whether a tile
    runs does not depend on it: the lowering checks a tile with no card."""
    return launch_config(B, H, KVH, S, D, bq, bkv, sms=1)


def _lib():
    from ._build import load

    lib = load("flash_attention")
    if not getattr(lib, "_repro_typed", False):
        P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_flash_attention.argtypes = [
            P, P, P, P, I, I, I, I, I, I, I, Fl, I, I, Fl, P
        ]
        lib.repro_flash_attention_tc.argtypes = [P] * 4 + [I] * 14 + [Fl, I, I, Fl, I, P]
        for fn in (lib.repro_flash_attention, lib.repro_flash_attention_tc):
            fn.restype = I
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
    cfg = launch_config(B, H, KVH, S, D, bq, bkv, sm_count(q.device))
    o = torch.empty_like(q)
    args = (float(scale), int(bool(causal)), int(window or 0), float(softcap or 0.0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
        if cfg["variant"] == "tc":
            vec = int(all(p % 16 == 0 for p in ptrs[:3]))
            err = _lib().repro_flash_attention_tc(
                *ptrs, B, H, KVH, S, D, bq, bkv, cfg["groups"], cfg["m_warps"],
                cfg["tiles"], cfg["sub"], cfg["stages"], cfg["kv_step"], vec, *args,
                cfg["smem_bytes"], stream,
            )
        else:
            err = _lib().repro_flash_attention(
                *ptrs, B, H, KVH, S, D, bq, bkv, *args, stream,
            )
    from ._build import check

    check(err, f"flash_attention {cfg['variant']} ({bq}, {bkv}) on {tuple(q.shape)}")
    flash_attention.launches += 1
    flash_attention.launches_by_variant[cfg["variant"]] += 1
    flash_attention.last_launch = cfg
    return o


flash_attention.launches = 0
flash_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
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
