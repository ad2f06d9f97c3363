"""K1 ``matmul`` and K2 ``batch_matmul``: the tunable matrix-product kernels.

Source: ``csrc/matmul.cu`` (one source), CUDA C++ for ``sm_90a``.  It
replaces the Pallas kernels ``matmul`` and ``batch_matmul`` of the JAX
package's ``kernels/matmul.py``.  The tuned (bm, bn, bk) are runtime
arguments, so the tile the search sampled is the tile that runs.  Both
products share three kernels, each with a batch axis (K1 is batch 1), and
:func:`variant` picks one from M and the tile alone:

* ``splitk`` for M < 16 (decode): grid (N/bn, B·M/bm, K/bk), 128 threads,
  shared memory ``4·(bm·bk + 4·bm·bn)``; with K/bk > 1 the partials go to a
  (K/bk, B, M, N) scratch the wrapper allocates and the last CTA of each
  output tile sums them in split order (a per-tile counter the kernel
  resets, kept per device and stream);
* ``tc`` for M >= 16 with bm % 16, bn % 8 and bk % 8 all 0 (prefill and
  forward): 3xTF32 tensor cores, grid (N/bn, M/bm, B), one warp per
  :func:`warp_tile` block of m16n8 fragments, two ``cp.async`` stages when
  they fit in shared memory (:func:`tc_stage_bytes`), else one;
* ``fma`` otherwise: grid (N/bn, M/bm, B), the threads of
  :func:`micro_tile` and ``4·(bm·bk + bk·bn)`` bytes of shared memory.

The card caps a grid's y and z at 65,535 blocks.  A K2 launch therefore
covers at most :func:`batches_per_launch` batches, and the wrapper runs a
larger batch as consecutive launches over slices of it.

The note at the top of the source says what bounds each variant on the
card and what its design does about it.

Beside each wrapper: its plain PyTorch version (``kernels/ref.py``), which
the wrapper runs for CPU tensors only, and a launch counter
(``matmul.launches`` / ``batch_matmul.launches``) that counts kernel
launches and nothing else; ``launches_by_variant`` splits each by
variant.  ``last_launch`` records the launch configuration of the latest
launch.  For a CUDA tensor the wrapper checks device, dtype and shape,
launches, and raises on a refused launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ScheduleRejected, ref, tile_counters

DEFAULT_BLOCKS = (128, 128, 128)

# shared memory a CTA may use on an H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
MAX_THREADS = 512  # per CTA; the kernel's launch bound for T = 8
_MICRO_TILES = (1, 2, 4, 8)  # per-thread output tile T x T, compiled sizes
_GRID_YZ_MAX = 65535

VARIANTS = ("splitk", "tc", "fma")
SPLITK_MAX_M = 16  # M below this takes the split-K variant
SPLITK_THREADS = 128  # four warps: SPLITK_WARPS in the source
TC_MAX_WARPS = 16
# (WM, WN) m16n8 fragments a warp, the compiled sizes, smallest first
_WARP_TILES = ((1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (2, 4), (4, 2), (4, 4))

_ACT = {"none": 0, "relu": 1, "gelu": 2, "silu": 3, "softcap": 4}


def _act_code(epilogue: str) -> int:
    if epilogue in ("none", "bias", None):
        return _ACT["none"]
    for name in ("relu", "gelu", "silu"):
        if epilogue.endswith(name):
            return _ACT[name]
    if epilogue == "softcap":
        return _ACT["softcap"]
    raise ValueError(f"unknown epilogue {epilogue!r}")


def micro_tile(bm: int, bn: int) -> Tuple[int, int]:
    """(T, threads): the smallest compiled T x T per-thread output tile that
    covers a bm x bn tile with at most 512 threads.  Raises
    ``ScheduleRejected`` for a tile no compiled size can cover: the largest
    T keeps 64 accumulators a thread, and 512 such threads fill an SM's
    registers."""
    for t in _MICRO_TILES:
        threads = -(-bm // t) * -(-bn // t)
        if threads <= MAX_THREADS:
            return t, threads
    raise ScheduleRejected(
        "threads",
        f"tile {bm}x{bn} needs {threads} threads of {t}x{t} outputs; "
        f"cap {MAX_THREADS}"
    )


def variant(M: int, blocks: Tuple[int, int, int]) -> str:
    """The variant of K1 or K2 for M rows (a batch's) and the snapped tile."""
    bm, bn, bk = blocks
    if M < SPLITK_MAX_M:
        return "splitk"
    if bm % 16 == 0 and bn % 8 == 0 and bk % 8 == 0:
        return "tc"
    return "fma"


def warp_tile(bm: int, bn: int) -> Tuple[Tuple[int, int], int]:
    """((WM, WN), threads) of the ``tc`` variant: the smallest compiled
    block of WM x WN m16n8 fragments a warp that tiles bm x bn with at most
    16 warps.  Raises ``ScheduleRejected("threads")`` when none does."""
    fm, fn = bm // 16, bn // 8
    for wm, wn in _WARP_TILES:
        warps = (fm // wm) * (fn // wn)
        if fm % wm == 0 and fn % wn == 0 and warps <= TC_MAX_WARPS:
            return (wm, wn), 32 * warps
    raise ScheduleRejected(
        "threads",
        f"tile {bm}x{bn} needs more than {TC_MAX_WARPS} warps of 4x4 fragments"
    )


def tc_stage_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory of one ``tc`` stage: each operand's tile in the larger
    of its two layouts, rows padded against bank conflicts (the source's
    ``tc_x_floats`` and ``tc_w_floats``)."""
    pad_n = 8 if bn % 16 == 0 else 0
    x = max(bm * (bk + 4), bk * (bm + 8))
    w = max(bk * (bn + pad_n), bn * (bk + 4))
    return 4 * (x + w)


def splitk_smem_bytes(bm: int, bn: int, bk: int) -> int:
    """Shared memory of a ``splitk`` CTA: x's (bm, bk) slice and one
    (bm, bn) partial a warp."""
    return 4 * (bm * bk + (SPLITK_THREADS // 32) * bm * bn)


def _reject_smem(blocks, smem: int) -> None:
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"tile {tuple(blocks)} needs {smem} bytes of shared memory; "
            f"cap {MAX_SMEM_BYTES}"
        )


def _reject_grid(grid) -> None:
    if grid[1] > _GRID_YZ_MAX or grid[2] > _GRID_YZ_MAX:
        raise ScheduleRejected("grid", f"grid {grid} exceeds the card's limits")


def batches_per_launch(var: str, batch: int, tiles_m: int) -> int:
    """The batches of ``batch`` one launch of variant ``var`` covers,
    ``tiles_m`` = M / bm: the batch axis is grid y with the M tiles
    (``splitk``) or grid z (``tc``, ``fma``), each capped at 65,535."""
    if var == "splitk":
        return max(1, min(batch, _GRID_YZ_MAX // tiles_m))
    return min(batch, _GRID_YZ_MAX)


def launch_config(
    batch: int, M: int, N: int, K: int, blocks: Tuple[int, int, int]
) -> dict:
    """The :func:`variant`, grid, threads, dynamic shared memory, stages,
    splits, warp tile and micro tile of a K1 (``batch`` 1) or K2 launch
    with ``blocks``; the same keys for every variant.  The grid is that of
    one launch, over :func:`batches_per_launch` batches.

    Raises ``ScheduleRejected`` for a tile that does not divide the
    problem or that the chosen kernel cannot run (shared memory, threads,
    grid), the schedule rejections the search treats as failed candidates.
    """
    bm, bn, bk = blocks
    if M % bm or N % bn or K % bk:
        raise ScheduleRejected(
            "divide", f"blocks {tuple(blocks)} must divide {(M, N, K)}"
        )
    var = variant(M, blocks)
    batch = batches_per_launch(var, batch, M // bm)
    cfg = {"variant": var, "blocks": (bm, bn, bk), "stages": 1, "splits": 1,
           "warp_tile": None, "micro_tile": None}
    if var == "splitk":
        smem = splitk_smem_bytes(bm, bn, bk)
        _reject_smem(blocks, smem)
        cfg.update(grid=(N // bn, batch * (M // bm), K // bk),
                   threads=SPLITK_THREADS, smem_bytes=smem, splits=K // bk)
    elif var == "tc":
        stage = tc_stage_bytes(bm, bn, bk)
        _reject_smem(blocks, stage)
        stages = 2 if 2 * stage <= MAX_SMEM_BYTES else 1
        wt, threads = warp_tile(bm, bn)
        cfg.update(grid=(N // bn, M // bm, batch), threads=threads,
                   smem_bytes=stages * stage, stages=stages, warp_tile=wt)
    else:
        smem = 4 * (bm * bk + bk * bn)
        _reject_smem(blocks, smem)
        t, threads = micro_tile(bm, bn)
        cfg.update(grid=(N // bn, M // bm, batch), threads=threads,
                   smem_bytes=smem, micro_tile=t)
    _reject_grid(cfg["grid"])
    return cfg


def _lib():
    from ._build import load

    lib = load("matmul")
    if not getattr(lib, "_repro_typed", False):
        P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        # x, w, bias, y, [part, counters,] B, M, N, K, bm, bn, bk, the six
        # strides, then each variant's own arguments
        head, dims, strides = [P, P, P, P], [I] * 7, [L] * 6
        lib.repro_matmul_fma.argtypes = head + dims + strides + [I, Fl, I, P]
        lib.repro_matmul_splitk.argtypes = (head + [P, P] + dims + strides
                                            + [I, Fl, L, P])
        lib.repro_matmul_tc.argtypes = (head + dims + strides
                                        + [I, I, I, I, Fl, L, P])
        for fn in (lib.repro_matmul_fma, lib.repro_matmul_splitk, lib.repro_matmul_tc):
            fn.restype = I
        lib._repro_typed = True
    return lib


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise RuntimeError(f"{name}: operands on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")


def _clamp(blocks, M, N, K):
    bm, bn, bk = blocks
    return (min(bm, M), min(bn, N), min(bk, K))


def _launch(name: str, cfg: dict, x, w, bias, y, dims: Tuple[int, int, int, int],
            strides: Tuple[int, ...], act: int, softcap: float) -> None:
    """Launch ``cfg``'s variant for y[b] = act(x[b] @ w[b] + bias), b < B:
    ``dims`` (B, M, N, K), x's three strides then w's in ``strides`` (batch
    strides 0 at B = 1), y (B, M, N) or (M, N) contiguous."""
    B, M, N, K = dims
    var = cfg["variant"]
    ptrs = (x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr())
    sizes = (*dims, *cfg["blocks"])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        lib = _lib()
        if var == "splitk":
            splits = cfg["splits"]
            part = (torch.empty((splits, B, M, N), dtype=torch.float32,
                                device=x.device) if splits > 1 else None)
            counters = tile_counters(x.device, stream,
                                     cfg["grid"][0] * cfg["grid"][1])
            err = lib.repro_matmul_splitk(
                *ptrs, None if part is None else part.data_ptr(),
                counters.data_ptr(), *sizes, *strides, act, float(softcap),
                cfg["smem_bytes"], stream,
            )
        elif var == "tc":
            wm, wn = cfg["warp_tile"]
            err = lib.repro_matmul_tc(
                *ptrs, *sizes, *strides, wm, wn, cfg["stages"], act,
                float(softcap), cfg["smem_bytes"], stream,
            )
        else:
            err = lib.repro_matmul_fma(
                *ptrs, *sizes, *strides, act, float(softcap), cfg["micro_tile"],
                stream,
            )
    from ._build import check

    check(err, f"{name} {var} {tuple(cfg['blocks'])} on ({B}, {M}, {N}, {K})")


def matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    epilogue: str = "none",
    softcap: float = 30.0,
    block_sizes: Tuple[int, int, int] = DEFAULT_BLOCKS,
) -> torch.Tensor:
    """y = epilogue(x @ w + bias); x: (M, K), w: (K, N), any strides."""
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    act = _act_code(epilogue)
    blocks = _clamp(block_sizes, M, N, K)
    if x.device.type == "cpu":
        return ref.matmul(x, w, bias, epilogue=epilogue, softcap=softcap)
    if x.device.type != "cuda":
        raise RuntimeError(f"matmul: no kernel for device {x.device}")
    operands = (x, w) if bias is None else (x, w, bias)
    _check_cuda("matmul", *operands)
    if bias is not None and (bias.shape != (N,) or not bias.is_contiguous()):
        raise ValueError(f"matmul: bias must be contiguous ({N},)")
    cfg = launch_config(1, M, N, K, blocks)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    _launch("matmul", cfg, x, w, bias, y, (1, M, N, K),
            (0, *x.stride(), 0, *w.stride()), act, softcap)
    matmul.launches += 1
    matmul.launches_by_variant[cfg["variant"]] += 1
    matmul.last_launch = cfg
    return y


matmul.launches = 0
matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
matmul.last_launch = None


def batch_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    block_sizes: Tuple[int, int, int] = DEFAULT_BLOCKS,
) -> torch.Tensor:
    """y[b] = x[b] @ w[b]; x: (B, M, K), w: (B, K, N), any strides.

    The per-batch tile and its variant are :func:`matmul`'s, with the batch
    on the variant's batch axis (:func:`launch_config`); a batch over
    :func:`batches_per_launch` runs as one launch a slice of that many.
    """
    B, M, K = x.shape
    B2, K2, N = w.shape
    if B != B2 or K != K2:
        raise ValueError(
            f"batch_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}"
        )
    blocks = _clamp(block_sizes, M, N, K)
    if x.device.type == "cpu":
        return ref.batch_matmul(x, w)
    if x.device.type != "cuda":
        raise RuntimeError(f"batch_matmul: no kernel for device {x.device}")
    _check_cuda("batch_matmul", x, w)
    cfg = launch_config(B, M, N, K, blocks)
    per = batches_per_launch(cfg["variant"], B, M // cfg["blocks"][0])
    y = torch.empty((B, M, N), dtype=x.dtype, device=x.device)
    for b0 in range(0, B, per):
        nb = min(per, B - b0)
        sxb, swb = (x.stride(0), w.stride(0)) if nb > 1 else (0, 0)
        _launch("batch_matmul", cfg, x[b0:b0 + nb], w[b0:b0 + nb], None,
                y[b0:b0 + nb], (nb, M, N, K),
                (sxb, *x.stride()[1:], swb, *w.stride()[1:]), _ACT["none"], 0.0)
        batch_matmul.launches += 1
        batch_matmul.launches_by_variant[cfg["variant"]] += 1
    batch_matmul.last_launch = cfg
    return y


batch_matmul.launches = 0
batch_matmul.launches_by_variant = dict.fromkeys(VARIANTS, 0)
batch_matmul.last_launch = None
