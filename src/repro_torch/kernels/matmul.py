"""K1 ``matmul`` and K2 ``batch_matmul``: the tunable matrix-product kernels.

Source: ``csrc/matmul.cu`` (one source, two entry points), CUDA C++ for
``sm_90a``.  It replaces the Pallas kernels ``matmul`` and
``batch_matmul`` of the JAX package's ``kernels/matmul.py``.  The tuned
(bm, bn, bk) are runtime arguments: they set the grid (N/bn, M/bm, B),
the threads of a CTA and its dynamic shared memory ``4·(bm·bk + bk·bn)``
bytes, so the tile the search sampled is the tile that runs.  The note at
the top of the source says what bounds the kernel on the card and what
its design does about it.

Beside each wrapper: its plain PyTorch version (``kernels/ref.py``), which
the wrapper runs for CPU tensors only, and a launch counter
(``matmul.launches`` / ``batch_matmul.launches``) that counts kernel
launches and nothing else.  ``last_launch`` records the launch
configuration of the latest launch.  For a CUDA tensor the wrapper checks
device, dtype and shape, launches, and raises on a refused launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import ScheduleRejected, ref

DEFAULT_BLOCKS = (128, 128, 128)

# shared memory a CTA may use on an H100 (232,448 bytes)
MAX_SMEM_BYTES = 227 * 1024
MAX_THREADS = 512  # per CTA; the kernel's launch bound for T = 8
_MICRO_TILES = (1, 2, 4, 8)  # per-thread output tile T x T, compiled sizes
_GRID_YZ_MAX = 65535

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


def launch_config(
    batch: int, M: int, N: int, K: int, blocks: Tuple[int, int, int]
) -> dict:
    """Grid, threads and dynamic shared memory of a launch with ``blocks``.

    Raises ``ScheduleRejected`` for a tile that does not divide the
    problem or that the card cannot run (shared memory, threads, grid), the
    schedule rejections the search treats as failed candidates.
    """
    bm, bn, bk = blocks
    if M % bm or N % bn or K % bk:
        raise ScheduleRejected(
            "divide", f"blocks {tuple(blocks)} must divide {(M, N, K)}"
        )
    smem = 4 * (bm * bk + bk * bn)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"tile {tuple(blocks)} needs {smem} bytes of shared memory; "
            f"cap {MAX_SMEM_BYTES}"
        )
    t, threads = micro_tile(bm, bn)
    grid = (N // bn, M // bm, batch)
    if grid[1] > _GRID_YZ_MAX or grid[2] > _GRID_YZ_MAX:
        raise ScheduleRejected("grid", f"grid {grid} exceeds the card's limits")
    return {
        "blocks": (bm, bn, bk),
        "grid": grid,
        "threads": threads,
        "micro_tile": t,
        "smem_bytes": smem,
    }


def _lib():
    from ._build import load

    lib = load("matmul")
    if not getattr(lib, "_repro_typed", False):
        P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.repro_matmul.argtypes = [
            P, P, P, P, I, I, I, I, I, I, L, L, L, L, I, Fl, I, P
        ]
        lib.repro_matmul.restype = I
        lib.repro_batch_matmul.argtypes = [
            P, P, P, I, I, I, I, I, I, I, L, L, L, L, L, L, I, P
        ]
        lib.repro_batch_matmul.restype = I
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
    bm, bn, bk = blocks
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_matmul(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), y.data_ptr(),
            M, N, K, bm, bn, bk,
            x.stride(0), x.stride(1), w.stride(0), w.stride(1),
            act, float(softcap), cfg["micro_tile"], stream,
        )
    from ._build import check

    check(err, f"matmul {tuple(blocks)} on ({M}, {N}, {K})")
    matmul.launches += 1
    matmul.last_launch = cfg
    return y


matmul.launches = 0
matmul.last_launch = None


def batch_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    block_sizes: Tuple[int, int, int] = DEFAULT_BLOCKS,
) -> torch.Tensor:
    """y[b] = x[b] @ w[b]; x: (B, M, K), w: (B, K, N), any strides.

    The batch rides blockIdx.z; the per-batch tiling is :func:`matmul`'s.
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
    y = torch.empty((B, M, N), dtype=x.dtype, device=x.device)
    bm, bn, bk = blocks
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_batch_matmul(
            x.data_ptr(), w.data_ptr(), y.data_ptr(),
            B, M, N, K, bm, bn, bk,
            x.stride(0), x.stride(1), x.stride(2),
            w.stride(0), w.stride(1), w.stride(2),
            cfg["micro_tile"], stream,
        )
    from ._build import check

    check(err, f"batch_matmul {tuple(blocks)} on ({B}, {M}, {N}, {K})")
    batch_matmul.launches += 1
    batch_matmul.last_launch = cfg
    return y


batch_matmul.launches = 0
batch_matmul.last_launch = None
