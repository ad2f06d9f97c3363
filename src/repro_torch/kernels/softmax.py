"""K4 ``row_softmax``: the tunable row-softmax kernel of the ``sfm`` task.

Source: ``csrc/softmax.cu``, CUDA C++ for ``sm_90a``.  It replaces the
Pallas kernel ``row_softmax`` of the JAX package's ``kernels/softmax.py``.
One CTA owns a block of ``block_rows`` rows (grid M / block_rows), held as
f32 in dynamic shared memory (``4·block_rows·N`` bytes), and each of its
warps takes one row at a time: max, exp, sum and divide with warp-shuffle
reductions, stored in the input's type (float32 or bfloat16).  The tuned
row block is a runtime argument, so the block the search sampled (snapped
to a divisor of M) is the block that runs.  The note at the top of the
source says what bounds the kernel on the card.

Beside the wrapper: its plain PyTorch version (``ref.row_softmax``), which
it runs for CPU tensors only, and the launch counter
``row_softmax.launches``; ``last_launch`` records the latest launch
configuration.
"""

from __future__ import annotations

import ctypes

import torch

from . import ScheduleRejected, ref

DEFAULT_ROW_BLOCK = 128
MAX_SMEM_BYTES = 227 * 1024
WARPS = 8  # warps of a CTA at most; each takes one row at a time
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(bm: int, n: int) -> int:
    """Shared memory of one CTA: its bm rows of N values in f32."""
    return 4 * bm * n


def launch_config(M: int, N: int, bm: int) -> dict:
    """Grid, threads and shared memory of a launch with row block ``bm``.

    Raises ``ScheduleRejected`` for a block that does not divide M or that
    needs more shared memory than a CTA has.  Threads are 32·min(bm, 8),
    never above the card's cap, and the grid M / bm never exceeds its
    x limit.
    """
    if bm < 1 or M % bm:
        raise ScheduleRejected("divide", f"row block {bm} must divide M={M}")
    smem = smem_bytes(bm, N)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"row block {bm} at N={N} needs {smem} bytes of shared memory; "
            f"cap {MAX_SMEM_BYTES}",
        )
    return {
        "blocks": (bm,),
        "grid": (M // bm,),
        "threads": 32 * min(bm, WARPS),
        "smem_bytes": smem,
    }


def _lib():
    from ._build import load

    lib = load("softmax")
    if not getattr(lib, "_repro_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_row_softmax.argtypes = [P, P, I, I, I, I, I, P]
        lib.repro_row_softmax.restype = I
        lib._repro_typed = True
    return lib


def row_softmax(x: torch.Tensor, *, block_rows: int = DEFAULT_ROW_BLOCK) -> torch.Tensor:
    """Numerically stable softmax over the last axis of a 2-D tensor, in
    f32, returned in ``x.dtype``.  ``block_rows`` (capped at M) must divide
    M."""
    if x.dim() != 2:
        raise ValueError(f"row_softmax: x must be 2-D, got {tuple(x.shape)}")
    M, N = x.shape
    if x.device.type == "cpu":
        return ref.row_softmax(x)
    if x.device.type != "cuda":
        raise RuntimeError(f"row_softmax: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(
            f"row_softmax: the CUDA kernel takes float32 or bfloat16, got {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("row_softmax: x must be contiguous")
    cfg = launch_config(M, N, min(block_rows, M))
    (bm,) = cfg["blocks"]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_row_softmax(
            x.data_ptr(), y.data_ptr(), M, N, bm, cfg["threads"], _DTYPES[x.dtype],
            stream,
        )
    from ._build import check

    check(err, f"row_softmax ({bm},) on ({M}, {N})")
    row_softmax.launches += 1
    row_softmax.last_launch = cfg
    return y


row_softmax.launches = 0
row_softmax.last_launch = None
