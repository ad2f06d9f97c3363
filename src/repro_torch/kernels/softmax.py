"""K4 ``row_softmax``: the tunable row-softmax kernel of the ``sfm`` task.

Source: ``csrc/softmax.cu``, CUDA C++ for ``sm_90a``.  It replaces the
Pallas kernel ``row_softmax`` of the JAX package's ``kernels/softmax.py``.
One CTA owns a block of ``block_rows`` rows (grid M / block_rows), so the
block the search sampled (snapped to a divisor of M) is the block that
runs, and :func:`variant` picks one of two kernels from N alone:

* ``registers`` (N % 4 == 0 and N <= 1024): each row lives in one warp's
  registers, loaded 16 bytes (f32) or 8 bytes (bf16) a lane, with max, exp,
  sum and divide by warp shuffles; 32·min(block_rows, 32) threads, no
  shared memory;
* ``shared`` (any other N): the block held as f32 in dynamic shared memory
  (``4·block_rows·N`` bytes, so the block is limited by it), at most 8
  warps, each taking one row at a time.

Both compute in f32 and store in the input's type (float32 or bfloat16).
The note at the top of the source says what bounds the kernel on the card.

Beside the wrapper: its plain PyTorch version (``ref.row_softmax``), which
it runs for CPU tensors only, and the launch counter
``row_softmax.launches``; ``last_launch`` records the latest launch
configuration, its ``variant`` among them.
"""

from __future__ import annotations

import ctypes

import torch

from . import ScheduleRejected, ref

DEFAULT_ROW_BLOCK = 128
MAX_SMEM_BYTES = 227 * 1024
VARIANTS = ("registers", "shared")
# 4-value groups a lane of the registers variant holds, the compiled sizes
_GROUPS = (1, 2, 4, 8)
REGISTER_MAX_N = 32 * 4 * _GROUPS[-1]  # 1024 values: 32 floats a lane
REGISTER_WARPS = 32  # warps of a registers CTA at most; one row a warp at a time
SHARED_WARPS = 8  # warps of a shared-memory CTA at most
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def variant(N: int) -> str:
    """The kernel that takes rows of N values."""
    return "registers" if N % 4 == 0 and N <= REGISTER_MAX_N else "shared"


def smem_bytes(bm: int, n: int) -> int:
    """Shared memory of one ``shared`` CTA: its bm rows of N values in f32."""
    return 4 * bm * n


def launch_config(M: int, N: int, bm: int) -> dict:
    """Variant, grid, threads, shared memory and register groups a lane
    (``groups``, ``None`` for ``shared``) of a launch with row block ``bm``.

    Raises ``ScheduleRejected`` for a block that does not divide M, or, on
    the ``shared`` variant, that needs more shared memory than a CTA has.
    Threads never exceed the card's 1024 and the grid M / bm never exceeds
    its x limit.
    """
    if bm < 1 or M % bm:
        raise ScheduleRejected("divide", f"row block {bm} must divide M={M}")
    var = variant(N)
    cfg = {"variant": var, "blocks": (bm,), "grid": (M // bm,)}
    if var == "registers":
        need = -(-N // 128)  # 4-value groups a lane
        groups = next(g for g in _GROUPS if g >= need)
        cfg.update(threads=32 * min(bm, REGISTER_WARPS), smem_bytes=0, groups=groups)
        return cfg
    smem = smem_bytes(bm, N)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"row block {bm} at N={N} needs {smem} bytes of shared memory; "
            f"cap {MAX_SMEM_BYTES}",
        )
    cfg.update(threads=32 * min(bm, SHARED_WARPS), smem_bytes=smem, groups=None)
    return cfg


def _lib():
    from ._build import load

    lib = load("softmax")
    if not getattr(lib, "_repro_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_row_softmax.argtypes = [P, P, I, I, I, I, I, I, P]
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
            cfg["groups"] or 0, stream,
        )
    from ._build import check

    check(err, f"row_softmax {cfg['variant']} ({bm},) on ({M}, {N})")
    row_softmax.launches += 1
    row_softmax.last_launch = cfg
    return y


row_softmax.launches = 0
row_softmax.last_launch = None
