"""K7 ``ssd``: the Mamba-2 chunked SSD scan.

Source: ``csrc/ssd.cu``, CUDA C++ for ``sm_90a``.  It replaces the Pallas
kernel ``ssd`` of the JAX package's ``kernels/ssd.py``.  One CTA per
(batch, head) loops over the chunks of the sequence in order, with the
(N, P) f32 state in shared memory: per chunk it stages x, B and C as f32
and ``cumsum(log_a)``, builds the decay-masked ``C·Bᵀ``, writes
``y = scores·x + exp(cum)·(C·h)`` and then updates the state.  The chunk
length is a runtime argument (``min(chunk, S)``, so a 48-token prompt runs
with chunk 48).  ``return_state=True`` also writes the state after the last
chunk, the (batch, H, N, P) f32 handoff from prefill to decode.  The note
at the top of the source says what bounds the kernel on the card.

Beside the wrapper: its plain PyTorch version (``ref.ssd_chunked``), which
it runs for CPU tensors only, and the launch counter ``ssd.launches``;
``last_launch`` records the latest launch configuration.
"""

from __future__ import annotations

import ctypes

import torch

from . import ScheduleRejected, ref

MAX_SMEM_BYTES = 227 * 1024
THREADS = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def smem_bytes(L: int, N: int, P: int) -> int:
    """Shared memory of one CTA, all f32: the chunk's x (L·P), B and C
    (2·L·N), the masked scores (L·L), the state (N·P) and cum (L)."""
    return 4 * (L * P + 2 * L * N + L * L + N * P + L)


def launch_config(batch: int, S: int, H: int, P: int, N: int, chunk: int) -> dict:
    """Grid, threads and shared memory of a launch with chunk length
    ``min(chunk, S)``.

    Raises ``ScheduleRejected`` for a chunk that does not divide S, or that
    needs more shared memory than a CTA has.  The grid is one CTA per
    (batch, head); the threads are fixed.
    """
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ScheduleRejected("divide", f"chunk {L} must divide S={S}")
    smem = smem_bytes(L, N, P)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"chunk {L} at N={N}, P={P} needs {smem} bytes of shared memory; "
            f"cap {MAX_SMEM_BYTES}",
        )
    return {
        "blocks": (L,),
        "grid": (batch * H,),
        "threads": THREADS,
        "smem_bytes": smem,
    }


def _lib():
    from ._build import load

    lib = load("ssd")
    if not getattr(lib, "_repro_typed", False):
        Pt, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_ssd.argtypes = [Pt, Pt, Pt, Pt, Pt, Pt, Pt] + [I] * 8 + [Pt]
        lib.repro_ssd.restype = I
        lib._repro_typed = True
    return lib


def _check(x, log_a, B, C):
    if x.dim() != 4:
        raise ValueError(f"ssd: x must be (batch, S, H, P), got {tuple(x.shape)}")
    batch, S, H, _ = x.shape
    if tuple(log_a.shape) != (batch, S, H):
        raise ValueError(
            f"ssd: log_a must be {(batch, S, H)}, got {tuple(log_a.shape)}"
        )
    if B.dim() != 3 or tuple(B.shape[:2]) != (batch, S) or B.shape != C.shape:
        raise ValueError(
            f"ssd: B and C must be (batch, S, N) alike, got {tuple(B.shape)} "
            f"and {tuple(C.shape)}"
        )


def ssd(x, log_a, B, C, *, chunk: int = 64, return_state: bool = False):
    """Chunked SSD scan.  x: (batch, S, H, P); log_a: (batch, S, H) f32;
    B, C: (batch, S, N), shared across heads.  Returns y (batch, S, H, P)
    in x's dtype and, with ``return_state``, also the final state
    (batch, H, N, P) in f32.  ``min(chunk, S)`` must divide S."""
    _check(x, log_a, B, C)
    batch, S, H, P = x.shape
    N = B.shape[-1]
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, log_a, B, C, chunk=min(chunk, S),
                               return_state=return_state)
    if x.device.type != "cuda":
        raise RuntimeError(f"ssd: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(
            "ssd: the CUDA kernel takes x, B and C all float32 or all bfloat16, "
            f"got {x.dtype}, {B.dtype}, {C.dtype}"
        )
    if log_a.dtype != torch.float32:
        raise TypeError(f"ssd: log_a must be float32, got {log_a.dtype}")
    if not (log_a.is_contiguous() and B.is_contiguous() and C.is_contiguous()):
        raise ValueError("ssd: log_a, B and C must be contiguous")
    if not (log_a.device == B.device == C.device == x.device):
        raise ValueError("ssd: every operand must be on x's device")
    cfg = launch_config(batch, S, H, P, N, chunk)
    (L,) = cfg["blocks"]
    y = torch.empty((batch, S, H, P), dtype=x.dtype, device=x.device)
    state = None
    if return_state:
        state = torch.empty((batch, H, N, P), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 4)(*x.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_ssd(
            x.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), log_a.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None,
            batch, S, H, P, N, L, cfg["threads"], _DTYPES[x.dtype], stream,
        )
    from ._build import check

    check(err, f"ssd chunk {L} on x {tuple(x.shape)}, N={N}")
    ssd.launches += 1
    ssd.last_launch = cfg
    if return_state:
        return y, state
    return y


ssd.launches = 0
ssd.last_launch = None
