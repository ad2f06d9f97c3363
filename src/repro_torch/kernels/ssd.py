"""K7 ``ssd``: the Mamba-2 chunked SSD scan.

Source: ``csrc/ssd.cu``, CUDA C++ for ``sm_90a``.  It replaces the Pallas
kernel ``ssd`` of the JAX package's ``kernels/ssd.py``.  Two kernels split
the scan at its one sequential step, the pass of the state from chunk to
chunk.  The chunk kernel, grid (head groups, chunks, batch), computes what
needs no earlier chunk: ``cumsum(log_a)``, ``C·Bᵀ`` once for a group of
heads, each head's ``y_intra`` and chunk state, written to f32 scratch.
The pass kernel, grid (slices of P, heads, batch), walks the chunks in
order: ``y = y_intra + exp(cum)·(C·h)`` in x's dtype, then
``h = exp(cum_L)·h + s_c``.  A sequence of one chunk needs no pass: the
chunk kernel writes y and the state itself.  The contractions run on the
tensor cores in 3xTF32.  The chunk length is a runtime argument
(``min(chunk, S)``, so a 48-token prompt runs with chunk 48).
``return_state=True`` also writes the state after the last chunk, the
(batch, H, N, P) f32 handoff from prefill to decode.  The note at the top
of the source says what bounds the kernels on the card.

Beside the wrapper: its plain PyTorch version (``ref.ssd_chunked``, and
the three passes it is made of, ``ref.ssd_chunk_pass``,
``ref.ssd_state_pass`` and ``ref.ssd_inter``), which it runs for CPU
tensors only, and the launch counter ``ssd.launches`` (one a call,
whichever kernels it takes); ``last_launch`` records the latest launch
plan.
"""

from __future__ import annotations

import ctypes

import torch

from . import ScheduleRejected, ref, sm_count

MAX_SMEM_BYTES = 227 * 1024
THREADS = 384  # the chunk kernel's CTA: 12 warps share a chunk's mma tiles
MAX_GROUP = 32  # heads a chunk-kernel CTA may own
MAX_PASS_THREADS = 512  # the pass kernel: a warp for every 16 x 8 of a chunk's y
MAX_STAGES = 4  # chunks a pass-kernel CTA keeps in flight
P_SLICES = (64, 32, 16, 8)
_GRID_YZ_MAX = 65535
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pad16(v: int) -> int:
    return -(-v // 16) * 16


def _round4(v: int) -> int:
    return -(-v // 4) * 4


def _row_pad(elem_bytes: int) -> int:
    """The row pad of B and C in shared memory: 4 floats or 8 bf16."""
    return 4 if elem_bytes == 4 else 8


def chunk_smem_bytes(L: int, N: int, P: int, group: int, elem_bytes: int) -> int:
    """Shared memory of a chunk-kernel CTA, with L, N and P padded to
    multiples of 16 (Lp, Np, Pp) and x, B and C in their own type of
    ``elem_bytes``: C and B (Lp·(Np+pad) each), in f32 B again (Lp·(Np+8)),
    x (Lp·(Pp+8), twice for a group of more than one head); then in f32
    C·Bᵀ and one head's scores (Lp·(Lp+4) each), the group's cum
    (group·Lp) and the decay to the chunk's end (Lp)."""
    Lp, Np, Pp = _pad16(L), _pad16(N), _pad16(P)
    t_elems = 2 * Lp * (Np + _row_pad(elem_bytes)) + (2 if group > 1 else 1) * Lp * (Pp + 8)
    f_elems = ((Lp * (Np + 8) if elem_bytes == 4 else 0) + 2 * Lp * (Lp + 4)
               + group * Lp + Lp)
    return elem_bytes * t_elems + 4 * f_elems


def pass_smem_bytes(L: int, N: int, p_slice: int, stages: int, elem_bytes: int) -> int:
    """Shared memory of a pass-kernel CTA: ``stages`` chunks in flight, each
    its C in its own type (Lp·(Np+pad)), its y_intra and state slices
    (Lp·p_slice and Np·p_slice f32) and its cum (Lp f32); then the state's
    slice (Np rows of ``p_slice`` floats, padded to 8·odd)."""
    Lp, Np = _pad16(L), _pad16(N)
    stage = elem_bytes * Lp * (Np + _row_pad(elem_bytes)) + 4 * (Lp * p_slice
                                                                  + Np * p_slice + Lp)
    hs = p_slice if (p_slice // 8) % 2 else p_slice + 8
    return stages * stage + 4 * Np * hs


def pass_stages(L: int, N: int, p_slice: int, n_chunks: int, elem_bytes: int) -> int:
    """Chunks a pass-kernel CTA keeps in flight: the most, up to
    ``MAX_STAGES`` and the chunk count, that leave room for two CTAs an SM;
    1 when even that does not."""
    for stages in range(min(MAX_STAGES, n_chunks), 1, -1):
        if pass_smem_bytes(L, N, p_slice, stages, elem_bytes) <= MAX_SMEM_BYTES // 2:
            return stages
    return 1


def scratch_floats(batch: int, S: int, H: int, P: int, N: int, L: int) -> int:
    """f32 scratch of a call of more than one chunk: y_intra (batch·S·H·P),
    the chunk states (batch·chunks·H·N·P) and cum (batch·H·S), each rounded
    up to 4 floats; 0 for one chunk."""
    nc = S // L
    if nc == 1:
        return 0
    return (_round4(batch * S * H * P) + _round4(batch * nc * H * N * P)
            + _round4(batch * H * S))


def head_group(batch: int, n_chunks: int, H: int, sms: int) -> int:
    """Heads a chunk-kernel CTA owns: the largest group (at most
    ``MAX_GROUP``) whose grid, batch·chunks·ceil(H/group) CTAs, still fills
    ``sms`` SMs; 1 when even one head a CTA leaves SMs idle.  C·Bᵀ is
    computed once for the group."""
    best = 1
    for g in range(2, min(H, MAX_GROUP) + 1):
        if batch * n_chunks * -(-H // g) >= sms:
            best = g
    return best


def pass_threads(L: int, ps: int) -> int:
    """Threads of a pass-kernel CTA: a warp for every 16 rows of a chunk
    and 8 columns of its slice of P."""
    return 32 * (_pad16(L) // 16) * (ps // 8)


def p_slice(batch: int, H: int, P: int, L: int, sms: int) -> int:
    """Columns of P a pass-kernel CTA owns: the widest of 64, 32, 16 and 8
    that divides P padded to 16, fits the CTA's warps, and still gives
    batch·H·(Pp/slice) >= ``sms`` / 2 CTAs; 8 when none does.  Every CTA
    reads each chunk's C, so wider slices read it fewer times, and a CTA
    of a 16-column slice or wider has 8 warps or more to hide its latency
    (on an H100 at 700 W, 16 columns beat 8 and 32 at mamba2-370m's
    forward, and 32 beat 16 at batch 4: ``PERF.md``)."""
    Pp = _pad16(P)
    for ps in P_SLICES:
        if (Pp % ps == 0 and pass_threads(L, ps) <= MAX_PASS_THREADS
                and 2 * batch * H * (Pp // ps) >= sms):
            return ps
    return 8


def launch_config(batch: int, S: int, H: int, P: int, N: int, chunk: int,
                  sms: int, elem_bytes: int) -> dict:
    """The launch plan of a call with chunk length ``min(chunk, S)`` on a
    card of ``sms`` SMs, x, B and C of ``elem_bytes`` (4 for f32, 2 for
    bf16): the chunk kernel's grid (head groups, chunks, batch), threads,
    shared memory and head group; for more than one chunk the pass kernel's
    grid (P slices, H, batch), threads, shared memory, slice and stages,
    and the f32 scratch between the two.

    Raises ``ScheduleRejected`` for a chunk that does not divide S, one
    that needs more shared memory than a CTA has (every chunk past 144
    rows, so the pass kernel's warps stay within its cap), or a grid past
    the card's limits.
    """
    L = min(chunk, S)
    if L < 1 or S % L:
        raise ScheduleRejected("divide", f"chunk {L} must divide S={S}")
    nc = S // L
    if nc > _GRID_YZ_MAX or batch > _GRID_YZ_MAX:
        raise ScheduleRejected("grid", f"{nc} chunks of batch {batch} exceed the grid")
    group = head_group(batch, nc, H, sms)
    smem = chunk_smem_bytes(L, N, P, group, elem_bytes)
    if smem > MAX_SMEM_BYTES:
        raise ScheduleRejected(
            "shared_memory",
            f"chunk {L} at N={N}, P={P} needs {smem} bytes of shared memory; "
            f"cap {MAX_SMEM_BYTES}",
        )
    cfg = {
        "blocks": (L,),
        "grid": (-(-H // group), nc, batch),
        "threads": THREADS,
        "smem_bytes": smem,
        "head_group": group,
        "kernels": 1,
        "pass_grid": None,
        "pass_threads": 0,
        "pass_smem_bytes": 0,
        "p_slice": 0,
        "stages": 0,
        "scratch_bytes": 0,
    }
    if nc > 1:
        ps = p_slice(batch, H, P, L, sms)
        stages = pass_stages(L, N, ps, nc, elem_bytes)
        pass_smem = pass_smem_bytes(L, N, ps, stages, elem_bytes)
        if pass_smem > MAX_SMEM_BYTES:
            raise ScheduleRejected(
                "shared_memory",
                f"chunk {L} at N={N} needs {pass_smem} bytes of pass-kernel shared "
                f"memory; cap {MAX_SMEM_BYTES}",
            )
        cfg.update(kernels=2, pass_grid=(_pad16(P) // ps, H, batch),
                   pass_threads=pass_threads(L, ps), pass_smem_bytes=pass_smem, p_slice=ps,
                   stages=stages, scratch_bytes=4 * scratch_floats(batch, S, H, P, N, L))
    return cfg


def _lib():
    from ._build import load

    lib = load("ssd")
    if not getattr(lib, "_repro_typed", False):
        Pt, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_ssd.argtypes = [Pt] * 8 + [I] * 9 + [L, L, I, Pt]
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
    cfg = launch_config(batch, S, H, P, N, chunk, sm_count(x.device), x.element_size())
    (L,) = cfg["blocks"]
    y = torch.empty((batch, S, H, P), dtype=x.dtype, device=x.device)
    state = None
    if return_state:
        state = torch.empty((batch, H, N, P), dtype=torch.float32, device=x.device)
    scratch = None
    if cfg["scratch_bytes"]:
        scratch = torch.empty(cfg["scratch_bytes"] // 4, dtype=torch.float32,
                              device=x.device)
    strides = (ctypes.c_longlong * 4)(*x.stride())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().repro_ssd(
            x.data_ptr(), ctypes.cast(strides, ctypes.c_void_p), log_a.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            batch, S, H, P, N, L, cfg["head_group"], cfg["p_slice"], cfg["stages"],
            cfg["smem_bytes"], cfg["pass_smem_bytes"], _DTYPES[x.dtype], stream,
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
