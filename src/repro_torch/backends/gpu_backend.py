"""Lower tuned schedules onto the hand-written CUDA kernels.

The port of the JAX package's ``backends/pallas_backend.py``.  The (S2·S3)
spatial tile extents and the R1 reduce tile of the tensorized block become
the (bm, bn, bk) of :mod:`repro_torch.kernels.matmul` (dense and batched);
the (i, j) tiles of an attention schedule's ``scores`` block become the
(block_q, block_kv) of :mod:`repro_torch.kernels.flash_attention`.
Inlined/attached elementwise consumers of a dense become the kernel's fused
epilogue.

The kernels tile exactly, so sampled tile extents are *snapped* to the
nearest divisor of the problem shape at lower time.  Snapping is part of
the lowering's provenance: every ``lower_*`` path returns a meta dict with
both the sampled and the snapped blocks (the same ``pallas_*`` keys the JAX
package records, so ``docs/db_format.md`` reads both packages' records).
A tile the card cannot run (grid, shared memory or thread caps) raises
``ScheduleRejected`` here, which the measurement stack treats as a
rejected candidate; every other failure propagates.

Workloads covered: ``dense_*`` (+fused epilogues), ``batch_matmul`` and
``attention_*`` (prefill).  ``sfm`` and ``attention_decode`` belong to later
slices and raise here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

from ..core.schedule import BlockNode, LoopNode, Schedule, iter_nodes
from ..core.tir import PrimFunc
from ..kernels import ScheduleRejected
from ..kernels.matmul import DEFAULT_BLOCKS

# PrimFunc names this backend can lower natively (dense_* covers every
# epilogue variant; attention_* covers the causal/window/softcap variants)
_LOWERABLE_PREFIXES = ("dense_", "attention_")
_LOWERABLE_NAMES = ("batch_matmul",)
_LATER_SLICES = ("sfm", "attention_decode")


def supports(func: PrimFunc) -> bool:
    """True if this backend has a CUDA lowering for ``func``."""
    if func.name.startswith(_LATER_SLICES):
        return False
    return func.name in _LOWERABLE_NAMES or func.name.startswith(
        _LOWERABLE_PREFIXES
    )


def find_tensorized_block(sch: Schedule) -> Optional[BlockNode]:
    for n in iter_nodes(sch.root):
        if isinstance(n, BlockNode) and n.annotations.get("tensorize") == "mxu":
            return n
    # fall back: first reduce block
    for n in iter_nodes(sch.root):
        if isinstance(n, BlockNode) and n.block.reduce_axes:
            return n
    return None


def _per_axis_tile(sch: Schedule, bn_node: BlockNode) -> Dict[str, int]:
    """Tile extent per block axis (product of tile loops feeding it)."""
    from .loops import _tile_suffix

    blk = bn_node.block
    _, path = sch._find_block(blk.name)
    loops = [n for n in path if isinstance(n, LoopNode)]
    tile = _tile_suffix(loops, bn_node)
    per_axis: Dict[str, int] = {a.name: 1 for a in blk.axes}
    for ln in tile:
        for ax in blk.axes:
            if ln.var in bn_node.bindings[ax.name].vars():
                per_axis[ax.name] *= ln.extent
    return per_axis


def extract_matmul_blocks(sch: Schedule) -> Optional[Tuple[int, int, int]]:
    """(bm, bn, bk) from the tensorized block's tile structure."""
    bn_node = find_tensorized_block(sch)
    if bn_node is None:
        return None
    blk = bn_node.block
    if len(blk.spatial_axes) < 2 or len(blk.reduce_axes) < 1:
        return None
    per_axis = _per_axis_tile(sch, bn_node)
    if all(v == 1 for v in per_axis.values()):
        return None  # schedule carries no tile information
    s_axes = blk.spatial_axes
    r_axes = blk.reduce_axes
    # m = second-to-last spatial, n = last spatial, k = first reduce
    bm = per_axis[s_axes[-2].name]
    bn = per_axis[s_axes[-1].name]
    bk = per_axis[r_axes[0].name]
    return (max(bm, 1), max(bn, 1), max(bk, 1))


def snap_blocks(
    dims: Tuple[int, ...], blocks: Tuple[int, ...]
) -> Tuple[int, ...]:
    """Snap each sampled tile extent to the nearest divisor of its dim
    (the kernels need exact tiling)."""
    from ..kernels.flash_attention import best_divisor

    return tuple(best_divisor(d, b) for d, b in zip(dims, blocks))


# Reject lowerings whose grid would explode: a 1-wide tile on a 128^3
# matmul means 2M tile steps.  Rejection surfaces as a failed build, which
# the search treats as an ordinary candidate rejection.
MAX_GRID_STEPS = 1 << 18


def _check_grid(steps: int, blocks) -> None:
    if steps > MAX_GRID_STEPS:
        raise ScheduleRejected(
            "grid",
            f"grid of {steps} steps (blocks {tuple(blocks)}) exceeds "
            f"cap {MAX_GRID_STEPS}; schedule tiles too fine for this backend"
        )


# ---------------------------------------------------------------------------
# Per-workload lowerings: schedule -> (fn, meta)
# ---------------------------------------------------------------------------


def lower_dense(sch: Schedule) -> Tuple[Callable, Dict[str, Any]]:
    """Tuned dense (+fused epilogue) via the CUDA matmul kernel (K1)."""
    from ..kernels import matmul as mm

    func = sch.func
    sampled = extract_matmul_blocks(sch)
    X, W = func.inputs[0], func.inputs[1]
    M, K = X.shape
    N = W.shape[1]
    blocks = snap_blocks((M, N, K), sampled or DEFAULT_BLOCKS)
    bm, bn, bk = blocks
    _check_grid((M // bm) * (N // bn) * (K // bk), blocks)
    mm.launch_config(1, M, N, K, blocks)  # shared-memory / thread caps
    # epilogue from the ORIGINAL workload name (dense_<epilogue>)
    epilogue = "none"
    if func.name.startswith("dense_"):
        epilogue = func.name[len("dense_"):]
    meta = _block_meta("matmul", sampled, blocks)

    def fn(inputs: Dict):
        out = mm.matmul(
            inputs["X"],
            inputs["W"],
            inputs.get("bias"),
            epilogue=epilogue,
            block_sizes=blocks,
        )
        return {func.outputs[0].name: out}

    return fn, meta


def lower_batch_matmul(sch: Schedule) -> Tuple[Callable, Dict[str, Any]]:
    """Tuned batched matmul via the CUDA bmm kernel (K2, batch on grid z)."""
    from ..kernels import matmul as mm

    func = sch.func
    sampled = extract_matmul_blocks(sch)
    A = func.inputs[0]
    _, M, K = A.shape
    N = func.inputs[1].shape[2]
    B = A.shape[0]
    blocks = snap_blocks((M, N, K), sampled or DEFAULT_BLOCKS)
    bm, bn, bk = blocks
    _check_grid(B * (M // bm) * (N // bn) * (K // bk), blocks)
    mm.launch_config(B, M, N, K, blocks)
    meta = _block_meta("batch_matmul", sampled, blocks)

    def fn(inputs: Dict):
        out = mm.batch_matmul(inputs["A"], inputs["B"], block_sizes=blocks)
        return {func.outputs[0].name: out}

    return fn, meta


DEFAULT_ATTN_BLOCKS = (128, 128)  # pre-tuning fixed flash tiles


def _parse_attention_name(name: str):
    """(causal, window, softcap) from ``attention_c{c}_w{w}[_t{cap}]``."""
    causal, window, softcap = True, None, None
    for part in name.split("_")[1:]:
        if part.startswith("c"):
            causal = bool(int(part[1:]))
        elif part.startswith("w"):
            window = int(part[1:]) or None
        elif part.startswith("t"):
            softcap = float(part[1:])
    return causal, window, softcap


def extract_attention_blocks(sch: Schedule) -> Optional[Tuple[int, int]]:
    """(block_q, block_kv) = the (i, j) tile extents of the scores block."""
    for n in iter_nodes(sch.root):
        if isinstance(n, BlockNode) and n.block.name == "scores":
            per_axis = _per_axis_tile(sch, n)
            bq, bkv = per_axis.get("i", 1), per_axis.get("j", 1)
            if bq == 1 and bkv == 1:
                return None  # schedule carries no tile information
            return (bq, bkv)
    return None


def lower_attention(sch: Schedule) -> Tuple[Callable, Dict[str, Any]]:
    """Tuned fused attention via the CUDA flash kernel (K3).

    The schedule's sampled (i, j) tiles of the ``scores`` block become the
    kernel's (block_q, block_kv), snapped to divisors of the sequence
    length — the same sampled-vs-snapped provenance as the matmul tiles.
    """
    from ..kernels import flash_attention as fa

    func = sch.func
    Q = func.inputs[0]
    b, kvh, g, s, d = Q.shape
    causal, window, softcap = _parse_attention_name(func.name)
    sampled = extract_attention_blocks(sch)
    blocks = snap_blocks((s, s), sampled or DEFAULT_ATTN_BLOCKS)
    bq, bkv = blocks
    _check_grid(b * kvh * g * (s // bq) * (s // bkv), blocks)
    fa.launch_config(b, kvh * g, s, d, bq, bkv)
    meta = _block_meta("flash_attention", sampled, blocks)

    def fn(inputs: Dict):
        q = inputs["Q"].reshape(b, kvh * g, s, d).contiguous()
        out = fa.flash_attention(
            q,
            inputs["K"].contiguous(),
            inputs["V"].contiguous(),
            causal=causal,
            window=window,
            softcap=softcap,
            block_q=bq,
            block_kv=bkv,
        )
        return {func.outputs[0].name: out.reshape(b, kvh, g, s, d)}

    return fn, meta


def _block_meta(kernel: str, sampled, snapped) -> Dict[str, Any]:
    meta: Dict[str, Any] = {
        "pallas_kernel": kernel,
        "pallas_blocks_snapped": list(snapped),
    }
    if sampled is not None:
        meta["pallas_blocks_sampled"] = list(sampled)
        if tuple(sampled) != tuple(snapped):
            meta["pallas_blocks_adjusted"] = True
    else:
        meta["pallas_blocks_source"] = "default"
    return meta


def lower_to_cuda(sch: Schedule) -> Tuple[Callable, Dict[str, Any]]:
    """Dispatch a supported schedule to its CUDA lowering.

    Returns ``(fn, meta)`` where ``fn`` is ``callable(dict) -> dict`` and
    ``meta`` records the kernel used plus sampled/snapped tile provenance.
    Raises ``NotImplementedError`` for workloads of later slices and
    ``ScheduleRejected`` for a tile the card cannot run.
    """
    name = sch.func.name
    if name.startswith(_LATER_SLICES):
        raise NotImplementedError(
            f"no CUDA lowering for workload {name!r}: not in this slice"
        )
    if name.startswith("dense_"):
        return lower_dense(sch)
    if name.startswith("attention_"):
        return lower_attention(sch)
    if name == "batch_matmul":
        return lower_batch_matmul(sch)
    raise NotImplementedError(f"no CUDA lowering for workload {name!r}")


def plain(func: PrimFunc) -> Callable[[Dict], Dict]:
    """The workload's plain PyTorch version, ``callable(dict) -> dict``:
    what ``tune_workload`` times as the baseline on the same device."""
    from ..kernels import ref

    out_name = func.outputs[0].name
    name = func.name
    if name.startswith("dense_"):
        epilogue = name[len("dense_"):]
        return lambda ins: {
            out_name: ref.matmul(
                ins["X"], ins["W"], ins.get("bias"), epilogue=epilogue
            )
        }
    if name == "batch_matmul":
        return lambda ins: {out_name: ref.batch_matmul(ins["A"], ins["B"])}
    if name.startswith("attention_") and not name.startswith(_LATER_SLICES):
        causal, window, softcap = _parse_attention_name(name)
        b, kvh, g, s, d = func.inputs[0].shape

        def attn(ins):
            q = ins["Q"].reshape(b, kvh * g, s, d)
            out = ref.flash_attention(
                q, ins["K"], ins["V"], causal=causal, window=window,
                softcap=softcap,
            )
            return {out_name: out.reshape(b, kvh, g, s, d)}

        return attn
    raise NotImplementedError(f"no plain version for workload {name!r}")
