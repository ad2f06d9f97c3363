"""Loop-structure feature extraction for the learned cost model.

A common set of per-block features in the spirit of the paper ("we leverage
a common set of features that are used in previous works [43]"): loop
extents by kind, tile shapes, arithmetic intensity, access contiguity,
tensorization and fusion flags.  Blocks are pooled with (sum, max) into a
fixed-size program vector.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..core.schedule import BlockNode, LoopNode, Schedule
from ..core.tir import Expr, Load, REDUCE, Select

N_BLOCK_FEATURES = 18


def _log2(x: float) -> float:
    return math.log2(max(float(x), 1.0))


def block_features(sch: Schedule, bn: BlockNode, path: List[LoopNode]) -> np.ndarray:
    """Feature vector of one block in its loop nest (``N_BLOCK_FEATURES``).

    Shape-generic by construction — extents enter as log2 magnitudes, never
    raw dimensions — so vectors pool meaningfully across tasks in a shared
    cost model (cross-task transfer).
    """
    from ..backends.loops import _tile_suffix

    blk = bn.block
    tile_loops = _tile_suffix(path, bn)
    tile_vars = {l.var for l in tile_loops}
    iterated = [l for l in path if l.var not in tile_vars]

    it_serial = it_parallel = 1
    for l in iterated:
        if l.kind in ("parallel", "grid.x", "grid.y", "grid.z"):
            it_parallel *= l.extent
        else:
            it_serial *= l.extent

    # split tile into spatial / reduce by bindings
    r_axis = {a.name for a in blk.reduce_axes}
    tile_s = tile_r = 1
    vec_len = 1
    for l in tile_loops:
        feeds_r = any(
            l.var in bn.bindings[a.name].vars() for a in blk.axes if a.kind == REDUCE
        )
        if feeds_r:
            tile_r *= l.extent
        else:
            tile_s *= l.extent
        if l.kind == "vectorize":
            vec_len *= l.extent

    # loads / contiguity: does the innermost tile loop appear with coef 1 in
    # the last index dim of each load?
    loads: List[Load] = []
    blk.expr.visit(lambda e: loads.append(e) if isinstance(e, Load) else None)
    contig = 0.0
    if loads and tile_loops:
        inner = tile_loops[-1].var
        n_contig = 0
        for ld in loads:
            last = ld.indices[-1].substitute(bn.bindings) if bn.bindings else ld.indices[-1]
            try:
                last = ld.indices[-1].substitute(bn.bindings)
            except Exception:
                last = ld.indices[-1]
            for t in last.terms:
                if t.var == inner and t.coef == 1 and t.div == 1:
                    n_contig += 1
                    break
        contig = n_contig / len(loads)

    has_select = [False]

    def _v(e: Expr):
        if isinstance(e, Select):
            has_select[0] = True

    blk.expr.visit(_v)

    flops = blk.flops()
    bytes_touched = sum(b.nbytes for b in blk.reads()) + blk.write.nbytes
    intensity = flops / max(bytes_touched, 1)

    mxu = 1.0 if bn.annotations.get("tensorize") == "mxu" else 0.0
    unroll_ann = float(bn.annotations.get("unroll_explicit", 0))

    mxu_align = 0.0
    if tile_loops:
        inner_e = tile_loops[-1].extent
        mxu_align = 1.0 if inner_e % 8 == 0 else 0.0

    return np.array(
        [
            _log2(it_serial),
            _log2(it_parallel),
            _log2(tile_s),
            _log2(tile_r),
            _log2(vec_len),
            _log2(tile_s * tile_r),  # joint tile (VMEM working set)
            contig,
            1.0 if bn.attached else 0.0,
            1.0 if blk.reduce_op else 0.0,
            mxu,
            mxu_align,
            _log2(flops),
            _log2(bytes_touched),
            _log2(1 + intensity),
            float(len(loads)),
            1.0 if has_select[0] else 0.0,
            _log2(1 + unroll_ann),
            float(len(iterated)),
        ],
        dtype=np.float32,
    )


def extract_features(sch: Schedule) -> np.ndarray:
    """Program feature vector: (sum, max) pooling over block features."""
    feats: List[np.ndarray] = []

    def walk(nodes, path):
        """Collect block features depth-first, tracking the loop path."""
        for n in nodes:
            if isinstance(n, LoopNode):
                walk(n.body, path + [n])
            else:
                feats.append(block_features(sch, n, path))

    walk(sch.root, [])
    if not feats:
        return np.zeros(2 * N_BLOCK_FEATURES, dtype=np.float32)
    F = np.stack(feats)
    return np.concatenate([F.sum(axis=0), F.max(axis=0)])
