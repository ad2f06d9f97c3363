"""Analytical H100 cost model for scheduled tensor programs.

Scores a schedule without timing it, with a three-term roofline derived
from the schedule structure:

  compute  — FLOPs / (the tensor-core rate if tensorized and aligned,
             else the f32 rate outside the tensor cores),
  memory   — HBM bytes moved (tile traffic incl. re-fetch across the
             iterated reduce dimension — the cost each tile's staging pays),
  total    — max of the two (+ fixed per-grid-step overhead).

The walk and its terms are the JAX package's; the constants are one NVIDIA
H100 SXM's published dense peaks (data sheet): 67 TFLOP/s f32 outside the
tensor cores, 495 TFLOP/s TF32 and 989 TFLOP/s bf16 on them, 3.35 TB/s
HBM3.  They are also the one source of the card's peaks that
``chip_smoke.py`` computes its bounds from.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ..core.schedule import BlockNode, LoopNode, Schedule

# NVIDIA H100 SXM, dense, per card (data sheet)
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12        # TF32 on the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 on the tensor cores
# a product of two f32 operands takes three TF32 products (3xTF32: the
# ``tc`` variants of K1, K2 and K3)
PEAK_3XTF32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_HBM_BYTES = 3.35e12        # bytes/s

# the roofline's rates: a tensorized block runs on the tensor cores in
# 3xTF32 (the kernels keep f32 operands); one whose innermost tile is not a
# multiple of 8 takes K1's ``fma`` variant, at the f32 rate, so its factor
# is that rate over the tensor-core one (67/165); elementwise work is f32
TENSORIZED_FLOPS = PEAK_3XTF32_FLOPS
UNALIGNED_FACTOR = PEAK_F32_FLOPS / PEAK_3XTF32_FLOPS
ELEMENTWISE_FLOPS = PEAK_F32_FLOPS
# seconds a grid step: the data sheet gives no such number, so it is 0
# until it is fitted to launches timed on the card
GRID_STEP_OVERHEAD = 0.0


@dataclass
class RooflineEstimate:
    compute_s: float
    memory_s: float
    overhead_s: float
    dominant: str

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s) + self.overhead_s


def estimate_schedule(sch: Schedule, dtype_bytes: int = 4) -> RooflineEstimate:
    from .loops import _tile_suffix

    compute_s = 0.0
    memory_s = 0.0
    overhead_s = 0.0

    def walk(nodes, path: List[LoopNode]):
        nonlocal compute_s, memory_s, overhead_s
        for n in nodes:
            if isinstance(n, LoopNode):
                walk(n.body, path + [n])
                continue
            bn: BlockNode = n
            blk = bn.block
            tile = _tile_suffix(path, bn)
            tile_vars = {l.var for l in tile}
            n_iter = int(
                np.prod([l.extent for l in path if l.var not in tile_vars] or [1])
            )
            flops = blk.flops()
            tensorized = bn.annotations.get("tensorize") == "mxu"
            aligned = all(l.extent % 8 == 0 for l in tile[-1:]) if tile else False
            rate = (
                TENSORIZED_FLOPS * (1.0 if aligned else UNALIGNED_FACTOR)
                if tensorized
                else ELEMENTWISE_FLOPS
            )
            compute_s += flops / rate
            # memory: every iterated step refetches its operand tiles
            tile_elems = int(np.prod([l.extent for l in tile] or [1]))
            per_step_bytes = dtype_bytes * tile_elems * (len(blk.reads()) + 1)
            memory_s += n_iter * per_step_bytes / PEAK_HBM_BYTES
            overhead_s += n_iter * GRID_STEP_OVERHEAD

    walk(sch.root, [])
    dominant = "compute" if compute_s >= memory_s else "memory"
    return RooflineEstimate(compute_s, memory_s, overhead_s, dominant)


class AnalyticalRunner:
    """Drop-in for the serial ``LocalRunner`` that needs no card:
    ``measure`` returns the roofline estimate instead of a device time.
    An error in the estimate raises (there is no rejection to report)."""

    def __init__(self, dtype_bytes: int = 4):
        self.dtype_bytes = dtype_bytes

    def measure(self, sch: Schedule):
        from ..search.runner import MeasureResult

        return MeasureResult(estimate_schedule(sch, self.dtype_bytes).total_s)

    def baseline(self, func) -> float:
        # ideal roofline: every flop at the 3xTF32 rate, every byte moved once
        flops = func.total_flops()
        byts = sum(b.nbytes for b in func.inputs) + sum(
            b.nbytes for b in func.outputs
        )
        return max(flops / TENSORIZED_FLOPS, byts / PEAK_HBM_BYTES)
