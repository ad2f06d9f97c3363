"""Trace validation (paper §4, Figure 7 "validator").

Mutated traces can leave the support of the probabilistic program: decisions
out of range, splits that no longer multiply to the extent, compute-at
locations invalidated by structural changes, or resource blow-ups (the TPU
analogue of the paper's ``thread_extent`` limits is the VMEM tile
footprint).  Instead of constraining proposals conservatively, the search
proposes freely and this validator rejects out-of-support samples.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .schedule import LoopNode, Schedule
from .tir import PrimFunc
from .trace import Trace

# resource limits (TPU v5e-flavored; CPU measurement uses the same caps)
MAX_ITERATIONS = 1 << 21      # fori_loop trip-count guard (measurement cost)
MAX_TILE_ELEMS = 1 << 17      # joint tile (VREG/VMEM-resident working set)
MAX_VMEM_BYTES = 16 << 20     # staged operand tiles must fit VMEM


@dataclass
class ValidationResult:
    ok: bool
    schedule: Optional[Schedule]
    reason: str = ""
    iterations: int = 0
    tile_elems: int = 0
    vmem_bytes: int = 0


def validate_trace(func: PrimFunc, trace: Trace) -> ValidationResult:
    """Replay ``trace`` on a fresh schedule and check structural limits."""
    sch = Schedule(func, seed=None)
    try:
        trace.replay(sch)
    except Exception as e:  # out of support — any structural failure
        return ValidationResult(False, None, f"replay: {type(e).__name__}: {e}")
    return validate_schedule(sch)


def validate_schedule(sch: Schedule) -> ValidationResult:
    from ..backends.loops import _tile_suffix, estimate_iteration_count

    iters = estimate_iteration_count(sch)
    if iters > MAX_ITERATIONS:
        return ValidationResult(
            False, None, f"iteration count {iters} > {MAX_ITERATIONS}", iters
        )

    # per-block joint tile + VMEM footprint of staged tiles
    max_tile = 1
    vmem = 0

    def walk(nodes, path):
        nonlocal max_tile, vmem
        for n in nodes:
            if isinstance(n, LoopNode):
                walk(n.body, path + [n])
            else:
                tl = _tile_suffix(path, n)
                te = int(np.prod([l.extent for l in tl])) if tl else 1
                max_tile = max(max_tile, te)
                # staged (vmem-scope) buffers count fully; tiles count once
                if n.block.write.scope == "vmem":
                    vmem_local = n.block.write.nbytes
                else:
                    vmem_local = te * 4
                vmem += vmem_local

    walk(sch.root, [])
    if max_tile > MAX_TILE_ELEMS:
        return ValidationResult(
            False, None, f"tile {max_tile} > {MAX_TILE_ELEMS}", iters, max_tile
        )
    if vmem > MAX_VMEM_BYTES:
        return ValidationResult(
            False, None, f"vmem {vmem} > {MAX_VMEM_BYTES}", iters, max_tile, vmem
        )
    return ValidationResult(True, sch, "", iters, max_tile, vmem)


def first_valid_schedule(func: PrimFunc, space, seed_scan: int = 8):
    """The canonical *untuned* schedule of a workload: the first valid
    sample from ``space`` over a fixed seed scan.

    Single source of truth for the default-schedule baseline — the task
    scheduler's warm-start, the dispatch layer's ``mode="default"``
    context, and ``tune_workload``'s ``default_latency_s`` all call this,
    so "untuned" means the same program everywhere.  Returns a Schedule
    or None if the scan produces no valid sample.
    """
    for seed in range(seed_scan):
        v = validate_trace(func, space.generate(func, seed=seed).trace)
        if v.ok:
            return v.schedule
    return None
