"""Loop-nest rules shared by the validator, the cost-model features and the
GPU backend.

Tile-boundary rule: walking a block's loop chain from the innermost loop
upward, a loop is a *tile dimension* while its kind is ``vectorize`` or
``unroll`` (single-child chain); the first other loop ends the tile.
Everything above it is *iterated*.  These two functions are pure schedule
arithmetic; they carry no lowering and import no array framework.
"""

from __future__ import annotations

from typing import List

from ..core.schedule import BlockNode, LoopNode, Node, Schedule

TILE_KINDS = ("vectorize", "unroll")


def _tile_suffix(path_loops: List[LoopNode], bn: BlockNode) -> List[LoopNode]:
    """Maximal suffix of the enclosing chain with tile kinds + single-child."""
    out: List[LoopNode] = []
    # walk from innermost upward; loops must form a single-child chain
    for i in range(len(path_loops) - 1, -1, -1):
        ln = path_loops[i]
        if ln.kind not in TILE_KINDS:
            break
        if len(ln.body) != 1:
            break
        out.append(ln)
    out.reverse()
    return out


def estimate_iteration_count(sch: Schedule) -> int:
    """Total number of iterated-loop trips the schedule's loop nest runs."""
    total = [0]

    # determine tile loops globally
    tile_vars = set()

    def collect(nodes: List[Node], path: List[LoopNode]):
        for n in nodes:
            if isinstance(n, LoopNode):
                collect(n.body, path + [n])
            else:
                for ln in _tile_suffix(path, n):
                    tile_vars.add(ln.var)

    collect(sch.root, [])

    def count(nodes: List[Node], mult: int):
        for n in nodes:
            if isinstance(n, LoopNode):
                if n.var in tile_vars:
                    count(n.body, mult)
                else:
                    total[0] += mult * n.extent
                    count(n.body, mult * n.extent)

    count(sch.root, 1)
    return max(total[0], 1)
