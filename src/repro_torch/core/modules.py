"""Transformation modules (paper §3.2, Figures 4–5).

A transformation module is a named, composable unit of *program analysis +
sampling + stochastic transformation*.  Block modules are applied post-order
over every block of the program (Figure 5's composition algorithm); program
modules run as whole-program post-passes.

The library mirrors the paper's modules, adapted to TPU (DESIGN.md §3):

* ``AutoInline``       — fold elementwise chains into producers/consumers.
* ``MultiLevelTiling`` — SSRSRS tiling with Sample-Tile (Figure 4).
* ``UseMXU``           — the hardware-specific module (the paper's
  Use-Tensor-Core, §6.3): MXU-aligned tiles + systolic tensorize +
  VMEM staging.
* ``RandomComputeLocation`` — Sample-Compute-Location + compute_at
  (Figure 3 step ②).
* ``ParallelizeVectorizeUnroll`` — outer parallelism, vector tails, and
  unroll-depth annotations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence


from .schedule import LoopNode, Schedule
from .tir import REDUCE, SPATIAL, ScheduleError
from .trace import BlockRV, LoopRV
from .schedule import _is_matmul_pattern


class Module:
    """Base transformation module."""

    name: str = "module"
    kind: str = "block"  # block | program

    def applies(self, sch: Schedule, block: BlockRV) -> bool:
        return False

    def apply(self, sch: Schedule, block: BlockRV) -> None:
        raise NotImplementedError

    def apply_program(self, sch: Schedule) -> None:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# AutoInline
# ---------------------------------------------------------------------------


@dataclass
class AutoInline(Module):
    """Inline pure-spatial blocks into their consumers (or producers).

    Matches the paper's fold/inline of elementwise epilogues (§3.2): pad and
    pre-processing blocks are inlined *forward* into consumers; trailing
    elementwise chains are folded *backward* (reverse inline) so that a
    reduction block ends up with a single fused epilogue block at most.
    """

    name: str = "auto_inline"
    into_consumer: bool = True

    def applies(self, sch: Schedule, block: BlockRV) -> bool:
        bn, _ = sch._find_block(block.name)
        blk = bn.block
        if blk.reduce_axes or bn.attached:
            return False
        # output blocks cannot be forward-inlined
        is_output = blk.write.name in {b.name for b in sch.func.outputs}
        if not is_output and sch.get_consumers(block):
            return True
        # trailing elementwise: try reverse inline into elementwise producer
        prods = sch.get_producers(block)
        if len(prods) == 1:
            pn, _ = sch._find_block(prods[0].name)
            if not pn.block.reduce_axes and sch.get_consumers(prods[0]) == [block]:
                return True
        return False

    def apply(self, sch: Schedule, block: BlockRV) -> None:
        bn, _ = sch._find_block(block.name)
        is_output = bn.block.write.name in {b.name for b in sch.func.outputs}
        if not is_output and sch.get_consumers(block):
            try:
                sch.compute_inline(block)
                return
            except ScheduleError:
                pass
        prods = sch.get_producers(block)
        if len(prods) == 1:
            try:
                sch.reverse_compute_inline(block)
            except ScheduleError:
                pass


# ---------------------------------------------------------------------------
# MultiLevelTiling
# ---------------------------------------------------------------------------


@dataclass
class MultiLevelTiling(Module):
    """SSRSRS multi-level tiling with stochastic tile sizes (Figure 4).

    Spatial axes split 4-way, reduce axes 2-way, reordered into
    ``S0 S1 R0 S2 R1 S3`` groups.  The (S2, R1, S3) suffix is marked
    unroll/vectorize so it forms the backend's VMEM-resident tile; S3 is the
    VPU lane (or MXU fragment) dimension.  A single elementwise consumer is
    fused back at the innermost S1 loop (epilogue fusion).
    """

    name: str = "multi_level_tiling"
    structure: str = "SSRSRS"
    max_vector: int = 16
    max_inner_reduce: int = 64
    fuse_epilogue: bool = True
    tensorize: bool = False  # set by UseMXU subclass

    def applies(self, sch: Schedule, block: BlockRV) -> bool:
        bn, _ = sch._find_block(block.name)
        blk = bn.block
        if bn.attached or not blk.reduce_axes:
            return False
        if bn.annotations.get("tensorize"):
            return False  # already handled by a hardware module
        # needs enough arithmetic intensity to be worth tiling
        return _is_matmul_pattern(blk) or len(blk.reduce_axes) >= 1

    def apply(self, sch: Schedule, block: BlockRV) -> None:
        loops = sch.get_loops(block)
        s_loops = [l for l in loops if sch.loop_axis_kind(block, l) == SPATIAL]
        r_loops = [l for l in loops if sch.loop_axis_kind(block, l) == REDUCE]
        if not s_loops or not r_loops:
            return
        n_s = self.structure.count("S")
        n_r = self.structure.count("R")
        s_splits, r_splits = [], []
        for l in s_loops:
            t = sch.sample_perfect_tile(l, n_s, self.max_vector)
            s_splits.append(sch.split(l, t))
        for l in r_loops:
            t = sch.sample_perfect_tile(l, n_r, self.max_inner_reduce)
            r_splits.append(sch.split(l, t))
        # reorder into groups following the structure string
        order: List[LoopRV] = []
        si, ri = 0, 0
        for ch in self.structure:
            if ch == "S":
                order += [s[si] for s in s_splits]
                si += 1
            else:
                order += [r[ri] for r in r_splits]
                ri += 1
        sch.reorder(*order)
        # mark the (S2, R1, S3) suffix as the tile
        for s in s_splits:
            sch.unroll(s[n_s - 2])
        for r in r_splits:
            sch.unroll(r[n_r - 1])
        for s in s_splits:
            sch.vectorize(s[n_s - 1])
        if self.tensorize:
            try:
                sch.tensorize_mxu(block)
            except ScheduleError:
                pass
        if self.fuse_epilogue:
            self._fuse_epilogue(sch, block, s_splits)

    def _fuse_epilogue(self, sch: Schedule, block: BlockRV, s_splits) -> None:
        consumers = sch.get_consumers(block)
        if len(consumers) != 1:
            return
        cons = consumers[0]
        cn, _ = sch._find_block(cons.name)
        if cn.block.reduce_axes or cn.attached:
            return
        attach = s_splits[-1][1]  # innermost S1-group loop
        try:
            sch.reverse_compute_at(cons, attach)
        except ScheduleError:
            return
        ep_loops = sch.get_loops(cons)
        bn, path = sch._find_block(cons.name)
        own = [l for l in ep_loops if l.var.split("#")[0].startswith(cons.name)]
        fresh = [l for l in ep_loops if "@" in l.var]
        if fresh:
            for l in fresh[:-1]:
                sch.unroll(l)
            sch.vectorize(fresh[-1])


# ---------------------------------------------------------------------------
# UseMXU — the hardware-specific module (paper §6.3, Use-Tensor-Core)
# ---------------------------------------------------------------------------


@dataclass
class UseMXU(MultiLevelTiling):
    """Tensorize matmul-pattern blocks onto the 128x128 MXU.

    Compared with generic MultiLevelTiling this module (a) allows large,
    systolic-friendly inner tiles, (b) evaluates the inner fragment as a
    contraction (``jnp.einsum``/``jnp.dot`` → MXU on TPU), and (c) stages
    operands through VMEM scratch (cache_read).  It composes with the
    generic modules exactly like Use-Tensor-Core in Figure 5.
    """

    name: str = "use_mxu"
    max_vector: int = 128
    max_inner_reduce: int = 128
    tensorize: bool = True
    stage_vmem: bool = True

    def applies(self, sch: Schedule, block: BlockRV) -> bool:
        bn, _ = sch._find_block(block.name)
        blk = bn.block
        if bn.attached or bn.annotations.get("tensorize"):
            return False
        return _is_matmul_pattern(blk)

    def apply(self, sch: Schedule, block: BlockRV) -> None:
        if self.stage_vmem:
            # staging through VMEM is itself a stochastic choice: on TPU it
            # pays for reuse, on CPU measurement it is a copy — the search
            # decides (paper §3.1: stochastic transformations, not policy)
            stage = sch.sample_categorical([0, 1], probs=[0.5, 0.5])
            if int(stage) == 1:
                bn, _ = sch._find_block(block.name)
                for buf in bn.block.reads():
                    if buf.scope == "global":
                        try:
                            sch.cache_read(block, buf.name, scope="vmem")
                        except ScheduleError:
                            continue
        super().apply(sch, block)


# ---------------------------------------------------------------------------
# RandomComputeLocation (Figure 3 step 2)
# ---------------------------------------------------------------------------


@dataclass
class RandomComputeLocation(Module):
    """Sample-Compute-Location + compute_at for movable spatial blocks."""

    name: str = "random_compute_location"

    def applies(self, sch: Schedule, block: BlockRV) -> bool:
        bn, _ = sch._find_block(block.name)
        if bn.attached or bn.block.reduce_axes:
            return False
        if bn.block.write.name in {b.name for b in sch.func.outputs}:
            return False
        return len(sch.get_consumers(block)) == 1

    def apply(self, sch: Schedule, block: BlockRV) -> None:
        loc = sch.sample_compute_location(block)
        try:
            sch.compute_at(block, loc)
        except ScheduleError:
            # invalid location: leave at root (recorded decision stays)
            pass


# ---------------------------------------------------------------------------
# ParallelizeVectorizeUnroll (program post-pass)
# ---------------------------------------------------------------------------


@dataclass
class ParallelizeVectorizeUnroll(Module):
    """Outer parallelism + vector tails + sampled unroll depth.

    * Root tiled blocks: fuse the outer spatial (S0) group and mark it
      ``parallel`` (multi-core CPU / Pallas grid dimension).
    * Untouched elementwise root blocks: fuse all spatial loops, split a
      sampled vector lane off the inside, parallelize the rest.
    * Every root block samples an unroll-depth annotation from
      {0, 16, 64, 512} (paper A.3 ``unroll_explicit``).
    """

    name: str = "parallelize_vectorize_unroll"
    kind: str = "program"
    max_parallel_loops: int = 2
    vector_lanes: Sequence[int] = (4, 8, 16, 32)

    def apply_program(self, sch: Schedule) -> None:
        for block in list(sch.get_blocks()):
            bn, path = sch._find_block(block.name)
            if bn.attached:
                continue
            loops = [n for n in path if isinstance(n, LoopNode)]
            if not loops:
                continue
            tiled = any(n.kind in ("vectorize", "unroll") for n in loops)
            if tiled:
                # parallelize the outermost consecutive serial spatial loops
                outer = []
                for ln in loops:
                    if (
                        ln.kind == "serial"
                        and sch.loop_axis_kind(block, LoopRV(ln.var)) == SPATIAL
                        and len(outer) < self.max_parallel_loops
                    ):
                        outer.append(LoopRV(ln.var))
                    else:
                        break
                try:
                    if len(outer) >= 2:
                        fused = sch.fuse(*outer)
                        sch.parallel(fused)
                    elif len(outer) == 1:
                        sch.parallel(outer[0])
                except ScheduleError:
                    pass
            else:
                # plain elementwise block: split a vector lane off the
                # innermost spatial loop FIRST, then fuse + parallelize the
                # outers (fused vars cannot be re-split: div/mod bindings)
                s_loops = [
                    LoopRV(n.var)
                    for n in loops
                    if sch.loop_axis_kind(block, LoopRV(n.var)) == SPATIAL
                    and n.kind == "serial"
                ]
                if not s_loops:
                    continue
                inner_extent = sch.loop_info(s_loops[-1]).extent
                lanes = [v for v in self.vector_lanes if inner_extent % v == 0]
                outers = list(s_loops[:-1])
                if lanes:
                    lane = sch.sample_categorical(lanes)
                    out, inner = sch.split(
                        s_loops[-1], [inner_extent // int(lane), int(lane)]
                    )
                    sch.vectorize(inner)
                    outers.append(out)
                else:
                    outers.append(s_loops[-1])
                try:
                    fused = sch.fuse(*outers) if len(outers) > 1 else outers[0]
                    sch.parallel(fused)
                except ScheduleError:
                    pass
            unroll = sch.sample_categorical([0, 16, 64, 512])
            sch.annotate(block, "unroll_explicit", unroll)


# ---------------------------------------------------------------------------
# Space generator: post-order module composition (Figure 5)
# ---------------------------------------------------------------------------


def default_modules(use_mxu: bool = False) -> List[Module]:
    mods: List[Module] = [AutoInline()]
    if use_mxu:
        mods.append(UseMXU())
    mods += [
        MultiLevelTiling(),
        RandomComputeLocation(),
        ParallelizeVectorizeUnroll(),
    ]
    return mods


class SpaceGenerator:
    """Composes transformation modules into a search-space sampler.

    ``generate()`` draws one random program from the space: block modules
    are applied post-order (consumers first — reverse dataflow order) to
    every block they match, then program modules run as post-passes.  The
    resulting Schedule carries the full trace, which IS the sample.
    """

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)

    def generate(self, func, seed: Optional[int] = None) -> Schedule:
        sch = Schedule(func, seed=seed)
        for mod in self.modules:
            if mod.kind != "block":
                continue
            # post-order: last block first (consumers before producers)
            for rv in reversed(list(sch.get_blocks())):
                try:
                    bn, _ = sch._find_block(rv.name)
                except ScheduleError:
                    continue  # removed by a previous module (e.g. inlined)
                if mod.applies(sch, rv):
                    mod.apply(sch, rv)
        for mod in self.modules:
            if mod.kind == "program":
                mod.apply_program(sch)
        return sch
