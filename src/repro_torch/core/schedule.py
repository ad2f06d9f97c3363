"""The MetaSchedule probabilistic schedule language.

A :class:`Schedule` wraps a :class:`~repro_torch.core.tir.PrimFunc` with a mutable
*loop tree* (the scheduled program state) and exposes the paper's
transformation primitives (Table 2) plus the three sampling instructions
(``sample_perfect_tile`` / ``sample_categorical`` / ``sample_compute_location``).

Every primitive call is recorded into an execution :class:`~repro_torch.core.trace.Trace`
(§4, Fig 6): sampling instructions record their *decision* so the trace can be
replayed, serialized, and mutated by the evolutionary search.

Random variables are handles: :class:`BlockRV` (resolved by block name),
:class:`LoopRV` (resolved by loop var, which survives ``reorder``) and
:class:`ExprRV` (concrete ints produced by sampling).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .tir import (
    Axis,
    Block,
    Buffer,
    Expr,
    LinExpr,
    Load,
    PrimFunc,
    SPATIAL,
    ScheduleError,
    Select,
    Term,
    UnOp,
)
from .trace import BlockRV, ExprRV, Instruction, LoopRV, Trace, new_expr_rv

RVLike = Union[BlockRV, LoopRV, ExprRV, int, str, None]


def _int(x: Union[ExprRV, int]) -> int:
    return int(x)


# ---------------------------------------------------------------------------
# Loop tree
# ---------------------------------------------------------------------------

LOOP_KINDS = (
    "serial",
    "parallel",
    "vectorize",
    "unroll",
    "grid.x",
    "grid.y",
    "grid.z",
)


@dataclass
class LoopNode:
    var: str
    extent: int
    kind: str = "serial"
    annotations: Dict[str, Any] = field(default_factory=dict)
    body: List["Node"] = field(default_factory=list)

    def __repr__(self):
        return f"Loop({self.var}:{self.extent}:{self.kind})"


@dataclass
class BlockNode:
    block: Block
    bindings: Dict[str, LinExpr]  # axis name -> expr over loop vars
    annotations: Dict[str, Any] = field(default_factory=dict)
    # compute_at bookkeeping: offsets added to write region (see backend)
    attached: bool = False

    def __repr__(self):
        return f"BlockNode({self.block.name})"


Node = Union[LoopNode, BlockNode]


def iter_nodes(nodes: List[Node]):
    for n in nodes:
        yield n
        if isinstance(n, LoopNode):
            yield from iter_nodes(n.body)


# ---------------------------------------------------------------------------
# Schedule
# ---------------------------------------------------------------------------


class Schedule:
    """Mutable scheduled-program state + trace recorder."""

    def __init__(self, func: PrimFunc, seed: Optional[int] = None, trace: Optional[Trace] = None):
        self.func = func
        self.rng = np.random.default_rng(seed)
        self.trace = trace if trace is not None else Trace()
        self.root: List[Node] = []
        self._var_counter = 0
        self._buf_counter = 0
        self._blocks: Dict[str, Block] = {}
        for blk in func.blocks:
            self._add_root_block(blk)

    # -- construction -------------------------------------------------------

    def _fresh_var(self, hint: str) -> str:
        self._var_counter += 1
        return f"{hint}#{self._var_counter}"

    def _fresh_buf(self, hint: str) -> str:
        self._buf_counter += 1
        return f"{hint}${self._buf_counter}"

    def _add_root_block(self, blk: Block) -> None:
        self._blocks[blk.name] = blk
        bindings: Dict[str, LinExpr] = {}
        chain: Optional[LoopNode] = None
        outer: Optional[LoopNode] = None
        for ax in blk.axes:
            v = self._fresh_var(f"{blk.name}.{ax.name}")
            ln = LoopNode(var=v, extent=ax.extent)
            bindings[ax.name] = LinExpr.var(v)
            if chain is None:
                outer = ln
            else:
                chain.body.append(ln)
            chain = ln
        bn = BlockNode(block=blk, bindings=bindings)
        if chain is None:
            self.root.append(bn)
        else:
            chain.body.append(bn)
            self.root.append(outer)

    def copy(self) -> "Schedule":
        """Replay-based copy (state is reconstructed from the trace)."""
        new = Schedule(self.func, seed=None, trace=Trace())
        self.trace.replay(new)
        return new

    # -- tree lookup --------------------------------------------------------

    def _find_loop(self, var: str) -> Tuple[LoopNode, List[Node]]:
        """Return (node, path) where path is the list of ancestor nodes."""

        def rec(nodes: List[Node], path: List[Node]):
            for n in nodes:
                if isinstance(n, LoopNode):
                    if n.var == var:
                        return n, path
                    r = rec(n.body, path + [n])
                    if r:
                        return r
            return None

        r = rec(self.root, [])
        if not r:
            raise ScheduleError(f"loop {var} not found")
        return r

    def _find_block(self, name: str) -> Tuple[BlockNode, List[Node]]:
        def rec(nodes: List[Node], path: List[Node]):
            for n in nodes:
                if isinstance(n, BlockNode) and n.block.name == name:
                    return n, path
                if isinstance(n, LoopNode):
                    r = rec(n.body, path + [n])
                    if r:
                        return r
            return None

        r = rec(self.root, [])
        if not r:
            raise ScheduleError(f"block {name} not found")
        return r

    def _parent_body(self, path: List[Node]) -> List[Node]:
        return path[-1].body if path else self.root

    def _loop_extents(self) -> Dict[str, int]:
        return {
            n.var: n.extent for n in iter_nodes(self.root) if isinstance(n, LoopNode)
        }

    # -- introspection primitives -------------------------------------------

    def get_block(self, name: str) -> BlockRV:
        self._find_block(name)
        rv = BlockRV(name)
        self._record("get_block", [], {"name": name}, [rv])
        return rv

    def get_blocks(self) -> List[BlockRV]:
        """All blocks in tree (execution) order — not traced (pure query)."""
        return [
            BlockRV(n.block.name)
            for n in iter_nodes(self.root)
            if isinstance(n, BlockNode)
        ]

    def get_loops(self, block: BlockRV) -> List[LoopRV]:
        _, path = self._find_block(block.name)
        rvs = [LoopRV(n.var) for n in path if isinstance(n, LoopNode)]
        self._record("get_loops", [block], {}, rvs)
        return rvs

    def get_producers(self, block: BlockRV) -> List[BlockRV]:
        blk = self._blocks[block.name]
        reads = {b.name for b in blk.reads()}
        out = []
        for n in iter_nodes(self.root):
            if isinstance(n, BlockNode) and n.block.write.name in reads:
                out.append(BlockRV(n.block.name))
        return out

    def get_consumers(self, block: BlockRV) -> List[BlockRV]:
        w = self._blocks[block.name].write.name
        out = []
        for n in iter_nodes(self.root):
            if isinstance(n, BlockNode) and w in {b.name for b in n.block.reads()}:
                out.append(BlockRV(n.block.name))
        return out

    def loop_info(self, loop: LoopRV) -> LoopNode:
        node, _ = self._find_loop(loop.var)
        return node

    def block_info(self, block: BlockRV) -> BlockNode:
        node, _ = self._find_block(block.name)
        return node

    def loop_axis_kind(self, block: BlockRV, loop: LoopRV) -> str:
        """Which axis kind (S/R) a loop var feeds in a block's bindings."""
        bn, _ = self._find_block(block.name)
        blk = bn.block
        kinds = set()
        for ax in blk.axes:
            e = bn.bindings[ax.name]
            if loop.var in e.vars():
                kinds.add(ax.kind)
        if not kinds:
            return "none"
        if len(kinds) > 1:
            return "mixed"
        return kinds.pop()

    # -- trace plumbing -----------------------------------------------------

    def _record(self, name, inputs, attrs, outputs, decision=None):
        self.trace.append(Instruction(name, inputs, attrs, outputs, decision))

    # =======================================================================
    # Sampling instructions (the probabilistic part)
    # =======================================================================

    def sample_perfect_tile(
        self,
        loop: LoopRV,
        n: int,
        max_innermost_factor: int = 16,
        decision: Optional[List[int]] = None,
    ) -> List[ExprRV]:
        node, _ = self._find_loop(loop.var)
        if decision is None:
            decision = _sample_perfect_tile(
                self.rng, node.extent, n, max_innermost_factor
            )
        if int(np.prod(decision)) != node.extent:
            raise ScheduleError(
                f"perfect tile {decision} does not multiply to {node.extent}"
            )
        if decision[-1] > max_innermost_factor:
            raise ScheduleError(
                f"innermost factor {decision[-1]} > max {max_innermost_factor}"
            )
        rvs = [new_expr_rv(int(f)) for f in decision]
        self._record(
            "sample_perfect_tile",
            [loop],
            {"n": n, "max_innermost_factor": max_innermost_factor},
            rvs,
            decision=list(map(int, decision)),
        )
        return rvs

    def sample_categorical(
        self,
        candidates: Sequence[int],
        probs: Optional[Sequence[float]] = None,
        decision: Optional[int] = None,
    ) -> ExprRV:
        if probs is None:
            probs = [1.0 / len(candidates)] * len(candidates)
        if decision is None:
            decision = int(self.rng.choice(len(candidates), p=np.asarray(probs) / np.sum(probs)))
        if not 0 <= decision < len(candidates):
            raise ScheduleError(f"categorical decision {decision} out of range")
        rv = new_expr_rv(int(candidates[decision]))
        self._record(
            "sample_categorical",
            [],
            {"candidates": list(candidates), "probs": list(probs)},
            [rv],
            decision=int(decision),
        )
        return rv

    def sample_compute_location(
        self, block: BlockRV, decision: Optional[int] = None
    ) -> LoopRV:
        """Sample a compute-at location for ``block`` among its consumer's
        loops.  Encoding: -2 = inline, -1 = stay at root, k >= 0 = index into
        the candidate loop list of the (sole) consumer.  Returns a LoopRV
        (possibly the ROOT/INLINE sentinel) that ``compute_at`` consumes, so
        mutated decisions replay through the same instruction sequence.

        The candidate distribution depends on the *current* program state —
        this is the long-range structural dependency of §3.1.
        """
        candidates = self.compute_location_candidates(block)
        n_opts = len(candidates) + 2
        if decision is None:
            decision = int(self.rng.integers(0, n_opts)) - 2
        if not -2 <= decision < len(candidates):
            raise ScheduleError(f"compute location {decision} out of range")
        if decision == -2:
            rv = LoopRV(self._fresh_var("__inline__"))
        elif decision == -1:
            rv = LoopRV(self._fresh_var("__root__"))
        else:
            rv = candidates[decision]
        self._record(
            "sample_compute_location", [block], {}, [rv], decision=int(decision)
        )
        return rv

    def compute_location_candidates(self, block: BlockRV) -> List[LoopRV]:
        """Valid compute_at target loops, conditioned on current state."""
        consumers = self.get_consumers(block)
        if len(consumers) != 1:
            return []
        cons = consumers[0]
        cn, cpath = self._find_block(cons.name)
        out: List[LoopRV] = []
        loops = [n for n in cpath if isinstance(n, LoopNode)]
        for ln in loops:
            try:
                self._check_compute_at(block.name, ln.var)
                out.append(LoopRV(ln.var))
            except ScheduleError:
                continue
        return out

    # =======================================================================
    # Loop transformations
    # =======================================================================

    def split(
        self, loop: LoopRV, factors: Sequence[Union[ExprRV, int]]
    ) -> List[LoopRV]:
        fs = [_int(f) for f in factors]
        node, path = self._find_loop(loop.var)
        if int(np.prod(fs)) != node.extent:
            raise ScheduleError(
                f"split factors {fs} do not multiply to extent {node.extent}"
            )
        new_vars = [self._fresh_var(loop.var.split("#")[0]) for _ in fs]
        # strides: var = sum(v_i * prod(fs[i+1:]))
        expr = LinExpr.const_(0)
        for i, v in enumerate(new_vars):
            stride = int(np.prod(fs[i + 1:])) if i + 1 < len(fs) else 1
            expr = expr + LinExpr.var(v) * stride
        # build nested loops, innermost inherits body and kind
        inner_body = node.body
        nodes = [
            LoopNode(var=v, extent=f, kind="serial") for v, f in zip(new_vars, fs)
        ]
        for a, b in zip(nodes[:-1], nodes[1:]):
            a.body = [b]
        nodes[-1].body = inner_body
        nodes[-1].kind = node.kind if node.kind in ("serial",) else "serial"
        # replace in parent
        parent_body = self._parent_body(path)
        parent_body[parent_body.index(node)] = nodes[0]
        # substitute var in all bindings below
        self._substitute_var(nodes[-1].body, loop.var, expr)
        rvs = [LoopRV(v) for v in new_vars]
        self._record("split", [loop] + list(factors), {}, rvs)
        return rvs

    def fuse(self, *loops: LoopRV) -> LoopRV:
        if len(loops) < 2:
            raise ScheduleError("fuse needs >= 2 loops")
        # verify perfect chain: each next loop is the sole child of previous
        nodes = []
        node, path = self._find_loop(loops[0].var)
        nodes.append((node, path))
        for lv in loops[1:]:
            prev = nodes[-1][0]
            if len(prev.body) != 1 or not isinstance(prev.body[0], LoopNode):
                raise ScheduleError(f"fuse: {prev.var} does not solely contain next loop")
            child = prev.body[0]
            if child.var != lv.var:
                raise ScheduleError(f"fuse: expected {lv.var}, found {child.var}")
            nodes.append((child, nodes[-1][1] + [prev]))
        fused_var = self._fresh_var("fused")
        extents = [n.extent for n, _ in nodes]
        total = int(np.prod(extents))
        innermost = nodes[-1][0]
        fused = LoopNode(var=fused_var, extent=total, body=innermost.body)
        head, head_path = nodes[0]
        parent_body = self._parent_body(head_path)
        parent_body[parent_body.index(head)] = fused
        # substitute: loop_i = (fused // prod(extents[i+1:])) % extents[i]
        for i, (n, _) in enumerate(nodes):
            div = int(np.prod(extents[i + 1:])) if i + 1 < len(nodes) else 1
            mod = n.extent if i > 0 else None  # outermost needs no mod
            rep = LinExpr([Term(fused_var, 1, div, mod)], 0)
            self._substitute_var_expr(fused.body, n.var, rep)
        rv = LoopRV(fused_var)
        self._record("fuse", list(loops), {}, [rv])
        return rv

    def reorder(self, *loops: LoopRV) -> None:
        """Permute loops that live on a single perfectly-nested chain."""
        if len(loops) < 2:
            return
        targets = [lv.var for lv in loops]
        # find path to each target; they must share one root-path
        paths = {}
        for t in targets:
            node, path = self._find_loop(t)
            paths[t] = [p for p in path if isinstance(p, LoopNode)] + [node]
        # the chain = the longest path; all targets must lie on it
        longest = max(paths.values(), key=len)
        chain_vars = [n.var for n in longest]
        for t in targets:
            if t not in chain_vars:
                raise ScheduleError(f"reorder: {t} not on a single loop chain")
        # indices of targets within the chain
        idxs = sorted(chain_vars.index(t) for t in targets)
        span = longest[idxs[0]: idxs[-1] + 1]
        # verify the span is perfectly nested (each node's sole loop child)
        for a, b in zip(span[:-1], span[1:]):
            loop_children = [c for c in a.body if isinstance(c, LoopNode)]
            if len(a.body) != 1 or len(loop_children) != 1 or loop_children[0] is not b:
                raise ScheduleError(
                    f"reorder: {a.var} -> {b.var} not perfectly nested"
                )
        # permute (var, extent, kind, annotations) across target positions
        positions = [i for i, n in enumerate(span) if n.var in targets]
        payload = {n.var: (n.var, n.extent, n.kind, n.annotations) for n in span}
        order = list(targets)  # desired outer->inner order of the targets
        for pos, tvar in zip(positions, order):
            v, e, k, ann = payload[tvar]
            span[pos].var, span[pos].extent, span[pos].kind, span[pos].annotations = (
                v,
                e,
                k,
                ann,
            )
        self._record("reorder", list(loops), {}, [])

    def _set_kind(self, loop: LoopRV, kind: str):
        node, _ = self._find_loop(loop.var)
        node.kind = kind

    def parallel(self, loop: LoopRV) -> None:
        self._set_kind(loop, "parallel")
        self._record("parallel", [loop], {}, [])

    def vectorize(self, loop: LoopRV) -> None:
        node, _ = self._find_loop(loop.var)
        node.kind = "vectorize"
        self._record("vectorize", [loop], {}, [])

    def unroll(self, loop: LoopRV) -> None:
        self._set_kind(loop, "unroll")
        self._record("unroll", [loop], {}, [])

    def bind(self, loop: LoopRV, thread: str) -> None:
        if thread not in ("grid.x", "grid.y", "grid.z"):
            raise ScheduleError(f"bind target {thread} unsupported (TPU grid only)")
        self._set_kind(loop, thread)
        self._record("bind", [loop], {"thread": thread}, [])

    def add_unit_loop(self, block: BlockRV) -> LoopRV:
        """Wrap the block node itself in a new extent-1 loop."""
        bn, path = self._find_block(block.name)
        v = self._fresh_var("unit")
        parent_body = self._parent_body(path)
        ln = LoopNode(var=v, extent=1, body=[bn])
        parent_body[parent_body.index(bn)] = ln
        rv = LoopRV(v)
        self._record("add_unit_loop", [block], {}, [rv])
        return rv

    # =======================================================================
    # Block transformations
    # =======================================================================

    def compute_inline(self, block: BlockRV) -> None:
        """Inline an elementwise producer block into all consumers."""
        self._compute_inline_impl(block)
        self._record("compute_inline", [block], {}, [])

    def _compute_inline_impl(self, block: BlockRV) -> None:
        bn, path = self._find_block(block.name)
        blk = bn.block
        if blk.reduce_axes:
            raise ScheduleError(f"cannot inline reduction block {blk.name}")
        # write indices must be plain distinct axis vars
        wvars = []
        for e in blk.write_indices:
            v = e.single_var
            if v is None:
                raise ScheduleError(f"inline: write index {e} not a plain var")
            wvars.append(v)
        if len(set(wvars)) != len(wvars):
            raise ScheduleError("inline: write indices not injective")
        consumers = self.get_consumers(block)
        if not consumers:
            raise ScheduleError(f"inline: {blk.name} has no consumer")
        for cons in consumers:
            cn, _ = self._find_block(cons.name)
            new_expr = _substitute_loads(cn.block.expr, blk, wvars)
            self._replace_block(cn, new_expr)
        # remove producer subtree
        self._remove_block_subtree(block.name)

    def reverse_compute_inline(self, block: BlockRV) -> None:
        """Inline an elementwise *consumer* into its sole producer.

        Valid only when the producer is itself spatial (no reduction) —
        epilogues of reductions must use (reverse_)compute_at instead.
        """
        bn, _ = self._find_block(block.name)
        cblk = bn.block
        if cblk.reduce_axes:
            raise ScheduleError("reverse inline: consumer must be elementwise")
        producers = self.get_producers(block)
        if len(producers) != 1:
            raise ScheduleError("reverse inline: need exactly one producer")
        pn, _ = self._find_block(producers[0].name)
        pblk = pn.block
        if pblk.reduce_axes:
            raise ScheduleError(
                "reverse inline into reduction block is illegal; use reverse_compute_at"
            )
        if self.get_consumers(producers[0]) != [block]:
            raise ScheduleError("reverse inline: producer has other consumers")
        # consumer must read producer output with plain injective indices
        pw = pblk.write.name
        wvars = [e.single_var for e in pblk.write_indices]
        if any(v is None for v in wvars):
            raise ScheduleError("reverse inline: producer write indices not plain")
        # map: replace loads of pw in consumer expr with producer expr
        def sub(ld: Load) -> Expr:
            if ld.buffer.name != pw:
                return ld
            mapping = {wv: idx for wv, idx in zip(wvars, ld.indices)}
            return _substitute_expr_axes(pblk.expr, mapping)

        new_expr = cblk.expr.map_loads(sub)
        # new block: consumer's domain/write, fused expr, placed at producer site
        self._replace_block(bn, new_expr)
        self._remove_block_subtree(pblk.name)
        self._record("reverse_compute_inline", [block], {}, [])

    def _replace_block(self, bn: BlockNode, new_expr: Expr) -> None:
        old = bn.block
        newb = Block(
            name=old.name,
            axes=old.axes,
            expr=new_expr,
            write=old.write,
            write_indices=old.write_indices,
            reduce_op=old.reduce_op,
            init=old.init,
        )
        bn.block = newb
        self._blocks[old.name] = newb

    def _remove_block_subtree(self, name: str) -> None:
        bn, path = self._find_block(name)
        # remove the whole exclusive loop chain above the block
        # find highest ancestor loop that contains ONLY this block's chain
        chain = [n for n in path if isinstance(n, LoopNode)]
        target: Node = bn
        for ln in reversed(chain):
            if len(ln.body) == 1:
                target = ln
            else:
                break
        # locate parent of target
        def rec(nodes: List[Node]) -> bool:
            if target in nodes:
                nodes.remove(target)
                return True
            for n in nodes:
                if isinstance(n, LoopNode) and rec(n.body):
                    return True
            return False

        rec(self.root)
        del self._blocks[name]

    # -- compute_at / reverse_compute_at -------------------------------------

    def _check_compute_at(self, producer: str, loop_var: str) -> Tuple:
        """Validate + compute region mapping for compute_at."""
        pn, ppath = self._find_block(producer)
        pblk = pn.block
        # producer must be a root block (not already attached)
        if pn.attached:
            raise ScheduleError(f"{producer} already attached")
        consumers = self.get_consumers(BlockRV(producer))
        if len(consumers) != 1:
            raise ScheduleError(f"{producer} needs exactly one consumer")
        cons = consumers[0]
        cn, cpath = self._find_block(cons.name)
        loop_node, lpath = self._find_loop(loop_var)
        # loop must be an ancestor of the consumer
        cloops = [n for n in cpath if isinstance(n, LoopNode)]
        if loop_node not in cloops:
            raise ScheduleError(f"loop {loop_var} does not enclose consumer")
        # producer write indices must be plain distinct vars
        wvars = [e.single_var for e in pblk.write_indices]
        if any(v is None for v in wvars) or len(set(wvars)) != len(wvars):
            raise ScheduleError("compute_at: producer write indices must be plain vars")
        # region of producer output read by the consumer per iteration of loop:
        # vars of loops at-or-above `loop` are fixed; below vary over extents
        li = cloops.index(loop_node)
        fixed_vars = {n.var for n in cloops[: li + 1]}
        varying = {n.var: n.extent for n in cloops[li + 1:]}
        reads = [
            ld
            for ld in _collect_loads(cn.block.expr)
            if ld.buffer.name == pblk.write.name
        ]
        if not reads:
            raise ScheduleError("compute_at: consumer does not read producer")
        # compute per-dim (offset_expr, size) box over all reads
        boxes = []
        for dim in range(len(pblk.write.shape)):
            offs, sizes = [], []
            for ld in reads:
                idx = ld.indices[dim]
                # bind consumer axes -> loop exprs
                bound = idx.substitute(cn.bindings)
                # split into fixed part (expr of fixed vars) + varying span
                fixed_terms = [t for t in bound.terms if t.var in fixed_vars]
                var_terms = [t for t in bound.terms if t.var not in fixed_vars]
                for t in var_terms:
                    if t.var not in varying:
                        raise ScheduleError(
                            f"compute_at: index var {t.var} not under loop"
                        )
                lo_v, hi_v = LinExpr(var_terms, 0).bounds(varying)
                offs.append(LinExpr(fixed_terms, bound.const + lo_v))
                sizes.append(hi_v - lo_v + 1)
            # all reads must agree on a single box (offset expr + size)
            base = offs[0]
            size = max(sizes)
            for o in offs[1:]:
                if o != base:
                    raise ScheduleError("compute_at: reads disagree on region offset")
            boxes.append((base, size))
        return pn, ppath, cn, cpath, loop_node, boxes, wvars

    def compute_at(self, block: BlockRV, loop: LoopRV) -> None:
        """Move producer block under ``loop`` of its consumer, computing only
        the region the consumer tile needs (Sample-Compute-Location target).

        ``loop`` may be the ROOT sentinel (no-op) or INLINE sentinel
        (performs compute_inline) so that mutated compute-location decisions
        replay through this same instruction.
        """
        if loop.var.startswith("__root__"):
            self._record("compute_at", [block, loop], {}, [])
            return
        if loop.var.startswith("__inline__"):
            # record as compute_at so the trace stays positionally stable
            self._compute_inline_impl(block)
            self._record("compute_at", [block, loop], {}, [])
            return
        pn, ppath, cn, cpath, loop_node, boxes, wvars = self._check_compute_at(
            block.name, loop.var
        )
        pblk = pn.block
        # build fresh loops sized by the region box + reduce loops in full
        dim_of_axis = {v: d for d, v in enumerate(wvars)}
        new_bindings: Dict[str, LinExpr] = {}
        loops_new: List[LoopNode] = []
        for ax in pblk.axes:
            if ax.kind == SPATIAL and ax.name in dim_of_axis:
                off, size = boxes[dim_of_axis[ax.name]]
                v = self._fresh_var(f"{pblk.name}.{ax.name}@")
                loops_new.append(LoopNode(var=v, extent=size))
                new_bindings[ax.name] = off + LinExpr.var(v)
            else:  # reduce axes (or spatial not in write: impossible by check)
                v = self._fresh_var(f"{pblk.name}.{ax.name}@")
                loops_new.append(LoopNode(var=v, extent=ax.extent))
                new_bindings[ax.name] = LinExpr.var(v)
        # remove old subtree, then insert under loop before consumer subtree
        self._remove_block_subtree_keep(pblk.name)
        new_bn = BlockNode(block=pblk, bindings=new_bindings, attached=True)
        self._blocks[pblk.name] = pblk
        chain: Optional[LoopNode] = None
        head: Node = new_bn
        for ln in reversed(loops_new):
            ln.body = [head]
            head = ln
        # insert as first child of loop_node (before the consumer's nest)
        loop_node.body.insert(0, head)
        self._record("compute_at", [block, loop], {}, [])

    def reverse_compute_at(self, block: BlockRV, loop: LoopRV) -> None:
        """Move *consumer* block under ``loop`` of its producer (epilogue fusion).

        Legal when every reduce loop of the producer is strictly below ``loop``
        so the producer tile is complete when the consumer runs.
        """
        cn, cpath = self._find_block(block.name)
        cblk = cn.block
        if cblk.reduce_axes:
            raise ScheduleError("reverse_compute_at: consumer must be spatial")
        producers = self.get_producers(block)
        if len(producers) != 1:
            raise ScheduleError("reverse_compute_at: need exactly one producer")
        pn, ppath = self._find_block(producers[0].name)
        pblk = pn.block
        loop_node, lpath = self._find_loop(loop.var)
        ploops = [n for n in ppath if isinstance(n, LoopNode)]
        if loop_node not in ploops:
            raise ScheduleError("loop does not enclose producer")
        li = ploops.index(loop_node)
        below = ploops[li + 1:]
        # all reduce-feeding loops of producer must be below `loop`
        r_axes = {a.name for a in pblk.reduce_axes}
        below_vars = {n.var for n in below}
        for ax in pblk.axes:
            if ax.name in r_axes:
                for v in pn.bindings[ax.name].vars():
                    if v not in below_vars:
                        raise ScheduleError(
                            "reverse_compute_at: reduction not complete at loop"
                        )
        # region of producer WRITE completed per iteration of `loop`
        fixed_vars = {n.var for n in ploops[: li + 1]}
        varying = {n.var: n.extent for n in below}
        boxes = []
        for dim, widx in enumerate(pblk.write_indices):
            bound = widx.substitute(pn.bindings)
            fixed_terms = [t for t in bound.terms if t.var in fixed_vars]
            var_terms = [t for t in bound.terms if t.var not in fixed_vars]
            lo_v, hi_v = LinExpr(var_terms, 0).bounds(varying) if var_terms else (0, 0)
            boxes.append((LinExpr(fixed_terms, bound.const + lo_v), hi_v - lo_v + 1))
        # consumer reads producer write with plain per-axis vars
        reads = [
            ld
            for ld in _collect_loads(cblk.expr)
            if ld.buffer.name == pblk.write.name
        ]
        axis_of_dim: Dict[int, str] = {}
        for ld in reads:
            for dim, idx in enumerate(ld.indices):
                v = idx.single_var
                if v is None:
                    raise ScheduleError(
                        "reverse_compute_at: consumer read indices must be plain vars"
                    )
                if axis_of_dim.setdefault(dim, v) != v:
                    raise ScheduleError("reverse_compute_at: inconsistent reads")
        new_bindings: Dict[str, LinExpr] = {}
        loops_new: List[LoopNode] = []
        for ax in cblk.axes:
            dims = [d for d, v in axis_of_dim.items() if v == ax.name]
            v = self._fresh_var(f"{cblk.name}.{ax.name}@")
            if dims:
                off, size = boxes[dims[0]]
                loops_new.append(LoopNode(var=v, extent=size))
                new_bindings[ax.name] = off + LinExpr.var(v)
            else:
                loops_new.append(LoopNode(var=v, extent=ax.extent))
                new_bindings[ax.name] = LinExpr.var(v)
        self._remove_block_subtree_keep(cblk.name)
        new_bn = BlockNode(block=cblk, bindings=new_bindings, attached=True)
        self._blocks[cblk.name] = cblk
        head: Node = new_bn
        for ln in reversed(loops_new):
            ln.body = [head]
            head = ln
        loop_node.body.append(head)  # after producer nest
        self._record("reverse_compute_at", [block, loop], {}, [])

    def _remove_block_subtree_keep(self, name: str) -> None:
        """Remove block subtree but keep block registered (for re-insertion)."""
        blk = self._blocks[name]
        self._remove_block_subtree(name)
        self._blocks[name] = blk

    # -- caching --------------------------------------------------------------

    def cache_read(self, block: BlockRV, buffer_name: str, scope: str = "vmem") -> BlockRV:
        """Stage a read buffer through a copy block in ``scope`` memory."""
        bn, _ = self._find_block(block.name)
        blk = bn.block
        src = next((b for b in blk.reads() if b.name == buffer_name), None)
        if src is None:
            raise ScheduleError(f"{block.name} does not read {buffer_name}")
        staged = Buffer(self._fresh_buf(f"{buffer_name}_{scope}"), src.shape, src.dtype, scope)
        axes = tuple(Axis(f"c{i}", e) for i, e in enumerate(src.shape))
        copy_blk = Block(
            name=f"{staged.name}_read",
            axes=axes,
            expr=Load(src, tuple(LinExpr.var(a.name) for a in axes)),
            write=staged,
            write_indices=tuple(LinExpr.var(a.name) for a in axes),
        )
        # redirect consumer loads
        def sub(ld: Load) -> Expr:
            if ld.buffer.name == buffer_name:
                return Load(staged, ld.indices)
            return ld

        self._replace_block(bn, blk.expr.map_loads(sub))
        # insert copy block before the consumer's outermost loop
        _, cpath = self._find_block(block.name)
        outer = cpath[0] if cpath else self._find_block(block.name)[0]
        body = self.root
        idx = body.index(outer)
        self._blocks[copy_blk.name] = copy_blk
        bindings = {a.name: LinExpr.var(self._fresh_var(f"{copy_blk.name}.{a.name}")) for a in axes}
        chain: Optional[LoopNode] = None
        head: Node = BlockNode(block=copy_blk, bindings=bindings)
        for a in reversed(axes):
            ln = LoopNode(var=bindings[a.name].single_var, extent=a.extent, body=[head])
            head = ln
        body.insert(idx, head)
        rv = BlockRV(copy_blk.name)
        self._record("cache_read", [block], {"buffer": buffer_name, "scope": scope}, [rv])
        return rv

    def cache_write(self, block: BlockRV, scope: str = "vmem") -> BlockRV:
        """Write block output to a ``scope`` staging buffer + copy-out block."""
        bn, path = self._find_block(block.name)
        blk = bn.block
        staged = Buffer(
            self._fresh_buf(f"{blk.write.name}_{scope}"), blk.write.shape, blk.write.dtype, scope
        )
        new_blk = Block(
            name=blk.name,
            axes=blk.axes,
            expr=blk.expr,
            write=staged,
            write_indices=blk.write_indices,
            reduce_op=blk.reduce_op,
            init=blk.init,
        )
        bn.block = new_blk
        self._blocks[blk.name] = new_blk
        axes = tuple(Axis(f"w{i}", e) for i, e in enumerate(blk.write.shape))
        copy_blk = Block(
            name=f"{blk.name}_write_back",
            axes=axes,
            expr=Load(staged, tuple(LinExpr.var(a.name) for a in axes)),
            write=blk.write,
            write_indices=tuple(LinExpr.var(a.name) for a in axes),
        )
        self._blocks[copy_blk.name] = copy_blk
        bindings = {a.name: LinExpr.var(self._fresh_var(f"{copy_blk.name}.{a.name}")) for a in axes}
        head: Node = BlockNode(block=copy_blk, bindings=bindings)
        for a in reversed(axes):
            head = LoopNode(var=bindings[a.name].single_var, extent=a.extent, body=[head])
        # insert right after the producer's outermost subtree
        outer_chain = [n for n in path if isinstance(n, LoopNode)]
        outer = outer_chain[0] if outer_chain else bn
        self.root.insert(self.root.index(outer) + 1, head)
        rv = BlockRV(copy_blk.name)
        self._record("cache_write", [block], {"scope": scope}, [rv])
        return rv

    # -- annotations / tensorize ----------------------------------------------

    def annotate(self, target: Union[BlockRV, LoopRV], key: str, value) -> None:
        v = int(value) if isinstance(value, ExprRV) else value
        if isinstance(target, BlockRV):
            node, _ = self._find_block(target.name)
        else:
            node, _ = self._find_loop(target.var)
        node.annotations[key] = v
        # record the (possibly RV) value as an input so replay remaps it
        self._record("annotate", [target, value], {"key": key}, [])

    def unannotate(self, target: Union[BlockRV, LoopRV], key: str) -> None:
        if isinstance(target, BlockRV):
            node, _ = self._find_block(target.name)
        else:
            node, _ = self._find_loop(target.var)
        node.annotations.pop(key, None)
        self._record("unannotate", [target], {"key": key}, [])

    def tensorize_mxu(self, block: BlockRV) -> None:
        """Mark a matmul-pattern block for MXU tensorization.

        The block's vectorized inner tile is evaluated as a systolic-array
        contraction (``jnp.dot``/einsum with fp32 accumulate) instead of the
        VPU broadcast-multiply-reduce path.  The TPU analogue of the paper's
        Use-Tensor-Core WMMA tensorize.
        """
        bn, _ = self._find_block(block.name)
        if not _is_matmul_pattern(bn.block):
            raise ScheduleError(f"{block.name} is not a matmul-pattern block")
        bn.annotations["tensorize"] = "mxu"
        self._record("tensorize_mxu", [block], {}, [])

    def storage_align(self, block: BlockRV, dim: int, factor: int, offset: int) -> None:
        bn, _ = self._find_block(block.name)
        bn.annotations.setdefault("storage_align", []).append((dim, factor, offset))
        self._record(
            "storage_align", [block], {"dim": dim, "factor": factor, "offset": offset}, []
        )

    def set_scope(self, block: BlockRV, scope: str) -> None:
        bn, _ = self._find_block(block.name)
        old = bn.block
        newb = Block(
            name=old.name,
            axes=old.axes,
            expr=old.expr,
            write=Buffer(old.write.name, old.write.shape, old.write.dtype, scope),
            write_indices=old.write_indices,
            reduce_op=old.reduce_op,
            init=old.init,
        )
        # consumers must see the same buffer object identity-by-name (loads
        # reference by name in backends), so just swap the block
        bn.block = newb
        self._blocks[old.name] = newb
        self._record("set_scope", [block], {"scope": scope}, [])

    def decompose_reduction(self, block: BlockRV, loop: LoopRV) -> None:
        """Recorded as an annotation: backends pre-initialize accumulators
        (CPU) or initialize in-kernel (Pallas), so the explicit init block
        split is a structural no-op here.  See DESIGN.md §3."""
        bn, _ = self._find_block(block.name)
        bn.annotations["decomposed_at"] = loop.var
        self._record("decompose_reduction", [block, loop], {}, [])

    # -- var substitution helpers ----------------------------------------------

    def _substitute_var(self, nodes: List[Node], var: str, expr: LinExpr) -> None:
        self._substitute_var_expr(nodes, var, expr)

    def _substitute_var_expr(self, nodes: List[Node], var: str, expr: LinExpr) -> None:
        mapping = {var: expr}
        for n in iter_nodes(nodes):
            if isinstance(n, BlockNode):
                n.bindings = {
                    k: v.substitute(mapping) if var in v.vars() else v
                    for k, v in n.bindings.items()
                }

    # -- pretty print ------------------------------------------------------------

    def script(self) -> str:
        lines: List[str] = []

        def rec(nodes: List[Node], depth: int):
            for n in nodes:
                pad = "  " * depth
                if isinstance(n, LoopNode):
                    ann = f" @{n.annotations}" if n.annotations else ""
                    lines.append(f"{pad}for {n.var} in {n.extent} [{n.kind}]{ann}")
                    rec(n.body, depth + 1)
                else:
                    ann = f" @{n.annotations}" if n.annotations else ""
                    binds = ", ".join(f"{k}={v}" for k, v in n.bindings.items())
                    lines.append(f"{pad}block {n.block.name}({binds}){ann}")

        rec(self.root, 0)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _collect_loads(e: Expr) -> List[Load]:
    out: List[Load] = []
    e.visit(lambda x: out.append(x) if isinstance(x, Load) else None)
    return out


def _substitute_loads(consumer_expr: Expr, producer: Block, wvars: List[str]) -> Expr:
    """Replace loads of producer.write with producer.expr (axes substituted)."""

    def sub(ld: Load) -> Expr:
        if ld.buffer.name != producer.write.name:
            return ld
        mapping = {wv: idx for wv, idx in zip(wvars, ld.indices)}
        return _substitute_expr_axes(producer.expr, mapping)

    return consumer_expr.map_loads(sub)


def _substitute_expr_axes(e: Expr, mapping: Dict[str, LinExpr]) -> Expr:
    """Substitute axis vars inside an expression's load indices/bounds."""
    if isinstance(e, Load):
        return Load(e.buffer, tuple(ix.substitute(mapping) for ix in e.indices))
    if isinstance(e, Select):
        from .tir import BinOp

        return Select(
            tuple((b.substitute(mapping), n) for b, n in e.bounds),
            _substitute_expr_axes(e.a, mapping),
            _substitute_expr_axes(e.b, mapping),
        )
    if hasattr(e, "a") and hasattr(e, "b"):
        from .tir import BinOp

        return BinOp(e.op, _substitute_expr_axes(e.a, mapping), _substitute_expr_axes(e.b, mapping))
    if isinstance(e, UnOp):
        return UnOp(e.op, _substitute_expr_axes(e.a, mapping))
    return e


def _is_matmul_pattern(blk: Block) -> bool:
    """mul of two loads reduced with add → contractable on the MXU."""
    from .tir import BinOp

    if blk.reduce_op != "add" or not blk.reduce_axes:
        return False
    e = blk.expr
    return (
        isinstance(e, BinOp)
        and e.op == "mul"
        and isinstance(e.a, (Load,))
        and isinstance(e.b, (Load,))
    )


def _sample_perfect_tile(
    rng: np.random.Generator, extent: int, n: int, max_innermost: int
) -> List[int]:
    """Draw a uniform-ish random ordered factorization of ``extent`` into n parts."""
    for _ in range(64):
        factors = [1] * n
        rem = extent
        for i in range(n - 1, 0, -1):
            divisors = [d for d in _divisors(rem) if i != n - 1 or d <= max_innermost]
            if i == n - 1:
                divisors = [d for d in _divisors(rem) if d <= max_innermost]
            f = int(rng.choice(divisors))
            factors[i] = f
            rem //= f
        factors[0] = rem
        if factors[-1] <= max_innermost:
            return factors
    # fallback: everything in the outermost
    out = [1] * n
    out[0] = extent
    return out


def _divisors(x: int) -> List[int]:
    out = []
    d = 1
    while d * d <= x:
        if x % d == 0:
            out.append(d)
            if d != x // d:
                out.append(x // d)
        d += 1
    return sorted(out)
