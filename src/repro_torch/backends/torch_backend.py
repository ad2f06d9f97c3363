"""Lower a scheduled loop tree to an executable PyTorch function.

The port of the JAX package's ``backends/jnp_backend.py``: the *structural*
lowering, which every workload without a hand-written kernel goes through.
The generated function follows the schedule: iterated loops become Python
``for`` loops, vectorize/unroll-marked inner loops become tensor (tile)
dimensions, MXU-tensorized blocks contract their tiles with
``torch.einsum`` while unmarked blocks use broadcast-multiply-reduce.
Buffers live on the inputs' device.

Tile-boundary rule: walking a block's loop chain from the innermost loop
upward, a loop is a *tile dimension* while its kind is ``vectorize`` or
``unroll`` (single-child chain); the first other loop ends the tile.
Everything above is *iterated* (:mod:`repro_torch.backends.loops`).

Where JAX and PyTorch indexing differ, this module keeps JAX's semantics,
so both packages compute the same values for the same schedule:

* ``lax.dynamic_slice`` / ``dynamic_update_slice`` clamp a window's start
  into ``[0, dim - size]``; here the starts are Python ints, clamped so.
* JAX gathers wrap negative indices once and clamp the rest; its scatters
  wrap negative indices once and drop the rest.  PyTorch raises on both,
  so every index that can leave its buffer (by its static range) is
  wrapped and clamped (gathers) or masked (scatters) explicitly.
* ``.at[].add`` is ``index_put_(accumulate=True)``; ``.at[].max`` / ``.min``
  are ``scatter_reduce_`` (``amax`` / ``amin``) on linear indices.
* Index tensors are ``torch.long``; written buffers are allocated fresh by
  every call and updated in place, and no input is ever written.

A load or a scatter whose indices are affine in the tile with nonnegative
strides, inside the buffer and (for a write) one-to-one, is a strided view
instead: the same elements, no index tensors and no gather kernel.

The loop iterations run on the host: each is a few eager PyTorch calls, so
a schedule with many iterated trips costs host time on a card.

A schedule this lowering cannot express (a tile loop feeding both a
spatial and a reduce axis, a tensorized block whose operands are no longer
plain loads) raises ``ScheduleRejected("structure")`` from :func:`build`,
which the measurement stack counts as a rejected candidate.

Also provides :func:`build_oracle` — a whole-domain vectorized lowering of
the *unscheduled* PrimFunc (einsum for contractions): the correctness
oracle and the plain baseline of every workload without a kernel.
"""

from __future__ import annotations

import string
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.schedule import (
    BlockNode,
    LoopNode,
    Node,
    Schedule,
    _is_matmul_pattern,
    _substitute_expr_axes,
    iter_nodes,
)
from ..core.tir import (
    BinOp,
    Block,
    Buffer,
    Const,
    Expr,
    IterVar,
    LinExpr,
    Load,
    PrimFunc,
    REDUCE,
    ScheduleError,
    Select,
    UnOp,
)
from ..kernels import ScheduleRejected
from .loops import _tile_suffix, estimate_iteration_count

BINOP_TORCH = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "max": torch.maximum,
    "min": torch.minimum,
    "pow": torch.pow,
}

UNOP_TORCH = {
    "exp": torch.exp,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "relu": lambda x: torch.clamp_min(x, 0.0),
    "neg": torch.neg,
    "tanh": torch.tanh,
    "log": torch.log,
    "abs": torch.abs,
    "sigmoid": torch.sigmoid,
    "erf": torch.erf,
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "silu": F.silu,
}

REDUCE_TORCH = {"add": torch.sum, "max": torch.amax, "min": torch.amin}

_COMBINE = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}
_SCATTER_REDUCE = {"max": "amax", "min": "amin"}

Index = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# Compiled-schedule metadata
# ---------------------------------------------------------------------------


class LoweredSchedule:
    """Executable + static structure info for features/analysis."""

    def __init__(self, fn, func: PrimFunc, iterated_count: int, tile_elems: int):
        self.fn = fn  # callable(dict inputs) -> dict outputs
        self.func = func
        self.iterated_count = iterated_count  # total loop iterations emitted
        self.tile_elems = tile_elems  # max joint tile size


# ---------------------------------------------------------------------------
# Expression evaluation over a tile
# ---------------------------------------------------------------------------


class _Device:
    """Per-call constants on the inputs' device: aranges and scalars, made
    once per call instead of once per loop iteration."""

    def __init__(self, device: torch.device):
        self.device = device
        self._aranges: Dict[int, torch.Tensor] = {}
        self._consts: Dict[float, torch.Tensor] = {}

    def arange(self, n: int) -> torch.Tensor:
        t = self._aranges.get(n)
        if t is None:
            t = self._aranges[n] = torch.arange(n, device=self.device)
        return t

    def const(self, v: float) -> torch.Tensor:
        t = self._consts.get(v)
        if t is None:
            t = self._consts[v] = torch.full(
                (), v, dtype=torch.float32, device=self.device
            )
        return t


class _TileCtx:
    """Evaluation context for one block instance.

    ``env`` maps iterated loop vars to Python ints; ``tile_vars`` is the
    ordered list of (var, extent) forming the tile.
    """

    def __init__(self, dev: _Device, env: Dict[str, int],
                 tile_vars: List[Tuple[str, int]]):
        self.dev = dev
        self.env = env
        self.tile_vars = tile_vars
        self.rank = len(tile_vars)
        self.shape = tuple(e for _, e in tile_vars)
        self.pos = {v: i for i, (v, _) in enumerate(tile_vars)}
        self.ext = dict(tile_vars)

    def var(self, v: str) -> Index:
        """An iterated var's int, or a tile var's broadcast-ready arange."""
        if v in self.pos:
            shape = [1] * self.rank
            shape[self.pos[v]] = self.ext[v]
            return self.dev.arange(self.ext[v]).view(shape)
        return self.env[v]

    def linexpr(self, e: LinExpr) -> Index:
        """An affine index over the tile: a Python int when it uses no tile
        var, else a long tensor broadcastable to ``shape``."""
        out: Index = e.const
        for t in e.terms:
            v = self.var(t.var)
            if t.div != 1:
                v = v // t.div
            if t.mod is not None:
                v = v % t.mod
            out = out + t.coef * v
        return out

    def bounds(self, e: LinExpr) -> Tuple[int, int]:
        """Inclusive (lo, hi) of ``e`` over the tile (iterated vars fixed);
        exact for one term per var, conservative otherwise."""
        lo = hi = e.const
        for t in e.terms:
            if t.var in self.pos:
                vmax = (self.ext[t.var] - 1) // t.div
                if t.mod is not None:
                    vmax = min(vmax, t.mod - 1)
                a, b = (0, t.coef * vmax) if t.coef >= 0 else (t.coef * vmax, 0)
                lo, hi = lo + a, hi + b
            else:
                v = self.env[t.var] // t.div
                if t.mod is not None:
                    v %= t.mod
                lo, hi = lo + t.coef * v, hi + t.coef * v
        return lo, hi


def _gather_index(ctx: _TileCtx, e: LinExpr, n: int, clamp: bool) -> Index:
    """One dim's gather index with JAX's semantics: ``clamp`` clips into
    [0, n-1] (the padded-load branch of a Select); otherwise a negative
    index wraps once (+n) and what is still out of range is clipped."""
    v = ctx.linexpr(e)
    lo, hi = ctx.bounds(e)
    if 0 <= lo and hi < n:
        return v
    if isinstance(v, int):
        if not clamp and v < 0:
            v += n
        return min(max(v, 0), n - 1)
    if not clamp and lo < 0:
        v = torch.where(v < 0, v + n, v)
    return torch.clamp(v, 0, n - 1)


def _strided_view(buf: torch.Tensor, ctx: _TileCtx,
                  exprs) -> Optional[torch.Tensor]:
    """``buf[exprs]`` over the tile as a strided view of ``buf`` (no copy,
    no kernel), when every index is an iterated offset plus tile vars with
    coef >= 0 and no div/mod, and its range lies inside the buffer; its
    dims are the tile's, size 1 for a tile var no index uses.  Else None
    (the caller gathers or scatters)."""
    offset = buf.storage_offset()
    strides = [0] * ctx.rank
    used = [False] * ctx.rank
    for dim, ix in enumerate(exprs):
        lo, hi = ctx.bounds(ix)
        if lo < 0 or hi >= buf.shape[dim]:
            return None
        step = buf.stride(dim)
        base = ix.const
        for t in ix.terms:
            if t.var not in ctx.pos:
                v = ctx.env[t.var] // t.div
                base += t.coef * (v if t.mod is None else v % t.mod)
            elif t.div != 1 or t.mod is not None or t.coef < 0:
                return None
            else:
                strides[ctx.pos[t.var]] += t.coef * step
                used[ctx.pos[t.var]] = True
        offset += base * step
    size = [e if u else 1 for e, u in zip(ctx.shape, used)]
    return buf.as_strided(size, strides, offset)


def _one_to_one(view: torch.Tensor) -> bool:
    """True when no two elements of ``view`` share a memory location."""
    dims = sorted((st, n) for st, n in zip(view.stride(), view.shape) if n > 1)
    span = 1
    for st, n in dims:
        if st < span:
            return False
        span = st * n
    return True


def _load_tile(ld: Load, ctx: _TileCtx, bufs: Dict[str, torch.Tensor],
               clamp: bool) -> torch.Tensor:
    """Gather a load's tile as a tensor broadcastable to ctx.shape."""
    buf = bufs[ld.buffer.name]
    if not ld.indices:
        raise ScheduleError(f"load of scalar buffer {ld.buffer.name}")
    view = _strided_view(buf, ctx, ld.indices)
    if view is not None:
        return view
    idx = [
        _gather_index(ctx, ix, buf.shape[dim], clamp)
        for dim, ix in enumerate(ld.indices)
    ]
    return buf[tuple(idx)]  # ints among tensors index as broadcast scalars


def _eval_expr_tile(e: Expr, ctx: _TileCtx, bufs: Dict[str, torch.Tensor],
                    clamp: bool = False) -> torch.Tensor:
    if isinstance(e, Const):
        return ctx.dev.const(float(e.value))
    if isinstance(e, IterVar):
        v = ctx.linexpr(LinExpr.var(e.name))
        return v.float() if torch.is_tensor(v) else ctx.dev.const(float(v))
    if isinstance(e, Load):
        return _load_tile(e, ctx, bufs, clamp)
    if isinstance(e, BinOp):
        return BINOP_TORCH[e.op](
            _eval_expr_tile(e.a, ctx, bufs, clamp),
            _eval_expr_tile(e.b, ctx, bufs, clamp),
        )
    if isinstance(e, UnOp):
        return UNOP_TORCH[e.op](_eval_expr_tile(e.a, ctx, bufs, clamp))
    if isinstance(e, Select):
        cond: Union[bool, torch.Tensor] = True
        for bexpr, n in e.bounds:
            v = ctx.linexpr(bexpr)
            c = (v >= 0) & (v < n)
            cond = c if cond is True else cond & c
        a = _eval_expr_tile(e.a, ctx, bufs, clamp=True)
        b = _eval_expr_tile(e.b, ctx, bufs, clamp)
        shape = torch.broadcast_shapes(a.shape, b.shape)
        if isinstance(cond, bool):  # no tile var in the bounds
            out = a if cond else b
            return out.to(torch.result_type(a, b)).expand(shape)
        return torch.where(cond.expand(shape), a, b)
    raise TypeError(f"cannot lower {type(e)}")


def _einsum_tile(blk: Block, ctx: _TileCtx, bufs, r_tile_vars) -> torch.Tensor:
    """MXU path: contract the two loads of a matmul-pattern block with einsum.

    Each load is gathered with *its own* dims (the tile vars it references,
    in tile order) and the contraction runs over the reduce tile vars.
    """
    letters = string.ascii_letters
    var_letter = {v: letters[i] for i, (v, _) in enumerate(ctx.tile_vars)}

    def gather_own(ld: Load):
        own_vars = []
        for ix in ld.indices:
            for v in ix.vars():
                if v in var_letter and v not in own_vars:
                    own_vars.append(v)
        own_vars.sort(key=lambda v: ctx.pos[v])
        sub_ctx = _TileCtx(ctx.dev, ctx.env, [(v, ctx.ext[v]) for v in own_vars])
        arr = _load_tile(ld, sub_ctx, bufs, clamp=False)
        arr = arr.float().expand(sub_ctx.shape)
        return arr, "".join(var_letter[v] for v in own_vars)

    a_arr, a_sub = gather_own(blk.expr.a)
    b_arr, b_sub = gather_own(blk.expr.b)
    r_vars = {v for v, _ in r_tile_vars}
    out_vars = [v for v, _ in ctx.tile_vars if v not in r_vars]
    present = set(a_sub) | set(b_sub)
    kept = [v for v in out_vars if var_letter[v] in present]
    spec = f"{a_sub},{b_sub}->{''.join(var_letter[v] for v in kept)}"
    res = torch.einsum(spec, a_arr, b_arr)
    if len(kept) != len(out_vars):
        # spatial tile vars that index no operand: broadcast them back in
        for pos, v in enumerate(out_vars):
            if v not in kept:
                res = res.unsqueeze(pos)
        res = res.expand(tuple(ctx.ext[v] for v in out_vars))
    return res


# ---------------------------------------------------------------------------
# Writes
# ---------------------------------------------------------------------------


def _window(offsets: List[int], sizes: List[int], shape) -> Tuple[slice, ...]:
    """``lax.dynamic_(update_)slice``'s window: each start clamped into
    [0, dim - size]."""
    return tuple(
        slice(s, s + n)
        for s, n in (
            (min(max(o, 0), max(d - n, 0)), n)
            for o, n, d in zip(offsets, sizes, shape)
        )
    )


def _scatter(buf: torch.Tensor, ctx: _TileCtx, exprs: List[LinExpr],
             val: torch.Tensor, op: Optional[str]) -> None:
    """``buf.at[idx].set/add/max/min(val)`` with JAX's semantics, in place:
    a negative index wraps once, what is still out of range is dropped.
    In-range indices that hit each element once update a strided view."""
    shape = ctx.shape
    dst = _strided_view(buf, ctx, exprs)
    if dst is not None and all(n == e for n, e in zip(dst.shape, shape)) \
            and _one_to_one(dst):
        val = val.expand(shape)
        if op is None:
            dst.copy_(val)
        elif op == "add":
            dst.add_(val)
        else:
            dst.copy_(_COMBINE[op](dst, val))
        return
    idxs, masks = [], []
    for dim, ix in enumerate(exprs):
        n = buf.shape[dim]
        v = ctx.linexpr(ix)
        v = v.expand(shape) if torch.is_tensor(v) else torch.full(
            shape, v, dtype=torch.long, device=buf.device
        )
        lo, hi = ctx.bounds(ix)
        if lo < 0:
            v = torch.where(v < 0, v + n, v)
        if lo < 0 or hi >= n:
            masks.append((v >= 0) & (v < n))
        idxs.append(v)
    val = val.expand(shape)
    if masks:  # rare: a write that can leave the buffer
        keep = masks[0]
        for m in masks[1:]:
            keep = keep & m
        idxs = [v[keep] for v in idxs]
        val = val[keep]
    if op in _SCATTER_REDUCE:
        lin = idxs[0]
        for dim in range(1, len(idxs)):
            lin = lin * buf.shape[dim] + idxs[dim]
        buf.view(-1).scatter_reduce_(
            0, lin.reshape(-1), val.reshape(-1), _SCATTER_REDUCE[op]
        )
    else:
        buf.index_put_(tuple(idxs), val, accumulate=(op == "add"))


# ---------------------------------------------------------------------------
# Block instance emission
# ---------------------------------------------------------------------------


def _classify_tile_vars(bn: BlockNode, tile_loops: List[LoopNode]):
    """Split the tile loops into (spatial, reduce) according to bindings."""
    blk = bn.block
    r_vars, s_vars = [], []
    for ln in tile_loops:
        feeds_r = False
        feeds_s = False
        for ax in blk.axes:
            if ln.var in bn.bindings[ax.name].vars():
                if ax.kind == REDUCE:
                    feeds_r = True
                else:
                    feeds_s = True
        if feeds_r and feeds_s:
            raise ScheduleError(f"tile loop {ln.var} feeds both S and R axes")
        (r_vars if feeds_r else s_vars).append((ln.var, ln.extent))
    return s_vars, r_vars


def _has_iterated_reduce(bn: BlockNode, tile_loops: List[LoopNode]) -> bool:
    """True if any reduce axis of the block is fed by an iterated loop."""
    tile_vars = {ln.var for ln in tile_loops}
    for ax in bn.block.reduce_axes:
        for v in bn.bindings[ax.name].vars():
            if v not in tile_vars:
                return True
    return False


class _BlockPlan:
    """What one block node's emission needs, derived once at build time:
    its tile, its bound expression and write indices, and how the tile is
    written back (a clamped window, or a scatter)."""

    def __init__(self, bn: BlockNode, tile_loops: List[LoopNode]):
        blk = bn.block
        self.bn = bn
        try:
            _, self.r_tile = _classify_tile_vars(bn, tile_loops)
        except ScheduleError as e:
            raise ScheduleRejected("structure", str(e)) from None
        self.tile_vars = [(ln.var, ln.extent) for ln in tile_loops]
        r_names = {v for v, _ in self.r_tile}
        self.out_tile_vars = [v for v in self.tile_vars if v[0] not in r_names]
        self.expr = _substitute_expr_axes(blk.expr, bn.bindings)
        self.einsum_blk = None
        if bn.annotations.get("tensorize") == "mxu" and isinstance(self.expr, BinOp):
            if not (isinstance(self.expr.a, Load) and isinstance(self.expr.b, Load)):
                raise ScheduleRejected(
                    "structure",
                    f"tensorized block {blk.name} no longer contracts two "
                    "plain loads",
                )
            self.einsum_blk = Block(
                name=blk.name,
                axes=blk.axes,
                expr=self.expr,
                write=blk.write,
                write_indices=blk.write_indices,
                reduce_op=blk.reduce_op,
                init=blk.init,
            )
        self.w_exprs = [ix.substitute(bn.bindings) for ix in blk.write_indices]
        self.iter_reduce = bool(blk.reduce_op) and _has_iterated_reduce(bn, tile_loops)
        # contiguity: each write dim uses at most one *spatial tile* var, coef 1
        out_pos = {v: i for i, (v, _) in enumerate(self.out_tile_vars)}
        dim_var: List[Optional[str]] = []
        contiguous = True
        used = set()
        for ix in self.w_exprs:
            vs = [v for v in ix.vars() if v in out_pos]
            if len(vs) == 0:
                dim_var.append(None)
            elif len(vs) == 1:
                t = [t for t in ix.terms if t.var == vs[0]][0]
                if t.coef == 1 and t.div == 1 and t.mod is None and vs[0] not in used:
                    dim_var.append(vs[0])
                    used.add(vs[0])
                else:
                    contiguous = False
                    break
            else:
                contiguous = False
                break
        self.contiguous = contiguous and len(used) == len(self.out_tile_vars)
        if self.contiguous:
            # permute the tile to buffer-dim order, size-1 dims for var-less dims
            self.perm = [out_pos[v] for v in dim_var if v is not None]
            ext = dict(self.out_tile_vars)
            self.sizes = [1 if dv is None else ext[dv] for dv in dim_var]

    def emit(self, dev: _Device, env: Dict[str, int],
             bufs: Dict[str, torch.Tensor]) -> None:
        """Evaluate one block instance and write its tile into its buffer."""
        blk = self.bn.block
        ctx = _TileCtx(dev, env, self.tile_vars)
        if self.einsum_blk is not None:
            val = _einsum_tile(self.einsum_blk, ctx, bufs, self.r_tile)
        else:
            val = _eval_expr_tile(self.expr, ctx, bufs).expand(ctx.shape)
            r_pos = [ctx.pos[v] for v, _ in self.r_tile]
            if r_pos:
                val = REDUCE_TORCH[blk.reduce_op](val, dim=tuple(r_pos))
        buf = bufs[blk.write.name]
        if self.contiguous:
            perm = self.perm
            val_t = val.permute(perm) if perm != sorted(perm) else val
            val_t = val_t.reshape(self.sizes)
            senv = dict(env)
            for v, _ in self.tile_vars:
                senv[v] = 0
            offsets = [ix.evaluate(senv) for ix in self.w_exprs]
            win = _window(offsets, self.sizes, buf.shape)
            if self.iter_reduce:
                val_t = _COMBINE[blk.reduce_op](buf[win], val_t.to(buf.dtype))
            buf[win] = val_t.to(buf.dtype)
        else:
            # scatter path, index tensors over the spatial tile dims only
            sctx = _TileCtx(dev, env, self.out_tile_vars)
            _scatter(buf, sctx, self.w_exprs, val.to(buf.dtype),
                     blk.reduce_op if self.iter_reduce else None)


# ---------------------------------------------------------------------------
# Tree emission
# ---------------------------------------------------------------------------


def _dtype(name: str) -> torch.dtype:
    """A buffer's dtype string ("float32", "bfloat16", ...) as torch's."""
    return getattr(torch, name)


def _torch_inputs(func: PrimFunc, inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    out = {}
    for b in func.inputs:
        x = inputs[b.name]
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.asarray(x))
        out[b.name] = x.to(_dtype(b.dtype))
    return out


def build(sch: Schedule) -> LoweredSchedule:
    """Lower the scheduled tree into a callable on tensors."""
    func = sch.func
    # precompute tile suffix per block node
    tile_of: Dict[int, List[LoopNode]] = {}

    def collect(nodes: List[Node], path: List[LoopNode]):
        for n in nodes:
            if isinstance(n, LoopNode):
                collect(n.body, path + [n])
            else:
                tile_of[id(n)] = _tile_suffix(path, n)

    collect(sch.root, [])
    plans = {
        id(n): _BlockPlan(n, tile_of[id(n)])
        for n in iter_nodes(sch.root) if isinstance(n, BlockNode)
    }
    tile_vars_all = {ln.var for t in tile_of.values() for ln in t}
    iter_count = estimate_iteration_count(sch)
    tile_elems = max(
        (int(np.prod([ln.extent for ln in t])) for t in tile_of.values() if t),
        default=1,
    )
    extents = {
        ln.var: ln.extent for ln in iter_nodes(sch.root) if isinstance(ln, LoopNode)
    }

    # written buffers (allocated), with init values for root reduce blocks
    written: Dict[str, Buffer] = {}
    init_val: Dict[str, float] = {}
    for n in iter_nodes(sch.root):
        if isinstance(n, BlockNode):
            written[n.block.write.name] = n.block.write
            if n.block.reduce_op:
                init_val[n.block.write.name] = n.block.init
    output_names = [b.name for b in func.outputs]

    def emit_seq(nodes: List[Node], dev, env, bufs):
        for n in nodes:
            emit_one(n, dev, env, bufs)

    def emit_one(n: Node, dev, env, bufs):
        if isinstance(n, BlockNode):
            if n.attached and n.block.reduce_op:
                _init_region(n, env, bufs)
            plans[id(n)].emit(dev, env, bufs)
            return
        if n.var in tile_vars_all:
            # tile dim: do not iterate; descend (single child = block chain)
            emit_seq(n.body, dev, env, bufs)
            return
        # iterated loop
        for i in range(n.extent):
            env2 = dict(env)
            env2[n.var] = i
            emit_seq(n.body, dev, env2, bufs)

    def _init_region(bn: BlockNode, env, bufs):
        """Initialize the write region of an attached reduce block.

        The region per *this* attachment instance is recomputed fresh, so
        overlapping recompute across outer iterations stays correct.
        """
        blk = bn.block
        var_ext: Dict[str, int] = {}
        for ax in blk.axes:
            for t in bn.bindings[ax.name].terms:
                if t.var not in env:
                    var_ext[t.var] = extents[t.var]
        senv = dict(env)
        for v in var_ext:
            senv[v] = 0
        starts, sizes = [], []
        for ix in blk.write_indices:
            e = ix.substitute(bn.bindings)
            off = e.evaluate(senv)
            span_terms = [t for t in e.terms if t.var in var_ext]
            lo, hi = LinExpr(span_terms, 0).bounds(var_ext) if span_terms else (0, 0)
            starts.append(off + lo)
            sizes.append(hi - lo + 1)
        buf = bufs[blk.write.name]
        buf[_window(starts, sizes, buf.shape)] = blk.init

    def fn(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        bufs = _torch_inputs(func, inputs)
        device = next(iter(bufs.values())).device if bufs else torch.device("cpu")
        for name, b in written.items():
            bufs[name] = torch.full(
                b.shape, init_val.get(name, 0.0), dtype=_dtype(b.dtype),
                device=device,
            )
        emit_seq(sch.root, _Device(device), {}, bufs)
        return {n: bufs[n] for n in output_names}

    return LoweredSchedule(fn, func, iter_count, tile_elems)


# ---------------------------------------------------------------------------
# Oracle / plain lowering of the unscheduled PrimFunc
# ---------------------------------------------------------------------------


def build_oracle(func: PrimFunc) -> Callable[[Dict[str, Any]], Dict[str, torch.Tensor]]:
    """Whole-domain vectorized lowering (einsum for contractions).

    Defines correctness for every schedule and is the plain PyTorch
    version ``tune_workload`` times for a workload without a kernel.
    """

    def eval_block(blk: Block, dev: _Device, bufs) -> torch.Tensor:
        axes = blk.axes
        ctx = _TileCtx(dev, {}, [(a.name, a.extent) for a in axes])
        r_tile = [(a.name, a.extent) for a in blk.reduce_axes]
        if _is_matmul_pattern(blk):
            val = _einsum_tile(blk, ctx, bufs, r_tile)
        else:
            val = _eval_expr_tile(blk.expr, ctx, bufs).expand(ctx.shape)
            r_pos = [i for i, a in enumerate(axes) if a.kind == REDUCE]
            if r_pos:
                val = REDUCE_TORCH[blk.reduce_op](val, dim=tuple(r_pos))
        s_axes = blk.spatial_axes
        sctx = _TileCtx(dev, {}, [(a.name, a.extent) for a in s_axes])
        dtype = _dtype(blk.write.dtype)
        # fast path: identity writes
        ident = all(
            ix.single_var == a.name for ix, a in zip(blk.write_indices, s_axes)
        ) and len(blk.write_indices) == len(s_axes)
        if ident and tuple(blk.write.shape) == sctx.shape:
            return val.to(dtype)
        out = torch.full(blk.write.shape, blk.init, dtype=dtype, device=dev.device)
        _scatter(out, sctx, list(blk.write_indices), val.to(dtype), None)
        return out

    def fn(inputs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        bufs = _torch_inputs(func, inputs)
        device = next(iter(bufs.values())).device if bufs else torch.device("cpu")
        dev = _Device(device)
        for blk in func.blocks:
            bufs[blk.write.name] = eval_block(blk, dev, bufs)
        return {b.name: bufs[b.name] for b in func.outputs}

    return fn
