"""Mini tensor-program IR (TensorIR-lite).

This is the program representation that MetaSchedule schedules operate on.
A :class:`PrimFunc` is a DAG of :class:`Block` compute definitions over
:class:`Buffer` objects.  Each block has an iteration domain (spatial +
reduction axes) and an expression tree evaluated at every point of the
domain.  Index expressions are affine (:class:`LinExpr`) in the iteration
variables, which is what makes scheduling transformations (split / fuse /
reorder / compute-at region inference) analyzable.

The module is deliberately jax-free: a pure-numpy reference evaluator
(:func:`evaluate_primfunc`) defines the semantics that every backend and
every schedule transformation must preserve.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# ---------------------------------------------------------------------------
# Axes and buffers
# ---------------------------------------------------------------------------

SPATIAL = "S"
REDUCE = "R"


@dataclass(frozen=True)
class Axis:
    """One iteration variable of a block."""

    name: str
    extent: int
    kind: str = SPATIAL  # SPATIAL | REDUCE

    def __post_init__(self):
        if self.kind not in (SPATIAL, REDUCE):
            raise ValueError(f"bad axis kind {self.kind!r}")
        if self.extent <= 0:
            raise ValueError(f"axis {self.name} has extent {self.extent}")


@dataclass(frozen=True)
class Buffer:
    """A logical dense tensor."""

    name: str
    shape: Tuple[int, ...]
    dtype: str = "float32"
    scope: str = "global"  # global | vmem | smem (annotation only on CPU)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * np.dtype(self.dtype).itemsize


# ---------------------------------------------------------------------------
# Affine index expressions
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Term:
    """``coef * ((var // div) % mod)``; ``mod is None`` means no modulo."""

    var: str
    coef: int = 1
    div: int = 1
    mod: Optional[int] = None


class LinExpr:
    """Affine expression ``sum(terms) + const`` over iteration variables.

    Terms support floordiv/mod so that fused loops remain representable.
    """

    __slots__ = ("terms", "const")

    def __init__(self, terms: Sequence[Term] = (), const: int = 0):
        # canonicalize: merge identical (var, div, mod) terms
        merged: Dict[Tuple[str, int, Optional[int]], int] = {}
        for t in terms:
            if t.coef == 0:
                continue
            key = (t.var, t.div, t.mod)
            merged[key] = merged.get(key, 0) + t.coef
        self.terms: Tuple[Term, ...] = tuple(
            Term(var=v, coef=c, div=d, mod=m)
            for (v, d, m), c in sorted(
                merged.items(),
                key=lambda kv: (kv[0][0], kv[0][1], -1 if kv[0][2] is None else kv[0][2]),
            )
            if c != 0
        )
        self.const = int(const)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def var(name: str, coef: int = 1) -> "LinExpr":
        return LinExpr([Term(name, coef)], 0)

    @staticmethod
    def const_(v: int) -> "LinExpr":
        return LinExpr([], v)

    # -- algebra ------------------------------------------------------------
    def __add__(self, other: Union["LinExpr", int]) -> "LinExpr":
        if isinstance(other, int):
            return LinExpr(self.terms, self.const + other)
        return LinExpr(self.terms + other.terms, self.const + other.const)

    __radd__ = __add__

    def __mul__(self, k: int) -> "LinExpr":
        if k == 0:
            return LinExpr([], 0)
        return LinExpr(
            [Term(t.var, t.coef * k, t.div, t.mod) for t in self.terms],
            self.const * k,
        )

    __rmul__ = __mul__

    def __sub__(self, other: Union["LinExpr", int]) -> "LinExpr":
        if isinstance(other, int):
            return self + (-other)
        return self + (other * -1)

    # -- queries ------------------------------------------------------------
    @property
    def is_const(self) -> bool:
        return not self.terms

    @property
    def single_var(self) -> Optional[str]:
        """If the expr is ``1*v + c`` (no div/mod), return ``v``."""
        if len(self.terms) == 1:
            t = self.terms[0]
            if t.coef == 1 and t.div == 1 and t.mod is None:
                return t.var
        return None

    def vars(self) -> Tuple[str, ...]:
        return tuple(dict.fromkeys(t.var for t in self.terms))

    def substitute(self, mapping: Dict[str, "LinExpr"]) -> "LinExpr":
        """Replace variables by affine expressions.

        Substituting into a div/mod term is only legal when the replacement
        is itself a plain variable or constant (validator enforces this).
        """
        out = LinExpr([], self.const)
        for t in self.terms:
            if t.var not in mapping:
                out = out + LinExpr([t], 0)
                continue
            rep = mapping[t.var]
            if t.div == 1 and t.mod is None:
                out = out + rep * t.coef
            else:
                if rep.is_const:
                    val = (rep.const // t.div)
                    if t.mod is not None:
                        val %= t.mod
                    out = out + val * t.coef
                elif rep.single_var is not None and rep.const == 0:
                    out = out + LinExpr([Term(rep.single_var, t.coef, t.div, t.mod)], 0)
                else:
                    raise ScheduleError(
                        f"cannot substitute {rep} into div/mod term {t}"
                    )
        return out

    def bounds(self, extents: Dict[str, int]) -> Tuple[int, int]:
        """Inclusive (lo, hi) interval given ``var -> extent`` (vars in [0, e))."""
        lo = hi = self.const
        for t in self.terms:
            e = extents[t.var]
            vmax = (e - 1) // t.div
            if t.mod is not None:
                vmax = min(vmax, t.mod - 1)
            a, b = 0, vmax
            if t.coef >= 0:
                lo += t.coef * a
                hi += t.coef * b
            else:
                lo += t.coef * b
                hi += t.coef * a
        return lo, hi

    def evaluate(self, env: Dict[str, "np.ndarray | int"]):
        """Evaluate numerically; env values may be ints or integer arrays."""
        out = self.const
        for t in self.terms:
            v = env[t.var]
            v = v // t.div
            if t.mod is not None:
                v = v % t.mod
            out = out + t.coef * v
        return out

    def __repr__(self):
        parts = []
        for t in self.terms:
            s = t.var
            if t.div != 1:
                s = f"({s}//{t.div})"
            if t.mod is not None:
                s = f"({s}%{t.mod})"
            if t.coef != 1:
                s = f"{t.coef}*{s}"
            parts.append(s)
        if self.const or not parts:
            parts.append(str(self.const))
        return " + ".join(parts)

    def __eq__(self, other):
        return (
            isinstance(other, LinExpr)
            and self.terms == other.terms
            and self.const == other.const
        )

    def __hash__(self):
        return hash((self.terms, self.const))


def as_linexpr(x: Union[LinExpr, int, str]) -> LinExpr:
    if isinstance(x, LinExpr):
        return x
    if isinstance(x, int):
        return LinExpr.const_(x)
    if isinstance(x, str):
        return LinExpr.var(x)
    raise TypeError(f"cannot convert {x!r} to LinExpr")


# ---------------------------------------------------------------------------
# Scalar expression tree (the compute of a block)
# ---------------------------------------------------------------------------


class Expr:
    """Base class of scalar expressions."""

    def visit(self, fn: Callable[["Expr"], None]) -> None:
        fn(self)
        for c in self.children():
            c.visit(fn)

    def children(self) -> Tuple["Expr", ...]:
        return ()

    def map_loads(self, fn: Callable[["Load"], "Expr"]) -> "Expr":
        raise NotImplementedError


@dataclass(frozen=True)
class Const(Expr):
    value: float

    def map_loads(self, fn):
        return self


@dataclass(frozen=True)
class IterVar(Expr):
    """A block iteration variable used as a *value* (rare: e.g. position enc)."""

    name: str

    def map_loads(self, fn):
        return self


@dataclass(frozen=True)
class Load(Expr):
    buffer: Buffer
    indices: Tuple[LinExpr, ...]

    def __post_init__(self):
        if len(self.indices) != len(self.buffer.shape):
            raise ValueError(
                f"load of {self.buffer.name}: {len(self.indices)} indices for "
                f"rank-{len(self.buffer.shape)} buffer"
            )

    def map_loads(self, fn):
        return fn(self)


@dataclass(frozen=True)
class BinOp(Expr):
    op: str  # add sub mul div max min pow
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)

    def map_loads(self, fn):
        return BinOp(self.op, self.a.map_loads(fn), self.b.map_loads(fn))


@dataclass(frozen=True)
class UnOp(Expr):
    op: str  # exp sqrt rsqrt relu neg tanh log abs sigmoid erf
    a: Expr

    def children(self):
        return (self.a,)

    def map_loads(self, fn):
        return UnOp(self.op, self.a.map_loads(fn))


@dataclass(frozen=True)
class Select(Expr):
    """``cond ? a : b`` where cond is a conjunction of 0 <= e < N bounds."""

    bounds: Tuple[Tuple[LinExpr, int], ...]  # each: 0 <= e < N
    a: Expr
    b: Expr

    def children(self):
        return (self.a, self.b)

    def map_loads(self, fn):
        return Select(self.bounds, self.a.map_loads(fn), self.b.map_loads(fn))


BINOP_NP = {
    "add": np.add,
    "sub": np.subtract,
    "mul": np.multiply,
    "div": np.divide,
    "max": np.maximum,
    "min": np.minimum,
    "pow": np.power,
}

UNOP_NP = {
    "exp": np.exp,
    "sqrt": np.sqrt,
    "rsqrt": lambda x: 1.0 / np.sqrt(x),
    "relu": lambda x: np.maximum(x, 0.0),
    "neg": np.negative,
    "tanh": np.tanh,
    "log": np.log,
    "abs": np.abs,
    "sigmoid": lambda x: 1.0 / (1.0 + np.exp(-x)),
    "erf": lambda x: np.vectorize(math.erf)(x).astype(np.asarray(x).dtype),
    "gelu": lambda x: 0.5 * x * (1.0 + np.vectorize(math.erf)(x / math.sqrt(2.0))),
    "silu": lambda x: x / (1.0 + np.exp(-x)),
}


# convenience expression builders -------------------------------------------

def load(buf: Buffer, *idx: Union[LinExpr, int, str]) -> Load:
    return Load(buf, tuple(as_linexpr(i) for i in idx))


def add(a, b):
    return BinOp("add", a, b)


def sub(a, b):
    return BinOp("sub", a, b)


def mul(a, b):
    return BinOp("mul", a, b)


def div(a, b):
    return BinOp("div", a, b)


def fmax(a, b):
    return BinOp("max", a, b)


def const(v: float) -> Const:
    return Const(float(v))


# ---------------------------------------------------------------------------
# Blocks and PrimFunc
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Block:
    """One compute statement: ``write[idx(S)] (op)= expr(S, R)``.

    If the block has any REDUCE axes, ``reduce_op`` combines contributions and
    ``init`` is the identity the output is initialized with.
    """

    name: str
    axes: Tuple[Axis, ...]
    expr: Expr
    write: Buffer
    write_indices: Tuple[LinExpr, ...]
    reduce_op: Optional[str] = None  # add | max | min
    init: float = 0.0

    def __post_init__(self):
        has_r = any(a.kind == REDUCE for a in self.axes)
        if has_r and self.reduce_op is None:
            raise ValueError(f"block {self.name}: REDUCE axes but no reduce_op")
        if len(self.write_indices) != len(self.write.shape):
            raise ValueError(f"block {self.name}: write index rank mismatch")
        # write indices must only use spatial axes
        s_names = {a.name for a in self.axes if a.kind == SPATIAL}
        for e in self.write_indices:
            for v in e.vars():
                if v not in s_names:
                    raise ValueError(
                        f"block {self.name}: write index uses non-spatial var {v}"
                    )

    @property
    def spatial_axes(self) -> Tuple[Axis, ...]:
        return tuple(a for a in self.axes if a.kind == SPATIAL)

    @property
    def reduce_axes(self) -> Tuple[Axis, ...]:
        return tuple(a for a in self.axes if a.kind == REDUCE)

    def reads(self) -> Tuple[Buffer, ...]:
        bufs: Dict[str, Buffer] = {}

        def _collect(e: Expr):
            if isinstance(e, Load):
                bufs[e.buffer.name] = e.buffer

        self.expr.visit(_collect)
        return tuple(bufs.values())

    def flops(self) -> int:
        """Floating-point ops per output-point evaluation (rough)."""
        n = 0

        def _count(e: Expr):
            nonlocal n
            if isinstance(e, (BinOp,)):
                n += 1
            elif isinstance(e, UnOp):
                n += 4 if e.op in ("exp", "tanh", "erf", "gelu", "sigmoid", "log") else 1

        self.expr.visit(_count)
        domain = int(np.prod([a.extent for a in self.axes]))
        extra = 1 if self.reduce_op else 0
        return domain * (n + extra)

    def is_elementwise(self) -> bool:
        """Spatial-only block whose loads are plain per-axis index maps."""
        return not self.reduce_axes

    def __repr__(self):
        ax = ", ".join(f"{a.name}:{a.kind}{a.extent}" for a in self.axes)
        return f"Block({self.name}; [{ax}] -> {self.write.name})"


@dataclass
class PrimFunc:
    """A tensor program: dataflow-ordered blocks over input/output buffers."""

    name: str
    inputs: Tuple[Buffer, ...]
    outputs: Tuple[Buffer, ...]
    blocks: Tuple[Block, ...]

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        defined = {b.name for b in self.inputs}
        for blk in self.blocks:
            for rb in blk.reads():
                if rb.name not in defined:
                    raise ValueError(
                        f"{self.name}: block {blk.name} reads undefined buffer {rb.name}"
                    )
            defined.add(blk.write.name)
        for ob in self.outputs:
            if ob.name not in defined:
                raise ValueError(f"{self.name}: output {ob.name} never written")

    @property
    def buffers(self) -> Dict[str, Buffer]:
        out = {b.name: b for b in self.inputs}
        for blk in self.blocks:
            out[blk.write.name] = blk.write
        return out

    def block(self, name: str) -> Block:
        for b in self.blocks:
            if b.name == name:
                return b
        raise KeyError(name)

    def producers(self, blk: Block) -> List[Block]:
        reads = {b.name for b in blk.reads()}
        return [b for b in self.blocks if b.write.name in reads]

    def consumers(self, blk: Block) -> List[Block]:
        return [
            b
            for b in self.blocks
            if blk.write.name in {r.name for r in b.reads()}
        ]

    def total_flops(self) -> int:
        return sum(b.flops() for b in self.blocks)


class ScheduleError(Exception):
    """Raised when a schedule primitive is applied illegally."""


# ---------------------------------------------------------------------------
# Reference evaluator (pure numpy) — defines program semantics
# ---------------------------------------------------------------------------


def _eval_expr(e: Expr, idx_env: Dict[str, np.ndarray], bufs: Dict[str, np.ndarray]):
    if isinstance(e, Const):
        return e.value
    if isinstance(e, IterVar):
        return idx_env[e.name].astype(np.float32)
    if isinstance(e, Load):
        arr = bufs[e.buffer.name]
        idxs = tuple(np.asarray(ix.evaluate(idx_env)) for ix in e.indices)
        # broadcast index arrays against each other
        idxs = np.broadcast_arrays(*[np.asarray(i) for i in idxs]) if idxs else ()
        return arr[tuple(idxs)]
    if isinstance(e, BinOp):
        return BINOP_NP[e.op](
            _eval_expr(e.a, idx_env, bufs), _eval_expr(e.b, idx_env, bufs)
        )
    if isinstance(e, UnOp):
        return UNOP_NP[e.op](_eval_expr(e.a, idx_env, bufs))
    if isinstance(e, Select):
        cond = True
        for expr_, n in e.bounds:
            v = expr_.evaluate(idx_env)
            cond = np.logical_and(cond, np.logical_and(v >= 0, v < n))
        # guard out-of-bounds loads in the taken branch by clamping indices
        def _clamped(ld: Load) -> Expr:
            return ld

        a = _eval_expr_clamped(e.a, idx_env, bufs)
        b = _eval_expr(e.b, idx_env, bufs)
        return np.where(cond, a, b)
    raise TypeError(f"cannot evaluate {type(e)}")


def _eval_expr_clamped(e: Expr, idx_env, bufs):
    """Like _eval_expr but clamps load indices into range (used under Select)."""
    if isinstance(e, Load):
        arr = bufs[e.buffer.name]
        idxs = []
        for dim, ix in enumerate(e.indices):
            v = np.asarray(ix.evaluate(idx_env))
            idxs.append(np.clip(v, 0, arr.shape[dim] - 1))
        idxs = np.broadcast_arrays(*idxs) if idxs else ()
        return arr[tuple(idxs)]
    if isinstance(e, BinOp):
        return BINOP_NP[e.op](
            _eval_expr_clamped(e.a, idx_env, bufs),
            _eval_expr_clamped(e.b, idx_env, bufs),
        )
    if isinstance(e, UnOp):
        return UNOP_NP[e.op](_eval_expr_clamped(e.a, idx_env, bufs))
    return _eval_expr(e, idx_env, bufs)


REDUCE_NP = {"add": np.add, "max": np.maximum, "min": np.minimum}
REDUCE_INIT = {"add": 0.0, "max": -np.inf, "min": np.inf}


def evaluate_block(blk: Block, bufs: Dict[str, np.ndarray]) -> np.ndarray:
    """Evaluate one block, returning its output array."""
    grids = np.meshgrid(
        *[np.arange(a.extent) for a in blk.axes], indexing="ij", sparse=True
    )
    idx_env = {a.name: g for a, g in zip(blk.axes, grids)}
    vals = np.asarray(_eval_expr(blk.expr, idx_env, bufs))
    full_shape = tuple(a.extent for a in blk.axes)
    vals = np.broadcast_to(vals, full_shape)
    # reduce over REDUCE axes
    r_dims = tuple(i for i, a in enumerate(blk.axes) if a.kind == REDUCE)
    if r_dims:
        if blk.reduce_op == "add":
            vals = vals.sum(axis=r_dims)
        elif blk.reduce_op == "max":
            vals = vals.max(axis=r_dims)
        elif blk.reduce_op == "min":
            vals = vals.min(axis=r_dims)
        else:
            raise ValueError(blk.reduce_op)
    # scatter into output via write indices (affine in spatial axes)
    out = np.full(blk.write.shape, blk.init, dtype=np.dtype(blk.write.dtype))
    s_axes = blk.spatial_axes
    sgrids = np.meshgrid(
        *[np.arange(a.extent) for a in s_axes], indexing="ij", sparse=True
    )
    senv = {a.name: g for a, g in zip(s_axes, sgrids)}
    w_idx = tuple(
        np.broadcast_to(np.asarray(ix.evaluate(senv)), tuple(a.extent for a in s_axes))
        for ix in blk.write_indices
    )
    out[w_idx] = vals
    return out.astype(np.dtype(blk.write.dtype))


def evaluate_primfunc(
    func: PrimFunc, inputs: Dict[str, np.ndarray]
) -> Dict[str, np.ndarray]:
    """Reference semantics: evaluate all blocks in dataflow order."""
    bufs: Dict[str, np.ndarray] = {}
    for b in func.inputs:
        arr = np.asarray(inputs[b.name], dtype=np.dtype(b.dtype))
        if arr.shape != b.shape:
            raise ValueError(f"input {b.name}: got {arr.shape}, want {b.shape}")
        bufs[b.name] = arr
    for blk in func.blocks:
        bufs[blk.write.name] = evaluate_block(blk, bufs)
    return {b.name: bufs[b.name] for b in func.outputs}


def random_inputs(func: PrimFunc, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {
        b.name: rng.standard_normal(b.shape).astype(np.dtype(b.dtype))
        for b in func.inputs
    }
