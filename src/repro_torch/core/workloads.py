"""Workload registry: the paper's Appendix A.2 operators + model workloads.

Every workload is a factory returning a :class:`PrimFunc`.  Default shapes
are exactly the paper's (Appendix A.2); all factories accept overrides so
tests can run reduced sizes through the numpy reference evaluator.

Workloads registered here are the tuning units of the end-to-end system:
model layers register their hot matmuls through :func:`dense` /
:func:`batch_matmul` with a shape key, and the tuned trace is stored in the
search database under that key.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from .tir import (
    Axis,
    BinOp,
    Block,
    Buffer,
    Const,
    Expr,
    LinExpr,
    Load,
    PrimFunc,
    REDUCE,
    Select,
    UnOp,
    add,
    const,
    load,
    mul,
)

WORKLOADS: Dict[str, Callable[..., PrimFunc]] = {}


def register(name: str):
    def deco(fn):
        WORKLOADS[name] = fn
        fn.workload_name = name
        return fn

    return deco


def get_workload(name: str, **kwargs) -> PrimFunc:
    return WORKLOADS[name](**kwargs)


def _v(name: str) -> LinExpr:
    return LinExpr.var(name)


# ---------------------------------------------------------------------------
# Dense / matmul family
# ---------------------------------------------------------------------------


@register("gmm")
def gmm(n: int = 128, m: int = 128, k: int = 128, dtype: str = "float32") -> PrimFunc:
    """GMM: plain matrix multiply C[i, j] = sum_k A[i, k] * B[k, j]."""
    A = Buffer("A", (n, k), dtype)
    B = Buffer("B", (k, m), dtype)
    C = Buffer("C", (n, m), dtype)
    blk = Block(
        name="C",
        axes=(Axis("i", n), Axis("j", m), Axis("kk", k, REDUCE)),
        expr=mul(load(A, "i", "kk"), load(B, "kk", "j")),
        write=C,
        write_indices=(_v("i"), _v("j")),
        reduce_op="add",
    )
    return PrimFunc("gmm", (A, B), (C,), (blk,))


@register("dense")
def dense(
    m: int = 128,
    n: int = 128,
    k: int = 128,
    epilogue: str = "none",  # none | bias | bias_relu | bias_gelu | relu | softcap
    dtype: str = "float32",
) -> PrimFunc:
    """Dense (+ optional fused epilogue) — the model-integration workload."""
    X = Buffer("X", (m, k), dtype)
    W = Buffer("W", (k, n), dtype)
    Y = Buffer("Y", (m, n), dtype)
    inputs = [X, W]
    matmul = Block(
        name="dense",
        axes=(Axis("i", m), Axis("j", n), Axis("kk", k, REDUCE)),
        expr=mul(load(X, "i", "kk"), load(W, "kk", "j")),
        write=Y,
        write_indices=(_v("i"), _v("j")),
        reduce_op="add",
    )
    blocks = [matmul]
    cur = Y
    if epilogue.startswith("bias"):
        Bb = Buffer("bias", (n,), dtype)
        inputs.append(Bb)
        Z = Buffer("Z", (m, n), dtype)
        blocks.append(
            Block(
                name="bias_add",
                axes=(Axis("i", m), Axis("j", n)),
                expr=add(load(cur, "i", "j"), load(Bb, "j")),
                write=Z,
                write_indices=(_v("i"), _v("j")),
            )
        )
        cur = Z
    if epilogue.endswith("relu"):
        R = Buffer("R", (m, n), dtype)
        blocks.append(
            Block(
                name="relu",
                axes=(Axis("i", m), Axis("j", n)),
                expr=UnOp("relu", load(cur, "i", "j")),
                write=R,
                write_indices=(_v("i"), _v("j")),
            )
        )
        cur = R
    elif epilogue.endswith("gelu"):
        G = Buffer("G", (m, n), dtype)
        blocks.append(
            Block(
                name="gelu",
                axes=(Axis("i", m), Axis("j", n)),
                expr=UnOp("gelu", load(cur, "i", "j")),
                write=G,
                write_indices=(_v("i"), _v("j")),
            )
        )
        cur = G
    elif epilogue == "softcap":
        # gemma-2 style logit soft-capping: c * tanh(x / c), c = 30
        G = Buffer("G", (m, n), dtype)
        blocks.append(
            Block(
                name="softcap",
                axes=(Axis("i", m), Axis("j", n)),
                expr=mul(
                    const(30.0),
                    UnOp("tanh", mul(load(cur, "i", "j"), const(1.0 / 30.0))),
                ),
                write=G,
                write_indices=(_v("i"), _v("j")),
            )
        )
        cur = G
    return PrimFunc(f"dense_{epilogue}", tuple(inputs), (cur,), tuple(blocks))


@register("batch_matmul")
def batch_matmul(
    b: int = 12, m: int = 128, n: int = 128, k: int = 64, dtype: str = "float32"
) -> PrimFunc:
    """Batched matmul C[b, i, j] = sum_k A[b, i, k] * B[b, k, j]."""
    A = Buffer("A", (b, m, k), dtype)
    B = Buffer("B", (b, k, n), dtype)
    C = Buffer("C", (b, m, n), dtype)
    blk = Block(
        name="bmm",
        axes=(Axis("bb", b), Axis("i", m), Axis("j", n), Axis("kk", k, REDUCE)),
        expr=mul(load(A, "bb", "i", "kk"), load(B, "bb", "kk", "j")),
        write=C,
        write_indices=(_v("bb"), _v("i"), _v("j")),
        reduce_op="add",
    )
    return PrimFunc("batch_matmul", (A, B), (C,), (blk,))


@register("tbg")
def tbg(
    b: int = 1, seq: int = 128, head: int = 12, dim: int = 64, dtype: str = "float32"
) -> PrimFunc:
    """TBG: transpose + batch matmul (attention scores QK^T with layout fold).

    S[b, h, i, j] = sum_k Q[b, i, h, k] * K[b, j, h, k]
    """
    Q = Buffer("Q", (b, seq, head, dim), dtype)
    K = Buffer("K", (b, seq, head, dim), dtype)
    S = Buffer("S", (b, head, seq, seq), dtype)
    blk = Block(
        name="tbg",
        axes=(
            Axis("bb", b),
            Axis("h", head),
            Axis("i", seq),
            Axis("j", seq),
            Axis("kk", dim, REDUCE),
        ),
        expr=mul(load(Q, "bb", "i", "h", "kk"), load(K, "bb", "j", "h", "kk")),
        write=S,
        write_indices=(_v("bb"), _v("h"), _v("i"), _v("j")),
        reduce_op="add",
    )
    return PrimFunc("tbg", (Q, K), (S,), (blk,))


# ---------------------------------------------------------------------------
# Convolution family (pad expressed as an inlinable Select block)
# ---------------------------------------------------------------------------


def _pad_block_2d(
    name: str, src: Buffer, pad: int, c: int, h: int, w: int, dtype: str
) -> Tuple[Block, Buffer]:
    """Xp[c, h, w] = (0 <= h-p < H && 0 <= w-p < W) ? X[c, h-p, w-p] : 0."""
    Hp, Wp = h + 2 * pad, w + 2 * pad
    Xp = Buffer(f"{src.name}_pad", (c, Hp, Wp), dtype)
    e_h = _v("h") - pad
    e_w = _v("w") - pad
    blk = Block(
        name=name,
        axes=(Axis("c", c), Axis("h", Hp), Axis("w", Wp)),
        expr=Select(
            bounds=((e_h, h), (e_w, w)),
            a=Load(src, (_v("c"), e_h, e_w)),
            b=Const(0.0),
        ),
        write=Xp,
        write_indices=(_v("c"), _v("h"), _v("w")),
    )
    return blk, Xp


@register("c1d")
def c1d(
    length: int = 256,
    cin: int = 64,
    cout: int = 128,
    ksize: int = 3,
    stride: int = 2,
    pad: int = 1,
    dtype: str = "float32",
) -> PrimFunc:
    """1-D convolution (paper C1D)."""
    X = Buffer("X", (cin, length), dtype)
    Wt = Buffer("W", (cout, cin, ksize), dtype)
    Lp = length + 2 * pad
    Lo = (Lp - ksize) // stride + 1
    Xp = Buffer("X_pad", (cin, Lp), dtype)
    e_l = _v("l") - pad
    pad_blk = Block(
        name="pad",
        axes=(Axis("c", cin), Axis("l", Lp)),
        expr=Select(((e_l, length),), Load(X, (_v("c"), e_l)), Const(0.0)),
        write=Xp,
        write_indices=(_v("c"), _v("l")),
    )
    Y = Buffer("Y", (cout, Lo), dtype)
    conv = Block(
        name="conv1d",
        axes=(
            Axis("co", cout),
            Axis("lo", Lo),
            Axis("ci", cin, REDUCE),
            Axis("rk", ksize, REDUCE),
        ),
        expr=mul(
            Load(Xp, (_v("ci"), _v("lo") * stride + _v("rk"))),
            load(Wt, "co", "ci", "rk"),
        ),
        write=Y,
        write_indices=(_v("co"), _v("lo")),
        reduce_op="add",
    )
    return PrimFunc("c1d", (X, Wt), (Y,), (pad_blk, conv))


def _conv2d_blocks(
    X: Buffer,
    Wt: Buffer,
    cin: int,
    cout: int,
    h: int,
    w: int,
    ksize: int,
    stride: int,
    pad: int,
    dilation: int,
    dtype: str,
    out_name: str = "Y",
):
    pad_blk, Xp = _pad_block_2d("pad", X, pad, cin, h, w, dtype)
    keff = (ksize - 1) * dilation + 1
    Ho = (h + 2 * pad - keff) // stride + 1
    Wo = (w + 2 * pad - keff) // stride + 1
    Y = Buffer(out_name, (cout, Ho, Wo), dtype)
    conv = Block(
        name="conv2d",
        axes=(
            Axis("co", cout),
            Axis("ho", Ho),
            Axis("wo", Wo),
            Axis("ci", cin, REDUCE),
            Axis("rh", ksize, REDUCE),
            Axis("rw", ksize, REDUCE),
        ),
        expr=mul(
            Load(
                Xp,
                (
                    _v("ci"),
                    _v("ho") * stride + _v("rh") * dilation,
                    _v("wo") * stride + _v("rw") * dilation,
                ),
            ),
            load(Wt, "co", "ci", "rh", "rw"),
        ),
        write=Y,
        write_indices=(_v("co"), _v("ho"), _v("wo")),
        reduce_op="add",
    )
    return pad_blk, conv, Y


@register("c2d")
def c2d(
    h: int = 224,
    w: int = 224,
    cin: int = 3,
    cout: int = 64,
    ksize: int = 7,
    stride: int = 2,
    pad: int = 3,
    dilation: int = 1,
    dtype: str = "float32",
) -> PrimFunc:
    """2-D convolution (paper C2D)."""
    X = Buffer("X", (cin, h, w), dtype)
    Wt = Buffer("W", (cout, cin, ksize, ksize), dtype)
    pad_blk, conv, Y = _conv2d_blocks(
        X, Wt, cin, cout, h, w, ksize, stride, pad, dilation, dtype
    )
    return PrimFunc("c2d", (X, Wt), (Y,), (pad_blk, conv))


@register("dil")
def dil(**kw) -> PrimFunc:
    """Dilated conv (paper DIL): C2D with dilation=2."""
    kw.setdefault("dilation", 2)
    f = c2d(**kw)
    return PrimFunc("dil", f.inputs, f.outputs, f.blocks)


@register("c3d")
def c3d(
    d: int = 16,
    h: int = 224,
    w: int = 224,
    cin: int = 3,
    cout: int = 64,
    ksize: int = 7,
    stride: int = 2,
    pad: int = 3,
    dtype: str = "float32",
) -> PrimFunc:
    """3-D convolution (paper C3D)."""
    X = Buffer("X", (cin, d, h, w), dtype)
    Wt = Buffer("W", (cout, cin, ksize, ksize, ksize), dtype)
    Dp, Hp, Wp = d + 2 * pad, h + 2 * pad, w + 2 * pad
    Xp = Buffer("X_pad", (cin, Dp, Hp, Wp), dtype)
    e_d, e_h, e_w = _v("dd") - pad, _v("h") - pad, _v("w") - pad
    pad_blk = Block(
        name="pad",
        axes=(Axis("c", cin), Axis("dd", Dp), Axis("h", Hp), Axis("w", Wp)),
        expr=Select(
            ((e_d, d), (e_h, h), (e_w, w)),
            Load(X, (_v("c"), e_d, e_h, e_w)),
            Const(0.0),
        ),
        write=Xp,
        write_indices=(_v("c"), _v("dd"), _v("h"), _v("w")),
    )
    Do = (Dp - ksize) // stride + 1
    Ho = (Hp - ksize) // stride + 1
    Wo = (Wp - ksize) // stride + 1
    Y = Buffer("Y", (cout, Do, Ho, Wo), dtype)
    conv = Block(
        name="conv3d",
        axes=(
            Axis("co", cout),
            Axis("do", Do),
            Axis("ho", Ho),
            Axis("wo", Wo),
            Axis("ci", cin, REDUCE),
            Axis("rd", ksize, REDUCE),
            Axis("rh", ksize, REDUCE),
            Axis("rw", ksize, REDUCE),
        ),
        expr=mul(
            Load(
                Xp,
                (
                    _v("ci"),
                    _v("do") * stride + _v("rd"),
                    _v("ho") * stride + _v("rh"),
                    _v("wo") * stride + _v("rw"),
                ),
            ),
            load(Wt, "co", "ci", "rd", "rh", "rw"),
        ),
        write=Y,
        write_indices=(_v("co"), _v("do"), _v("ho"), _v("wo")),
        reduce_op="add",
    )
    return PrimFunc("c3d", (X, Wt), (Y,), (pad_blk, conv))


@register("dep")
def dep(
    h: int = 112,
    w: int = 112,
    c: int = 32,
    ksize: int = 3,
    stride: int = 1,
    pad: int = 1,
    dtype: str = "float32",
) -> PrimFunc:
    """Depthwise conv (paper DEP)."""
    X = Buffer("X", (c, h, w), dtype)
    Wt = Buffer("W", (c, ksize, ksize), dtype)
    pad_blk, Xp = _pad_block_2d("pad", X, pad, c, h, w, dtype)
    Ho = (h + 2 * pad - ksize) // stride + 1
    Wo = (w + 2 * pad - ksize) // stride + 1
    Y = Buffer("Y", (c, Ho, Wo), dtype)
    conv = Block(
        name="depthwise",
        axes=(
            Axis("cc", c),
            Axis("ho", Ho),
            Axis("wo", Wo),
            Axis("rh", ksize, REDUCE),
            Axis("rw", ksize, REDUCE),
        ),
        expr=mul(
            Load(
                Xp,
                (_v("cc"), _v("ho") * stride + _v("rh"), _v("wo") * stride + _v("rw")),
            ),
            load(Wt, "cc", "rh", "rw"),
        ),
        write=Y,
        write_indices=(_v("cc"), _v("ho"), _v("wo")),
        reduce_op="add",
    )
    return PrimFunc("dep", (X, Wt), (Y,), (pad_blk, conv))


@register("grp")
def grp(
    h: int = 56,
    w: int = 56,
    cin: int = 64,
    cout: int = 128,
    ksize: int = 3,
    stride: int = 2,
    pad: int = 1,
    groups: int = 4,
    dtype: str = "float32",
) -> PrimFunc:
    """Grouped conv (paper GRP) with an explicit group axis."""
    cig, cog = cin // groups, cout // groups
    X = Buffer("X", (groups, cig, h, w), dtype)
    Wt = Buffer("W", (groups, cog, cig, ksize, ksize), dtype)
    Hp, Wp = h + 2 * pad, w + 2 * pad
    Xp = Buffer("X_pad", (groups, cig, Hp, Wp), dtype)
    e_h, e_w = _v("h") - pad, _v("w") - pad
    pad_blk = Block(
        name="pad",
        axes=(Axis("g", groups), Axis("c", cig), Axis("h", Hp), Axis("w", Wp)),
        expr=Select(
            ((e_h, h), (e_w, w)), Load(X, (_v("g"), _v("c"), e_h, e_w)), Const(0.0)
        ),
        write=Xp,
        write_indices=(_v("g"), _v("c"), _v("h"), _v("w")),
    )
    Ho = (Hp - ksize) // stride + 1
    Wo = (Wp - ksize) // stride + 1
    Y = Buffer("Y", (groups, cog, Ho, Wo), dtype)
    conv = Block(
        name="group_conv",
        axes=(
            Axis("g", groups),
            Axis("co", cog),
            Axis("ho", Ho),
            Axis("wo", Wo),
            Axis("ci", cig, REDUCE),
            Axis("rh", ksize, REDUCE),
            Axis("rw", ksize, REDUCE),
        ),
        expr=mul(
            Load(
                Xp,
                (
                    _v("g"),
                    _v("ci"),
                    _v("ho") * stride + _v("rh"),
                    _v("wo") * stride + _v("rw"),
                ),
            ),
            load(Wt, "g", "co", "ci", "rh", "rw"),
        ),
        write=Y,
        write_indices=(_v("g"), _v("co"), _v("ho"), _v("wo")),
        reduce_op="add",
    )
    return PrimFunc("grp", (X, Wt), (Y,), (pad_blk, conv))


@register("t2d")
def t2d(
    h: int = 4,
    w: int = 4,
    cin: int = 512,
    cout: int = 256,
    ksize: int = 4,
    stride: int = 2,
    pad: int = 1,
    dtype: str = "float32",
) -> PrimFunc:
    """Transposed 2-D conv (paper T2D) via zero-upsampling + conv.

    Step 1: scatter X into a zero-dilated buffer (stride-2 write indices).
    Step 2: pad by (ksize - 1 - pad) and run a regular conv with flipped W.
    """
    X = Buffer("X", (cin, h, w), dtype)
    Wt = Buffer("W", (cin, cout, ksize, ksize), dtype)
    Hu, Wu = (h - 1) * stride + 1, (w - 1) * stride + 1
    Xu = Buffer("X_up", (cin, Hu, Wu), dtype)
    up = Block(
        name="upsample",
        axes=(Axis("c", cin), Axis("i", h), Axis("j", w)),
        expr=load(X, "c", "i", "j"),
        write=Xu,
        write_indices=(_v("c"), _v("i") * stride, _v("j") * stride),
    )
    p2 = ksize - 1 - pad
    pad_blk, Xp = _pad_block_2d("pad", Xu, p2, cin, Hu, Wu, dtype)
    Ho = Hu + 2 * p2 - ksize + 1  # = (h-1)*s - 2p + k
    Wo = Wu + 2 * p2 - ksize + 1
    Y = Buffer("Y", (cout, Ho, Wo), dtype)
    conv = Block(
        name="t2d_conv",
        axes=(
            Axis("co", cout),
            Axis("ho", Ho),
            Axis("wo", Wo),
            Axis("ci", cin, REDUCE),
            Axis("rh", ksize, REDUCE),
            Axis("rw", ksize, REDUCE),
        ),
        # flipped kernel: W[ci, co, k-1-rh, k-1-rw]
        expr=mul(
            Load(Xp, (_v("ci"), _v("ho") + _v("rh"), _v("wo") + _v("rw"))),
            Load(
                Wt,
                (
                    _v("ci"),
                    _v("co"),
                    _v("rh") * -1 + (ksize - 1),
                    _v("rw") * -1 + (ksize - 1),
                ),
            ),
        ),
        write=Y,
        write_indices=(_v("co"), _v("ho"), _v("wo")),
        reduce_op="add",
    )
    return PrimFunc("t2d", (X, Wt), (Y,), (up, pad_blk, conv))


@register("cbr")
def cbr(
    h: int = 224,
    w: int = 224,
    cin: int = 3,
    cout: int = 64,
    ksize: int = 7,
    stride: int = 2,
    pad: int = 3,
    dtype: str = "float32",
) -> PrimFunc:
    """Conv2D + BatchNorm(inference: scale/shift) + ReLU (paper CBR)."""
    X = Buffer("X", (cin, h, w), dtype)
    Wt = Buffer("W", (cout, cin, ksize, ksize), dtype)
    scale = Buffer("scale", (cout,), dtype)
    shift = Buffer("shift", (cout,), dtype)
    pad_blk, conv, Y = _conv2d_blocks(
        X, Wt, cin, cout, h, w, ksize, stride, pad, 1, dtype, out_name="Yc"
    )
    Ho, Wo = Y.shape[1], Y.shape[2]
    Z = Buffer("Y", (cout, Ho, Wo), dtype)
    bn_relu = Block(
        name="bn_relu",
        axes=(Axis("co", cout), Axis("ho", Ho), Axis("wo", Wo)),
        expr=UnOp(
            "relu",
            add(
                mul(load(Y, "co", "ho", "wo"), load(scale, "co")),
                load(shift, "co"),
            ),
        ),
        write=Z,
        write_indices=(_v("co"), _v("ho"), _v("wo")),
    )
    return PrimFunc("cbr", (X, Wt, scale, shift), (Z,), (pad_blk, conv, bn_relu))


# ---------------------------------------------------------------------------
# Reduction / normalization family
# ---------------------------------------------------------------------------


@register("nrm")
def nrm(m: int = 256, n: int = 256, dtype: str = "float32") -> PrimFunc:
    """Matrix Frobenius norm (paper NRM): y = sqrt(sum(A ** 2))."""
    A = Buffer("A", (m, n), dtype)
    S = Buffer("S", (1,), dtype)
    Y = Buffer("Y", (1,), dtype)
    sumsq = Block(
        name="sumsq",
        axes=(Axis("u", 1), Axis("i", m, REDUCE), Axis("j", n, REDUCE)),
        expr=mul(load(A, "i", "j"), load(A, "i", "j")),
        write=S,
        write_indices=(_v("u"),),
        reduce_op="add",
    )
    sqrt_blk = Block(
        name="sqrt",
        axes=(Axis("u", 1),),
        expr=UnOp("sqrt", load(S, "u")),
        write=Y,
        write_indices=(_v("u"),),
    )
    return PrimFunc("nrm", (A,), (Y,), (sumsq, sqrt_blk))


@register("sfm")
def sfm(m: int = 256, n: int = 256, dtype: str = "float32") -> PrimFunc:
    """Row softmax (paper SFM): 4 blocks — rowmax, exp, rowsum, divide."""
    A = Buffer("A", (m, n), dtype)
    Mx = Buffer("rowmax", (m,), dtype)
    E = Buffer("expv", (m, n), dtype)
    Sm = Buffer("rowsum", (m,), dtype)
    Y = Buffer("Y", (m, n), dtype)
    rowmax = Block(
        name="rowmax",
        axes=(Axis("i", m), Axis("j", n, REDUCE)),
        expr=load(A, "i", "j"),
        write=Mx,
        write_indices=(_v("i"),),
        reduce_op="max",
        init=-1e30,
    )
    expv = Block(
        name="expv",
        axes=(Axis("i", m), Axis("j", n)),
        expr=UnOp("exp", BinOp("sub", load(A, "i", "j"), load(Mx, "i"))),
        write=E,
        write_indices=(_v("i"), _v("j")),
    )
    rowsum = Block(
        name="rowsum",
        axes=(Axis("i", m), Axis("j", n, REDUCE)),
        expr=load(E, "i", "j"),
        write=Sm,
        write_indices=(_v("i"),),
        reduce_op="add",
    )
    out = Block(
        name="divide",
        axes=(Axis("i", m), Axis("j", n)),
        expr=BinOp("div", load(E, "i", "j"), load(Sm, "i")),
        write=Y,
        write_indices=(_v("i"), _v("j")),
    )
    return PrimFunc("sfm", (A,), (Y,), (rowmax, expv, rowsum, out))


@register("relu")
def relu(m: int = 1024, n: int = 1024, dtype: str = "float32") -> PrimFunc:
    """Elementwise ReLU — the paper's Figure 2/3 running example."""
    A = Buffer("A", (m, n), dtype)
    B = Buffer("B", (m, n), dtype)
    blk = Block(
        name="relu",
        axes=(Axis("i", m), Axis("j", n)),
        expr=UnOp("relu", load(A, "i", "j")),
        write=B,
        write_indices=(_v("i"), _v("j")),
    )
    return PrimFunc("relu", (A,), (B,), (blk,))


@register("rmsnorm")
def rmsnorm(
    tokens: int = 128, d: int = 768, eps: float = 1e-6, dtype: str = "float32"
) -> PrimFunc:
    """RMS norm over the last axis — the model-integration norm workload.

    Y[i, j] = X[i, j] * rsqrt(mean_j(X[i, :]^2) + eps) * W[j]
    """
    X = Buffer("X", (tokens, d), dtype)
    W = Buffer("W", (d,), dtype)
    S = Buffer("S", (tokens,), dtype)
    Y = Buffer("Y", (tokens, d), dtype)
    sumsq = Block(
        name="sumsq",
        axes=(Axis("i", tokens), Axis("j", d, REDUCE)),
        expr=mul(load(X, "i", "j"), load(X, "i", "j")),
        write=S,
        write_indices=(_v("i"),),
        reduce_op="add",
    )
    scale = Block(
        name="scale",
        axes=(Axis("i", tokens), Axis("j", d)),
        expr=mul(
            mul(
                load(X, "i", "j"),
                UnOp("rsqrt", add(mul(load(S, "i"), const(1.0 / d)), const(eps))),
            ),
            load(W, "j"),
        ),
        write=Y,
        write_indices=(_v("i"), _v("j")),
    )
    return PrimFunc("rmsnorm", (X, W), (Y,), (sumsq, scale))


@register("attention")
def attention(
    b: int = 1,
    h: int = 4,
    kvh: int = 0,
    s: int = 128,
    d: int = 64,
    causal: int = 1,
    window: int = 0,
    softcap: float = 0.0,
    dtype: str = "float32",
) -> PrimFunc:
    """Fused scaled-dot-product attention — the model-integration workload.

    GQA layout: Q is (b, kvh, g, s, d) with g = h // kvh query heads per
    kv head, K/V are (b, kvh, s, d) — the canonical grouping the model's
    attention hook reshapes into, so no head repetition is materialized
    and every load is a plain axis index (schedulable by the generic
    modules).  Blocks: scores (matmul), scale/softcap + mask, the 4-block
    row softmax, and the value contraction (matmul).

    Masking is part of the program, not a runtime flag: ``window > 0``
    bakes a sliding-window causal mask (``0 <= i - j < window``),
    ``causal`` alone a triangular mask (``0 <= i - j < s``), neither a
    mask-free global program.  ``softcap > 0`` adds the gemma-2 logit
    cap.  The variant is encoded in the PrimFunc name
    (``attention_c{causal}_w{window}[_t{softcap}]``) so backends can
    recover it from a bare Schedule.

    The tunable payload: the (i, j) tile extents of the ``scores`` block
    are the flash-attention ``(block_q, block_kv)`` — the Pallas backend
    reads them off the tuned trace exactly like the matmul (bm, bn, bk).
    """
    kvh = int(kvh) or int(h)
    if h % kvh:
        raise ValueError(f"attention: h={h} not divisible by kvh={kvh}")
    g = h // kvh
    scale = 1.0 / float(d) ** 0.5
    softcap = float(softcap)
    Q = Buffer("Q", (b, kvh, g, s, d), dtype)
    K = Buffer("K", (b, kvh, s, d), dtype)
    V = Buffer("V", (b, kvh, s, d), dtype)
    S = Buffer("S", (b, kvh, g, s, s), dtype)
    spatial = (Axis("bb", b), Axis("kv", kvh), Axis("gg", g), Axis("i", s))
    scores = Block(
        name="scores",
        axes=spatial + (Axis("j", s), Axis("dd", d, REDUCE)),
        expr=mul(
            load(Q, "bb", "kv", "gg", "i", "dd"), load(K, "bb", "kv", "j", "dd")
        ),
        write=S,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i"), _v("j")),
        reduce_op="add",
    )
    if softcap:
        scored: Expr = mul(
            const(softcap),
            UnOp(
                "tanh",
                mul(load(S, "bb", "kv", "gg", "i", "j"), const(scale / softcap)),
            ),
        )
    else:
        scored = mul(load(S, "bb", "kv", "gg", "i", "j"), const(scale))
    span = int(window) if window else (s if causal else 0)
    if span:
        masked: Expr = Select(
            bounds=((_v("i") - _v("j"), span),), a=scored, b=Const(-1e30)
        )
    else:
        masked = scored
    M = Buffer("M", (b, kvh, g, s, s), dtype)
    mask_blk = Block(
        name="mask",
        axes=spatial + (Axis("j", s),),
        expr=masked,
        write=M,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i"), _v("j")),
    )
    Mx = Buffer("rowmax", (b, kvh, g, s), dtype)
    E = Buffer("expv", (b, kvh, g, s, s), dtype)
    Sm = Buffer("rowsum", (b, kvh, g, s), dtype)
    P = Buffer("P", (b, kvh, g, s, s), dtype)
    O = Buffer("O", (b, kvh, g, s, d), dtype)
    rowmax = Block(
        name="rowmax",
        axes=spatial + (Axis("j", s, REDUCE),),
        expr=load(M, "bb", "kv", "gg", "i", "j"),
        write=Mx,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i")),
        reduce_op="max",
        init=-1e30,
    )
    expv = Block(
        name="expv",
        axes=spatial + (Axis("j", s),),
        expr=UnOp(
            "exp",
            BinOp(
                "sub",
                load(M, "bb", "kv", "gg", "i", "j"),
                load(Mx, "bb", "kv", "gg", "i"),
            ),
        ),
        write=E,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i"), _v("j")),
    )
    rowsum = Block(
        name="rowsum",
        axes=spatial + (Axis("j", s, REDUCE),),
        expr=load(E, "bb", "kv", "gg", "i", "j"),
        write=Sm,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i")),
        reduce_op="add",
    )
    divide = Block(
        name="divide",
        axes=spatial + (Axis("j", s),),
        expr=BinOp(
            "div",
            load(E, "bb", "kv", "gg", "i", "j"),
            load(Sm, "bb", "kv", "gg", "i"),
        ),
        write=P,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i"), _v("j")),
    )
    out = Block(
        name="out",
        axes=spatial + (Axis("d2", d), Axis("j", s, REDUCE)),
        expr=mul(
            load(P, "bb", "kv", "gg", "i", "j"), load(V, "bb", "kv", "j", "d2")
        ),
        write=O,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("i"), _v("d2")),
        reduce_op="add",
    )
    name = f"attention_c{int(bool(causal))}_w{int(window)}"
    if softcap:
        name += f"_t{softcap:g}"
    return PrimFunc(
        name,
        (Q, K, V),
        (O,),
        (scores, mask_blk, rowmax, expv, rowsum, divide, out),
    )


@register("attention_decode")
def attention_decode(
    b: int = 4,
    h: int = 4,
    kvh: int = 0,
    t: int = 128,
    d: int = 64,
    softcap: float = 0.0,
    dtype: str = "float32",
) -> PrimFunc:
    """Single-token decode attention against a length-``t`` KV cache.

    The serving-decode counterpart of :func:`attention`: one query token
    per sequence (``s_q = 1``, so the query drops its sequence axis — Q is
    (b, kvh, g, d)) attends to the full fixed-shape cache K/V
    (b, kvh, t, d).  The program is static in the cache length ``t``; the
    *dynamic* part of decode — per-slot valid lengths, ring-buffer
    wraparound, sliding windows — arrives as data through the additive
    ``BIAS`` (b, t) input (0 for attendable positions, -1e30 for masked),
    which the dispatch layer computes from the traced positions at call
    time.  That is what lets one tuned kernel serve every decode step of a
    continuous-batching scheduler regardless of where each slot is in its
    sequence.

    Blocks mirror :func:`attention`: scores (matmul over d), scale /
    softcap + bias add, the 4-block row softmax over ``t``, and the value
    contraction.  The tunable payload is the ``j`` (kv) tile of the
    ``scores`` block — the decode flash kernel's ``block_kv``.
    """
    kvh = int(kvh) or int(h)
    if h % kvh:
        raise ValueError(f"attention_decode: h={h} not divisible by kvh={kvh}")
    g = h // kvh
    scale = 1.0 / float(d) ** 0.5
    softcap = float(softcap)
    Q = Buffer("Q", (b, kvh, g, d), dtype)
    K = Buffer("K", (b, kvh, t, d), dtype)
    V = Buffer("V", (b, kvh, t, d), dtype)
    BIAS = Buffer("BIAS", (b, t), dtype)
    S = Buffer("S", (b, kvh, g, t), dtype)
    spatial = (Axis("bb", b), Axis("kv", kvh), Axis("gg", g))
    scores = Block(
        name="scores",
        axes=spatial + (Axis("j", t), Axis("dd", d, REDUCE)),
        expr=mul(load(Q, "bb", "kv", "gg", "dd"), load(K, "bb", "kv", "j", "dd")),
        write=S,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("j")),
        reduce_op="add",
    )
    if softcap:
        scored: Expr = mul(
            const(softcap),
            UnOp(
                "tanh",
                mul(load(S, "bb", "kv", "gg", "j"), const(scale / softcap)),
            ),
        )
    else:
        scored = mul(load(S, "bb", "kv", "gg", "j"), const(scale))
    M = Buffer("M", (b, kvh, g, t), dtype)
    mask_blk = Block(
        name="mask",
        axes=spatial + (Axis("j", t),),
        expr=add(scored, load(BIAS, "bb", "j")),
        write=M,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("j")),
    )
    Mx = Buffer("rowmax", (b, kvh, g), dtype)
    E = Buffer("expv", (b, kvh, g, t), dtype)
    Sm = Buffer("rowsum", (b, kvh, g), dtype)
    P = Buffer("P", (b, kvh, g, t), dtype)
    O = Buffer("O", (b, kvh, g, d), dtype)
    rowmax = Block(
        name="rowmax",
        axes=spatial + (Axis("j", t, REDUCE),),
        expr=load(M, "bb", "kv", "gg", "j"),
        write=Mx,
        write_indices=(_v("bb"), _v("kv"), _v("gg")),
        reduce_op="max",
        init=-1e30,
    )
    expv = Block(
        name="expv",
        axes=spatial + (Axis("j", t),),
        expr=UnOp(
            "exp",
            BinOp(
                "sub",
                load(M, "bb", "kv", "gg", "j"),
                load(Mx, "bb", "kv", "gg"),
            ),
        ),
        write=E,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("j")),
    )
    rowsum = Block(
        name="rowsum",
        axes=spatial + (Axis("j", t, REDUCE),),
        expr=load(E, "bb", "kv", "gg", "j"),
        write=Sm,
        write_indices=(_v("bb"), _v("kv"), _v("gg")),
        reduce_op="add",
    )
    divide = Block(
        name="divide",
        axes=spatial + (Axis("j", t),),
        expr=BinOp(
            "div",
            load(E, "bb", "kv", "gg", "j"),
            load(Sm, "bb", "kv", "gg"),
        ),
        write=P,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("j")),
    )
    out = Block(
        name="out",
        axes=spatial + (Axis("d2", d), Axis("j", t, REDUCE)),
        expr=mul(load(P, "bb", "kv", "gg", "j"), load(V, "bb", "kv", "j", "d2")),
        write=O,
        write_indices=(_v("bb"), _v("kv"), _v("gg"), _v("d2")),
        reduce_op="add",
    )
    name = "attention_decode"
    if softcap:
        name += f"_t{softcap:g}"
    return PrimFunc(
        name,
        (Q, K, V, BIAS),
        (O,),
        (scores, mask_blk, rowmax, expv, rowsum, divide, out),
    )


@register("fused_dense")
def fused_dense(
    m: int = 128, n: int = 3072, k: int = 768, dtype: str = "float32"
) -> PrimFunc:
    """The BERT fused-dense subgraph used in Fig 10 (dense+bias+gelu)."""
    return dense(m=m, n=n, k=k, epilogue="bias_gelu", dtype=dtype)


# paper Figure 8 workload list with default (paper A.2) shapes
PAPER_OPERATORS = [
    "c1d",
    "c2d",
    "c3d",
    "dep",
    "dil",
    "gmm",
    "grp",
    "t2d",
    "cbr",
    "tbg",
    "nrm",
    "sfm",
]

# reduced shapes for fast tests / smoke benchmarks of the same workloads
REDUCED_KWARGS: Dict[str, Dict] = {
    "c1d": dict(length=32, cin=4, cout=8),
    "c2d": dict(h=16, w=16, cin=3, cout=8, ksize=3, stride=1, pad=1),
    "c3d": dict(d=4, h=8, w=8, cin=2, cout=4, ksize=3, stride=1, pad=1),
    "dep": dict(h=16, w=16, c=4),
    "dil": dict(h=16, w=16, cin=2, cout=4, ksize=3, stride=1, pad=2, dilation=2),
    "gmm": dict(n=32, m=32, k=32),
    "grp": dict(h=8, w=8, cin=8, cout=16, groups=4, ksize=3, stride=1, pad=1),
    "t2d": dict(h=4, w=4, cin=8, cout=4),
    "cbr": dict(h=16, w=16, cin=3, cout=8, ksize=3, stride=1, pad=1),
    "tbg": dict(seq=16, head=2, dim=8),
    "nrm": dict(m=32, n=32),
    "sfm": dict(m=32, n=32),
    "relu": dict(m=32, n=32),
    "dense": dict(m=32, n=32, k=32),
    "batch_matmul": dict(b=2, m=16, n=16, k=16),
    "fused_dense": dict(m=32, n=64, k=32),
    "rmsnorm": dict(tokens=16, d=32),
    "attention": dict(b=1, h=2, kvh=1, s=16, d=8),
    "attention_decode": dict(b=2, h=2, kvh=1, t=16, d=8),
}
