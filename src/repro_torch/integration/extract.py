"""Automatic task extraction from whole models (Ansor-style, end-to-end).

The JAX package traces the forward pass with ``jax.make_jaxpr`` and walks
the jaxpr.  Here the forward runs once on ``device="meta"`` tensors, which
carry shapes and allocate nothing even at full model width, while a
:class:`SiteRecorder` is active; the model's hooks report every call site
to it, mapped to registered tensor-program workloads:

* ``dense_op`` / ``unembed`` -> ``dense`` (m = rows of x, the tied unembed
  read transposed);
* ``bmm_op``                 -> ``batch_matmul`` (the attention score and
  value contractions in canonical layout, and the MoE's three expert
  products on its (E, C, D) buffer);
* ``chunked_attention``      -> ``attention`` (see :func:`attention_sites`);
* ``decode_attention``       -> ``attention_decode`` (see
  :func:`decode_attention_sites`), plus its plain path's two cache
  contractions as ``batch_matmul`` sites, which the reference's jaxpr walk
  also finds;
* ``rmsnorm``                -> ``rmsnorm`` over (tokens, d), where the
  reference finds the norm's one ``rsqrt``;
* ``chunked_attention``'s plain path -> ``sfm`` (row softmax) over the
  scores of one kv chunk, once per chunk step, where the reference finds
  the ``exp`` of its online softmax.  Not dispatchable: the site is a
  tuning target only, as in the reference;
* the Mamba-2 SSD mixer's plain einsums and exps (its projections, its
  chunked scan, its decode recurrence) and the MoE router's einsum and
  softmax exp, which the reference writes as ``jnp.einsum`` and
  ``jnp.exp`` (``jax.nn.softmax``) and whose jaxpr its walk reads: the
  layer reports each with its operand shapes, and :func:`einsum_sites` /
  :func:`exp_site` derive the same ``dense`` / ``batch_matmul`` / ``sfm``
  sites.

Decode extraction (:func:`extract_decode_tasks`) records one
``decode_step`` in the continuous-batching arena layout and, for the paged
or chunked serving tier, one ``serve_step`` tick.

The weight of a site is the number of times its hook ran: 30 layers give
weight 30, as the reference's scan trip count does.  Tasks dedup by the
structural hash of the instantiated workload PrimFunc, summing weights,
so the keys and weights equal the reference's.
"""

from __future__ import annotations

import bisect
import itertools
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..configs.base import ModelConfig
from ..core.workloads import get_workload
from ..obs import emit, metrics, trace_enabled
from ..search.database import workload_key
from ..search.measure.hashing import primfunc_structural_hash
from ..search.task_scheduler import TuneTask

TOKEN_TILE = 128  # default representative token block (batch=1 x seq=128)

# ops the extractor understands; everything else is skipped
EXTRACTABLE_OPS = ("dense", "batch_matmul", "rmsnorm", "sfm", "attention")
# ops extracted from the decode trace (serving): dense/bmm/rmsnorm keyed on
# m = batch (or batch x chunk in a serve tick), plus the single-token
# cache-attention workload.  sfm is omitted — decode softmax rows ride
# inside attention_decode.
DECODE_EXTRACTABLE_OPS = (
    "dense", "batch_matmul", "rmsnorm", "attention_decode",
)


def _skip(site: str, reason: str) -> None:
    """Dropped-site telemetry: every site the extractor cannot express is
    dispatch coverage lost, so it must be visible."""
    metrics().inc("extract.skip", site=site, reason=reason)
    if trace_enabled():
        emit("extract.skip", site=site, reason=reason)


@dataclass
class TaskSite:
    """One hook call site mapped to a workload, pre-dedup.

    ``dispatchable`` marks sites the dispatch layer can serve (``x @ w``
    with w stored (k, n) or read transposed, canonical-layout
    ``batch_matmul``, static-shape attention, rmsnorm); an ``sfm`` site is
    a tuning target only.
    """

    op: str
    kwargs: Dict[str, Any]
    count: float  # occurrence count
    dispatchable: bool = False


@dataclass
class ExtractedTask:
    """A deduplicated, weighted tuning task."""

    key: str
    op: str
    kwargs: Dict[str, Any]
    weight: float
    struct_hash: str
    flops: int
    dispatchable: bool = False

    def to_tune_task(self, use_mxu: bool = True) -> TuneTask:
        func = get_workload(self.op, **self.kwargs)
        mxu = use_mxu and self.op in (
            "dense", "batch_matmul", "attention", "attention_decode",
        )
        return TuneTask(key=self.key, func=func, weight=self.weight, use_mxu=mxu)


# ---------------------------------------------------------------------------
# Site recording (called from the model hooks)
# ---------------------------------------------------------------------------

_REC_TLS = threading.local()


def current_recorder() -> Optional["SiteRecorder"]:
    """The active recorder, read by the hooks in ``models.layers``."""
    stack = getattr(_REC_TLS, "stack", None)
    return stack[-1] if stack else None


@dataclass
class SiteRecorder:
    """Collects hook call sites while the model runs on meta tensors:
    matrix products, norms and softmax rows as ready :class:`TaskSite`\\ s,
    attention calls as raw records for :func:`attention_sites`."""

    op_sites: List[TaskSite] = field(default_factory=list)
    sites: List[Dict[str, Any]] = field(default_factory=list)

    def add_site(self, op: str, dispatchable: bool = True, **kwargs: Any) -> None:
        self.op_sites.append(TaskSite(op, dict(kwargs), 1.0, dispatchable=dispatchable))

    def add_einsum(self, spec: str, *shapes) -> None:
        """The sites of a plain ``einsum`` the reference writes as
        ``jnp.einsum`` (see :func:`einsum_sites`)."""
        self.op_sites.extend(einsum_sites(spec, *shapes))

    def add_exp(self, shape) -> None:
        """The ``sfm`` site of an elementwise ``exp`` the reference's jaxpr
        walk finds (see :func:`exp_site`)."""
        site = exp_site(shape)
        if site is not None:
            self.op_sites.append(site)

    def add(
        self, *, q_shape, kvh, kv_seq, causal, window, softcap, scale,
        q_offset, kind: str = "prefill",
    ) -> None:
        self.sites.append(
            dict(
                q_shape=tuple(int(x) for x in q_shape),
                kvh=int(kvh),
                kv_seq=int(kv_seq),
                causal=bool(causal),
                window=int(window) if window is not None else 0,
                softcap=float(softcap) if softcap else 0.0,
                scale=(None if scale is None else float(scale)),
                q_offset=int(q_offset),
                kind=kind,
            )
        )

    def __enter__(self) -> "SiteRecorder":
        stack = getattr(_REC_TLS, "stack", None)
        if stack is None:
            stack = _REC_TLS.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _REC_TLS.stack.pop()


# ---------------------------------------------------------------------------
# Sites of plain einsums and exps (the reference's jaxpr walk)
# ---------------------------------------------------------------------------
#
# The reference finds a ``dot_general`` site for every pairwise contraction
# ``jnp.einsum`` traces to and an ``sfm`` site for every ``exp`` over at
# least two axes.  Where the reference computes with plain ``jnp.einsum``
# (the SSD mixer and its chunked scan), the port reports the same sites
# from the operand shapes: the contraction order opt_einsum's "optimal"
# path picks for JAX (``optimize="auto"``, at most four operands), each
# pair's operands in the order JAX's ``_einsum`` hands them to
# ``lax.dot_general``, and the reference's rule for what a dot_general
# site is.


def _prod(xs: Iterable[int]) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _optimal_path(terms: List[str], out: str, sizes: Dict[str, int]) -> List[Tuple[int, int]]:
    """opt_einsum's ``optimal`` pairwise order (no memory limit), as a
    linear path: the contraction of least flop count, ties to the first
    found.  Like opt_einsum it caches each pair's result and cost by the
    pair's index sets alone, whatever else remains to be contracted, so a
    later step may reuse a cost computed for an earlier one; the order it
    picks follows from that, and so does JAX's."""
    inputs = tuple(frozenset(t) for t in terms)
    output = frozenset(out)
    best = {"flops": float("inf"), "path": ()}
    cache: Dict[Tuple[frozenset, frozenset], Tuple[frozenset, int]] = {}

    def walk(path, remaining, inputs, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(sorted(remaining), 2):
            key = (inputs[i], inputs[j])
            if key not in cache:
                k1, k2 = key
                keep = output.union(*(inputs[r] for r in remaining - {i, j}))
                either = k1 | k2
                inner = bool((k1 & k2) - keep)
                cache[key] = (either & keep,
                              _prod(sizes[c] for c in either) * (2 if inner else 1))
            k12, cost = cache[key]
            if flops + cost >= best["flops"]:
                continue
            walk(path + ((i, j),), remaining - {i, j} | {len(inputs)},
                 inputs + (k12,), flops + cost)

    walk((), set(range(len(inputs))), inputs, 0)
    # static single assignment ids -> positions in the shrinking list
    ids = list(range(len(terms)))
    linear = []
    ssa = len(terms)
    for pair in best["path"]:
        con = sorted(bisect.bisect_left(ids, s) for s in pair)
        for j in reversed(con):
            ids.pop(j)
        ids.append(ssa)
        ssa += 1
        linear.append(tuple(con))
    return linear


def _dot_site(lhs, rhs, lc, rc, lb, rb) -> TaskSite:
    """The reference's site of one ``dot_general`` (its
    ``integration/extract.py:_dot_site``): ``batch_matmul`` when the batch
    dims multiply past 1, else ``dense``; dispatchable in the layouts its
    hooks serve."""
    b = _prod(lhs[i] for i in lb)
    k = _prod(lhs[i] for i in lc)
    m = _prod(lhs[i] for i in range(len(lhs)) if i not in set(lb) | set(lc))
    n = _prod(rhs[i] for i in range(len(rhs)) if i not in set(rb) | set(rc))
    if b > 1:
        r = len(lhs)
        disp = (
            len(rhs) == r
            and tuple(lb) == tuple(range(r - 2))
            and tuple(rb) == tuple(range(r - 2))
            and tuple(lc) == (r - 1,)
            and tuple(rc) == (r - 2,)
        )
        return TaskSite("batch_matmul", dict(b=b, m=m, n=n, k=k), 1.0,
                        dispatchable=disp)
    disp = (
        len(rhs) == 2
        and tuple(rc) in ((0,), (1,))
        and tuple(lc) == tuple(range(len(lhs) - len(lc), len(lhs)))
    )
    return TaskSite("dense", dict(m=m, n=n, k=k), 1.0, dispatchable=disp)


def _pair_site(lhs_names, lhs, rhs_names, rhs, contracted, result) -> TaskSite:
    """The dot_general JAX's ``_einsum`` emits for one pair: indices
    contracted on one side only summed out first, batch dims in result
    order, and the operands swapped when that spares a transpose."""

    def drop(names, shape, gone):
        return ("".join(c for c in names if c not in gone),
                tuple(s for c, s in zip(names, shape) if c not in gone))

    contracted = sorted(contracted)
    lhs_names, lhs = drop(lhs_names, lhs, {c for c in contracted if c not in rhs_names})
    rhs_names, rhs = drop(rhs_names, rhs, {c for c in contracted if c not in lhs_names})
    contracted = [c for c in contracted if c in lhs_names or c in rhs_names]
    batch = [c for c in result if c in lhs_names and c in rhs_names]
    lb = tuple(lhs_names.index(c) for c in batch)
    rb = tuple(rhs_names.index(c) for c in batch)
    lc = tuple(lhs_names.index(c) for c in contracted)
    rc = tuple(rhs_names.index(c) for c in contracted)
    gone = set(batch) | set(contracted)
    rest_l = "".join(c for c in lhs_names if c not in gone)
    rest_r = "".join(c for c in rhs_names if c not in gone)
    if "".join(batch) + rest_r + rest_l == result:
        return _dot_site(rhs, lhs, rc, lc, rb, lb)
    return _dot_site(lhs, rhs, lc, rc, lb, rb)


def einsum_sites(spec: str, *shapes) -> List[TaskSite]:
    """The ``dense`` / ``batch_matmul`` sites the reference's jaxpr walk
    finds in ``jnp.einsum(spec, *operands)`` with operands of ``shapes``."""
    ins, out = spec.replace(" ", "").split("->")
    names = ins.split(",")
    if len(names) != len(shapes) or not 2 <= len(names) <= 4:
        raise ValueError(f"einsum_sites: {spec!r} with {len(shapes)} operands")
    sizes: Dict[str, int] = {}
    for t, shape in zip(names, shapes):
        if len(set(t)) != len(t):
            raise ValueError(f"einsum_sites: repeated index in {t!r}")
        for c, n in zip(t, shape):
            if sizes.setdefault(c, int(n)) != int(n):
                raise ValueError(f"einsum_sites: index {c!r} of sizes "
                                 f"{sizes[c]} and {n} (no broadcasting)")
    path = ([(0, 1)] if len(names) == 2
            else _optimal_path(names, out, sizes))
    ops = [(t, tuple(int(n) for n in s)) for t, s in zip(names, shapes)]
    sites: List[TaskSite] = []
    for step, pair in enumerate(path):
        # the higher position first, as opt_einsum and JAX pop them
        (lhs_names, lhs), (rhs_names, rhs) = [ops.pop(i) for i in sorted(pair, reverse=True)]
        keep = set(out).union(*(set(t) for t, _ in ops))
        either = set(lhs_names) | set(rhs_names)
        removed = either - keep
        if step == len(path) - 1:
            result = out
        else:
            joined = lhs_names + rhs_names
            result = "".join(sorted(either & keep, key=joined.find))
        sites.append(_pair_site(lhs_names, lhs, rhs_names, rhs, removed, result))
        ops.append((result, tuple(sizes[c] for c in result)))
    return sites


def exp_site(shape) -> Optional[TaskSite]:
    """The reference's site of an elementwise ``exp``: a row softmax over
    the last axis (``sfm``, not dispatchable) when it has at least two axes
    and rows of at least two; a scalar or per-column exp is none."""
    shape = tuple(int(s) for s in shape)
    if len(shape) < 2 or shape[-1] < 2:
        return None
    return TaskSite("sfm", dict(m=_prod(shape[:-1]), n=shape[-1]), 1.0)


def attention_sites(
    cfg: ModelConfig, recorded: List[Dict[str, Any]]
) -> List[TaskSite]:
    """Weighted attention TaskSites from recorded calls.

    Each record is one call; the occurrence count of a causal record with
    window ``w`` is the number of layers carrying that window, split
    across the records that share it (one record per layer here, so each
    carries weight 1 and dedup sums them); a non-causal (encoder) record
    carries the encoder's layers over its records, and so does, summed over
    a decoder scan body, a cross-attention whose frames match the sequence
    (the reference's weight for it).  Records the workload
    cannot express — decode offsets, non-square kv (cross-attention),
    non-default scale, and every
    call of a model whose window pattern is aperiodic (hymba), whose window
    the reference traces through its layer scan — are skipped: those sites
    keep the chunked path, whose contractions are extracted as
    ``batch_matmul`` tasks anyway.
    """
    from ..models.transformer import layer_windows, window_period

    recorded = [r for r in recorded if r.get("kind", "prefill") == "prefill"]
    windows = layer_windows(cfg)
    if window_period(windows) is None:
        for _ in recorded:
            _skip("attention", "traced_window")
        return []
    rec_by_window: Dict[int, int] = {}
    square_noncausal = []
    for i, r in enumerate(recorded):
        if r["causal"]:
            w = r["window"]
            if w >= r["q_shape"][2]:
                w = 0  # window >= seq is global (canonical form)
            rec_by_window[w] = rec_by_window.get(w, 0) + 1
        elif r["kv_seq"] == r["q_shape"][2]:
            square_noncausal.append(i)
    # the encoder runs before the first decoder layer: its records come
    # first; the rest are decoder cross-attentions whose frames match the
    # sequence (S == F)
    n_enc = min(len(square_noncausal), cfg.enc_layers)
    encoder = set(square_noncausal[:n_enc])
    n_cross = len(square_noncausal) - n_enc
    sites: List[TaskSite] = []
    for i, r in enumerate(recorded):
        if r["q_offset"] != 0:
            _skip("attention", "decode_offset")
            continue
        B, H, S, D = r["q_shape"]
        KVH = r["kvh"]
        if r["kv_seq"] != S:
            _skip("attention", "cross_attention")
            continue
        if H % KVH != 0:
            _skip("attention", "ragged_gqa")
            continue
        if r["scale"] is not None and abs(r["scale"] - D**-0.5) > 1e-12:
            _skip("attention", "nondefault_scale")
            continue
        w = r["window"]
        if w and not r["causal"]:
            _skip("attention", "noncausal_window")
            continue  # the workload's window mask implies causality
        if w >= S:
            w = 0  # a window covering the whole sequence IS global
        if r["causal"]:
            total = sum(
                1
                for lw in windows
                if (int(lw) if int(lw) < S else 0) == w
            )
            n_rec = rec_by_window.get(w, 1)
            weight = total / n_rec if total else 1.0
        elif i in encoder:
            # encoder self-attention: the encoder's layers over its records
            weight = float(cfg.enc_layers) / n_enc
        else:
            # a square cross-attention: the reference traces one record a
            # decoder scan body (``window_period`` layers) and weighs each
            # by the encoder's layers, as it weighs an encoder record
            weight = float(cfg.enc_layers) * window_period(windows) / n_cross
        sites.append(
            TaskSite(
                "attention",
                dict(
                    b=B, h=H, kvh=KVH, s=S, d=D,
                    causal=int(r["causal"]), window=int(w),
                    softcap=float(r["softcap"]),
                ),
                weight,
                dispatchable=True,
            )
        )
    return sites


def decode_attention_sites(
    cfg: ModelConfig, recorded: List[Dict[str, Any]]
) -> List[TaskSite]:
    """Weighted ``attention_decode`` TaskSites from decode-step records.

    Every single-token cache-attention call maps to the same workload: the
    key holds only the static shape (b, h, kvh, t, d, softcap) — the window
    and the per-slot lengths ride in as BIAS data at dispatch time, so
    layers differing only in window share one tuned kernel.  Each record
    sharing a shape carries ``n_layers / n_records`` layers (one record per
    layer here, so each weighs 1 and dedup sums them to the layer count,
    as the reference's scan trip count does).  A model whose window
    pattern is aperiodic gives none: the reference traces its window.
    """
    from ..models.transformer import layer_windows, window_period

    traced = window_period(layer_windows(cfg)) is None
    kept: List[Dict[str, Any]] = []
    for r in recorded:
        if r.get("kind") != "decode":
            continue
        if traced:
            _skip("attention_decode", "traced_window")
            continue
        B, H, S, D = r["q_shape"]
        if S != 1:
            _skip("attention_decode", "not_single_token")
            continue
        if H % r["kvh"] != 0:
            _skip("attention_decode", "ragged_gqa")
            continue
        if r["scale"] is not None and abs(r["scale"] - D**-0.5) > 1e-12:
            _skip("attention_decode", "nondefault_scale")
            continue
        kept.append(
            dict(
                b=B, h=H, kvh=r["kvh"], t=r["kv_seq"], d=D,
                softcap=float(r["softcap"]),
            )
        )
    by_shape: Dict[Tuple, int] = {}
    for kw in kept:
        sig = tuple(sorted(kw.items()))
        by_shape[sig] = by_shape.get(sig, 0) + 1
    Ln = max(int(cfg.n_layers), 1)
    return [
        TaskSite(
            "attention_decode", kw,
            Ln / by_shape[tuple(sorted(kw.items()))],
            dispatchable=True,
        )
        for kw in kept
    ]


# ---------------------------------------------------------------------------
# Dedup + weighting
# ---------------------------------------------------------------------------


def _task_flops(op: str, kw: Dict[str, Any]) -> int:
    if op == "dense":
        return 2 * kw["m"] * kw["n"] * kw["k"]
    if op == "batch_matmul":
        return 2 * kw["b"] * kw["m"] * kw["n"] * kw["k"]
    if op == "rmsnorm":
        return 4 * kw["tokens"] * kw["d"]
    if op == "sfm":
        return 8 * kw["m"] * kw["n"]
    if op == "attention":
        # scores + value contractions (softmax flops are second-order)
        return 4 * kw["b"] * kw["h"] * kw["s"] * kw["s"] * kw["d"]
    if op == "attention_decode":
        return 4 * kw["b"] * kw["h"] * kw["t"] * kw["d"]
    return 0


def shard_sites(sites: Iterable[TaskSite], mesh) -> List[TaskSite]:
    """Rewrite site shapes to the per-shard shapes a mesh would run.

    Under :func:`~repro_torch.distributed.sharding.shard_map` each mesh
    coordinate runs the *local* block of every dispatched call, so the
    shapes worth tuning (and the keys dispatch looks up) are the per-shard
    ones.  The rule is :func:`~repro_torch.distributed.sharding.shard_workload`,
    the function the dispatch layer uses, so extracted keys and served keys
    never drift apart.  Sites the mesh cannot split pass through unchanged;
    each rewrite is counted (``extract.shard``) and traced.
    """
    from ..distributed.sharding import shard_workload

    if mesh is None:
        return list(sites)
    out: List[TaskSite] = []
    for s in sites:
        sw = shard_workload(s.op, s.kwargs, mesh)
        if sw is None or sw.kwargs == s.kwargs:
            out.append(s)
            continue
        metrics().inc("extract.shard", op=s.op)
        if trace_enabled():
            emit(
                "extract.shard",
                op=s.op,
                global_kwargs=dict(s.kwargs),
                shard_kwargs=dict(sw.kwargs),
                axes={k: list(v) if isinstance(v, tuple) else v
                      for k, v in sw.dim_axes.items()},
            )
        out.append(TaskSite(op=s.op, kwargs=dict(sw.kwargs), count=s.count,
                            dispatchable=s.dispatchable))
    return out


def dedup_sites(
    sites: Iterable[TaskSite], min_task_elems: int = 4096
) -> List[ExtractedTask]:
    """Collapse repeated shapes into weighted tasks (structural-hash dedup).

    ``min_task_elems`` drops degenerate sites whose tuning could never pay
    for itself.  A merged task's ``weight`` counts *all* structurally
    identical sites and ``dispatchable`` is true if *any* of them can be
    served.
    """
    by_hash: Dict[str, ExtractedTask] = {}
    for s in sites:
        elems = _task_flops(s.op, s.kwargs) // 2
        if elems < min_task_elems:
            continue
        func = get_workload(s.op, **s.kwargs)
        h = primfunc_structural_hash(func)
        if h in by_hash:
            by_hash[h].weight += s.count
            by_hash[h].dispatchable = by_hash[h].dispatchable or s.dispatchable
        else:
            by_hash[h] = ExtractedTask(
                key=workload_key(s.op, **s.kwargs),
                op=s.op,
                kwargs=dict(s.kwargs),
                weight=s.count,
                struct_hash=h,
                flops=_task_flops(s.op, s.kwargs),
                dispatchable=s.dispatchable,
            )
    out = list(by_hash.values())
    out.sort(key=lambda t: (-t.weight * t.flops, t.key))
    return out


# ---------------------------------------------------------------------------
# Model-level entry point
# ---------------------------------------------------------------------------


def record_forward_sites(cfg: ModelConfig, batch: int = 1, seq: int = TOKEN_TILE):
    """Run ``models.transformer.forward`` once on meta tensors under a
    recorder, on the reference's ``prefill_input_specs`` (tokens, or
    embeddings; whisper's frames); returns the recorder."""
    from ..configs.base import ShapeConfig
    from ..models import transformer as T
    from ..models.registry import prefill_input_specs

    params = T.init_params(cfg, device="meta")
    inputs = prefill_input_specs(cfg, ShapeConfig("extract", seq, batch, "prefill"))
    with SiteRecorder() as rec:
        T.forward(cfg, params, **inputs)
    return rec


def _resolve_mesh(mesh):
    """``"auto"`` means the thread's active mesh (``use_mesh`` block);
    ``None`` explicitly disables per-shard shaping."""
    if isinstance(mesh, str) and mesh == "auto":
        from ..distributed.sharding import get_mesh

        return get_mesh()
    return mesh


def extract_tasks(
    cfg: ModelConfig,
    batch: int = 1,
    seq: int = TOKEN_TILE,
    use_mxu: bool = True,
    min_task_elems: int = 4096,
    max_tasks: int = 0,
    ops: Tuple[str, ...] = EXTRACTABLE_OPS,
    dispatchable_only: bool = False,
    mesh="auto",
) -> List[TuneTask]:
    """Extract weighted tuning tasks from a model config's forward pass.

    ``max_tasks > 0`` keeps only the top tasks by weight x flops;
    ``dispatchable_only`` restricts to sites the dispatch layer can swap
    back into the model.  When a mesh is active (or passed) sites are
    rewritten to per-shard shapes first (:func:`shard_sites`).
    """
    extracted = extract_task_specs(
        cfg, batch=batch, seq=seq, min_task_elems=min_task_elems,
        max_tasks=max_tasks, ops=ops, dispatchable_only=dispatchable_only,
        mesh=mesh,
    )
    return [t.to_tune_task(use_mxu=use_mxu) for t in extracted]


def extract_task_specs(
    cfg: ModelConfig,
    batch: int = 1,
    seq: int = TOKEN_TILE,
    min_task_elems: int = 4096,
    max_tasks: int = 0,
    ops: Tuple[str, ...] = EXTRACTABLE_OPS,
    dispatchable_only: bool = False,
    mesh="auto",
) -> List[ExtractedTask]:
    """Like :func:`extract_tasks` but returns the rich task records."""
    rec = record_forward_sites(cfg, batch=batch, seq=seq)
    sites = rec.op_sites + attention_sites(cfg, rec.sites)
    sites = [s for s in sites if s.op in ops]
    if dispatchable_only:
        sites = [s for s in sites if s.dispatchable]
    sites = shard_sites(sites, _resolve_mesh(mesh))
    tasks = dedup_sites(sites, min_task_elems=min_task_elems)
    return _apply_max_tasks(cfg, tasks, max_tasks, ops, "attention")


def _apply_max_tasks(
    cfg: ModelConfig,
    tasks: List[ExtractedTask],
    max_tasks: int,
    ops: Tuple[str, ...],
    attn_op: str,
) -> List[ExtractedTask]:
    if max_tasks <= 0 or len(tasks) <= max_tasks:
        return tasks
    dropped = tasks[max_tasks:]
    tasks = tasks[:max_tasks]
    # the weight x flops ranking undervalues attention, and it is the one
    # op class whose blocks only tune through its own task — keep the
    # heaviest attention task alive under the cap
    if (
        attn_op in ops
        and any(d.op == attn_op for d in dropped)
        and not any(t.op == attn_op for t in tasks)
    ):
        kept_attn = next(d for d in dropped if d.op == attn_op)
        dropped = [d for d in dropped if d is not kept_attn]
        tasks[-1], dropped = kept_attn, dropped + [tasks[-1]]
    import logging

    logging.getLogger(__name__).info(
        "extract_tasks(%s): kept %d tasks, dropped %d (%s)",
        cfg.name, len(tasks), len(dropped),
        ", ".join(d.key for d in dropped),
    )
    return tasks


# ---------------------------------------------------------------------------
# Decode (serving) entry point
# ---------------------------------------------------------------------------


def _meta_arena(cfg: ModelConfig, batch: int, max_seq: int):
    """Parameters and a continuous-batching cache (per-slot ``(batch,)``
    positions) on meta tensors."""
    import torch

    from ..models import transformer as T

    params = T.init_params(cfg, device="meta")
    cache = T.init_cache(cfg, batch, max_seq, device="meta")
    cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device="meta")
    return params, cache


def record_decode_sites(cfg: ModelConfig, batch: int = 4, max_seq: int = TOKEN_TILE):
    """Run one ``decode_step`` on meta tensors in the continuous-batching
    arena layout (one token per slot, the fixed-shape cache of ``max_seq``)
    under a recorder: the program the serving scheduler runs every tick, so
    dense/bmm sites key on ``m = batch`` and attention reaches the recorder
    as single-token cache attention."""
    import torch

    from ..models import transformer as T

    params, cache = _meta_arena(cfg, batch, max_seq)
    tokens = torch.zeros((batch, 1), dtype=torch.int64, device="meta")
    with SiteRecorder() as rec:
        T.decode_step(cfg, params, cache, tokens)
    return rec


def record_serve_sites(
    cfg: ModelConfig,
    batch: int = 4,
    max_seq: int = TOKEN_TILE,
    chunk: int = 1,
    paged: bool = False,
    page_size: int = 16,
):
    """Run one ``serve_step`` tick on meta tensors under a recorder: the
    ``chunk``-wide program the scheduler runs when in-tick prefill is on,
    optionally through the paged cache layout.  Dense/bmm sites key on
    ``m = batch * chunk``; the attention workload is unchanged by paging
    (the page view restores ``t = kv_len``)."""
    import torch

    from ..models import transformer as T
    from ..serving.kv import snap_page_size

    params, cache = _meta_arena(cfg, batch, max_seq)
    if paged:
        Ln, _, kvh, kv_len, hd = cache["k"].shape
        ps = snap_page_size(kv_len, page_size)
        pages_per_slot = kv_len // ps
        pool = torch.empty((Ln, batch * pages_per_slot, kvh, ps, hd),
                           dtype=cache["k"].dtype, device="meta")
        cache["k"], cache["v"] = pool, torch.empty_like(pool)
        cache["page_table"] = torch.zeros(
            (batch, pages_per_slot), dtype=torch.int32, device="meta"
        )
    tokens = torch.zeros((batch, max(1, chunk)), dtype=torch.int64, device="meta")
    valid = torch.zeros((batch,), dtype=torch.int32, device="meta")
    with SiteRecorder() as rec:
        T.serve_step(cfg, params, cache, tokens, valid)
    return rec


def extract_decode_task_specs(
    cfg: ModelConfig,
    batch: int = 4,
    max_seq: int = TOKEN_TILE,
    min_task_elems: int = 1024,
    max_tasks: int = 0,
    ops: Tuple[str, ...] = DECODE_EXTRACTABLE_OPS,
    dispatchable_only: bool = False,
    mesh="auto",
    chunk: int = 0,
    paged: bool = False,
    page_size: int = 16,
) -> List[ExtractedTask]:
    """Decode-shape tuning tasks for a serving configuration.

    The decode counterpart of :func:`extract_task_specs`: the same dedup,
    over one recorded ``decode_step`` — so the extracted keys are exactly
    what :class:`~repro_torch.integration.dispatch.DispatchContext` looks
    up while serving.  ``min_task_elems`` defaults lower than prefill
    because decode shapes are small by construction (m = batch) yet run
    every generated token.

    ``chunk > 0`` / ``paged`` additionally record one ``serve_step`` tick
    of that chunk width, merging its dense, batch_matmul and rmsnorm sites (its chunk
    attention has no tuned shape, so its attention records are dropped):
    the mixed prefill+decode tick runs dense and rmsnorm at
    ``m = batch * chunk``.  Models ``serve_step`` refuses (SSD state,
    encoder cross-attention) skip that tick, as in the reference.
    """
    rec = record_decode_sites(cfg, batch=batch, max_seq=max_seq)
    sites = rec.op_sites + decode_attention_sites(cfg, rec.sites)
    if (chunk > 0 or paged) and not (cfg.attn_free or cfg.ssm_state or cfg.enc_layers):
        srec = record_serve_sites(
            cfg, batch=batch, max_seq=max_seq, chunk=max(1, chunk),
            paged=paged, page_size=page_size,
        )
        sites += srec.op_sites
    sites = [s for s in sites if s.op in ops]
    if dispatchable_only:
        sites = [s for s in sites if s.dispatchable]
    sites = shard_sites(sites, _resolve_mesh(mesh))
    tasks = dedup_sites(sites, min_task_elems=min_task_elems)
    return _apply_max_tasks(cfg, tasks, max_tasks, ops, "attention_decode")


def extract_decode_tasks(
    cfg: ModelConfig,
    batch: int = 4,
    max_seq: int = TOKEN_TILE,
    use_mxu: bool = True,
    min_task_elems: int = 1024,
    max_tasks: int = 0,
    ops: Tuple[str, ...] = DECODE_EXTRACTABLE_OPS,
    dispatchable_only: bool = False,
    mesh="auto",
    chunk: int = 0,
    paged: bool = False,
    page_size: int = 16,
) -> List[TuneTask]:
    """Like :func:`extract_decode_task_specs` but returns ``TuneTask``s."""
    extracted = extract_decode_task_specs(
        cfg, batch=batch, max_seq=max_seq, min_task_elems=min_task_elems,
        max_tasks=max_tasks, ops=ops, dispatchable_only=dispatchable_only,
        mesh=mesh, chunk=chunk, paged=paged, page_size=page_size,
    )
    return [t.to_tune_task(use_mxu=use_mxu) for t in extracted]
