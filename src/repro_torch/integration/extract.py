"""Automatic task extraction from whole models (Ansor-style, end-to-end).

The JAX package traces the forward pass with ``jax.make_jaxpr`` and walks
the jaxpr.  Here the forward runs once on ``device="meta"`` tensors, which
carry shapes and allocate nothing even at full model width, while a
:class:`SiteRecorder` is active; the model's hooks report every call site
to it, mapped to registered tensor-program workloads:

* ``dense_op`` / ``unembed`` -> ``dense`` (m = rows of x, the tied unembed
  read transposed);
* ``bmm_op``                 -> ``batch_matmul`` (the attention score and
  value contractions in canonical layout);
* ``chunked_attention``      -> ``attention`` (see :func:`attention_sites`).

The weight of a site is the number of times its hook ran: 30 layers give
weight 30, as the reference's scan trip count does.  Tasks dedup by the
structural hash of the instantiated workload PrimFunc, summing weights,
so the keys and weights equal the reference's.  ``rmsnorm`` and ``sfm``
sites belong to a later slice.
"""

from __future__ import annotations

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

# ops the extractor understands in this slice
EXTRACTABLE_OPS = ("dense", "batch_matmul", "attention")
_LATER_SLICE_OPS = ("rmsnorm", "sfm", "attention_decode")


def _skip(site: str, reason: str) -> None:
    """Dropped-site telemetry: every site the extractor cannot express is
    dispatch coverage lost, so it must be visible."""
    metrics().inc("extract.skip", site=site, reason=reason)
    if trace_enabled():
        emit("extract.skip", site=site, reason=reason)


@dataclass
class TaskSite:
    """One hook call site mapped to a workload, pre-dedup.

    ``dispatchable`` marks sites the dispatch layer can serve; every site a
    hook reports is (``x @ w`` with w stored (k, n) or read transposed,
    canonical-layout ``batch_matmul``, static-shape attention).
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
    matrix products as ready :class:`TaskSite`\\ s, attention calls as raw
    records for :func:`attention_sites`."""

    dots: List[TaskSite] = field(default_factory=list)
    sites: List[Dict[str, Any]] = field(default_factory=list)

    def add_dot(self, op: str, **kwargs: int) -> None:
        self.dots.append(TaskSite(op, dict(kwargs), 1.0, dispatchable=True))

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


def attention_sites(
    cfg: ModelConfig, recorded: List[Dict[str, Any]]
) -> List[TaskSite]:
    """Weighted attention TaskSites from recorded calls.

    Each record is one call; the occurrence count of a causal record with
    window ``w`` is the number of layers carrying that window, split
    across the records that share it (one record per layer here, so each
    carries weight 1 and dedup sums them).  Records the workload cannot
    express — decode offsets, non-square kv, non-default scale — are
    skipped: those sites keep the chunked path, whose contractions are
    extracted as ``batch_matmul`` tasks anyway.
    """
    from ..models.transformer import layer_windows

    recorded = [r for r in recorded if r.get("kind", "prefill") == "prefill"]
    windows = layer_windows(cfg)
    rec_by_window: Dict[int, int] = {}
    for r in recorded:
        if r["causal"]:
            w = r["window"]
            if w >= r["q_shape"][2]:
                w = 0  # window >= seq is global (canonical form)
            rec_by_window[w] = rec_by_window.get(w, 0) + 1
    sites: List[TaskSite] = []
    for r in recorded:
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
        else:
            weight = float(cfg.enc_layers or 1)
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
    recorder; returns the recorder."""
    import torch

    from ..models import transformer as T

    params = T.init_params(cfg, device="meta")
    tokens = torch.zeros((batch, seq), dtype=torch.int64, device="meta")
    with SiteRecorder() as rec:
        T.forward(cfg, params, tokens)
    return rec


def extract_tasks(
    cfg: ModelConfig,
    batch: int = 1,
    seq: int = TOKEN_TILE,
    use_mxu: bool = True,
    min_task_elems: int = 4096,
    max_tasks: int = 0,
    ops: Tuple[str, ...] = EXTRACTABLE_OPS,
    dispatchable_only: bool = False,
) -> List[TuneTask]:
    """Extract weighted tuning tasks from a model config's forward pass.

    ``max_tasks > 0`` keeps only the top tasks by weight x flops;
    ``dispatchable_only`` restricts to sites the dispatch layer can swap
    back into the model.
    """
    extracted = extract_task_specs(
        cfg, batch=batch, seq=seq, min_task_elems=min_task_elems,
        max_tasks=max_tasks, ops=ops, dispatchable_only=dispatchable_only,
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
) -> List[ExtractedTask]:
    """Like :func:`extract_tasks` but returns the rich task records."""
    later = sorted(set(ops) & set(_LATER_SLICE_OPS))
    if later:
        raise NotImplementedError(
            f"extracting {later} sites is not in this slice; "
            f"supported ops: {EXTRACTABLE_OPS}"
        )
    rec = record_forward_sites(cfg, batch=batch, seq=seq)
    sites = rec.dots + attention_sites(cfg, rec.sites)
    sites = [s for s in sites if s.op in ops]
    if dispatchable_only:
        sites = [s for s in sites if s.dispatchable]
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
