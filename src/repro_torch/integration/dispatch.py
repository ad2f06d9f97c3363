"""Tuned-kernel dispatch: swap database-backed traces into the model forward.

``DispatchContext`` is the consumer side of the end-to-end loop: given a
tuning :class:`~repro_torch.search.database.Database`, it looks up the best
record per workload key, replays the stored trace through the validator,
lowers the schedule with the selected backend (the CUDA kernels, or the
structural lowering for a workload without one), and
serves the lowered callable to the model layers — which call in through
the hooks in :mod:`repro_torch.models.layers` (``dense_op`` / ``bmm_op`` /
``unembed`` / ``chunked_attention`` / ``decode_attention`` / ``rmsnorm``)
while the context is active::

    db = Database("results/tuning_db.json")
    with DispatchContext(db, tasks=extract_tasks(cfg)) as ctx:
        logits = forward(cfg, params, tokens)
    print(ctx.stats)   # {"hits": ..., "misses": ...}

A missing record, an invalid stored trace or a shape the context has never
seen returns ``None`` from the lookup and the layer keeps its plain path.
A schedule the backend rejects (``ScheduleRejected``: the tile does not
divide, or exceeds the grid, shared-memory or thread caps) is a
``lowering_failed`` miss; any other lowering or kernel error propagates.  Every dispatched call runs in float32 and casts back
to the caller's dtype.

Gradients: each swapped call is a ``torch.autograd.Function`` whose
backward is the autograd of the plain PyTorch version.

Under an active mesh (``distributed.sharding.use_mesh``) ``dense``,
``batch_matmul`` and ``attention`` first look up the *per-shard* key that
:func:`~repro_torch.distributed.sharding.shard_workload` gives (the key
extraction under the same mesh tuned) and serve it through
:func:`~repro_torch.distributed.sharding.shard_map`: the kernel runs once
per mesh coordinate on that coordinate's block, and the blocks are
assembled (``stats["mesh_sharded"]``).  Without a per-shard record the
call falls through to the global key.  The backward is the autograd of
the global plain function, as in the reference.  The reference turns any
exception of its mesh path into a ``mesh_error`` fallback; here only a
per-shard schedule the backend rejects at lowering (``ScheduleRejected``)
is a ``mesh_error`` fallback to the global key, and any error at launch
propagates, as on the global path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..backends.registry import DEFAULT_BACKEND, get_backend
from ..core.tir import PrimFunc
from ..core.validator import validate_trace
from ..distributed.sharding import P, get_mesh, shard_map, shard_workload
from ..kernels import ScheduleRejected
from ..models.layers import TracedWindow
from ..obs import emit, metrics, trace_enabled
from ..search.database import Database, parse_workload_key, workload_key

# active-context stack; layers read the top via current().  Thread-local so
# threads with different contexts don't cross-dispatch.
_TLS = threading.local()


def current() -> Optional["DispatchContext"]:
    """The innermost active DispatchContext, or None."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else None


@dataclass
class CompiledKernel:
    """A lowered workload ready to swap into the model."""

    key: str
    func: PrimFunc
    fn: Callable  # callable(dict inputs) -> dict outputs
    out_name: str
    source: str  # "database"
    latency_s: float = float("inf")
    grad_fn: Optional[Callable] = None  # autograd-wrapped positional call
    meta: Optional[Dict[str, Any]] = None  # lowering provenance
    # the shard_map-wrapped calls serving this per-shard kernel on *global*
    # operands, by (mesh, specs); separate from grad_fn because the two
    # expect different operand sizes
    mesh_grad_fn: Optional[Dict[Any, Callable]] = None


class DispatchContext:
    """Looks up best traces by workload key and serves lowered kernels.

    Parameters
    ----------
    database:
        A ``Database`` instance or a path to one.  Each key serves its best
        record; keys without a record miss and fall back.
    tasks:
        Optional iterable of ``TuneTask`` (or anything with ``.key`` and
        ``.func``) naming the workloads this context may dispatch.  When
        omitted, every parseable key in the database becomes dispatchable.
    """

    # the dispatch mode in the metrics and trace labels the JAX package
    # records; this package serves database bests only
    mode = "best"

    def __init__(
        self,
        database: Optional[Any] = None,
        tasks: Optional[Sequence[Any]] = None,
        backend: Optional[str] = None,
    ):
        self.db: Optional[Database] = (
            Database(database) if isinstance(database, str) else database
        )
        # the lowering backend this context serves: the same spec the
        # measurement stack built candidates through; resolved eagerly so
        # a typo'd spec raises here
        self.backend = backend or DEFAULT_BACKEND
        get_backend(self.backend)
        self.stats: Dict[str, int] = {
            "hits": 0,
            "misses": 0,
            "attention_fused": 0,
            "attention_tuned": 0,
            "attention_decode_tuned": 0,
            "mesh_sharded": 0,
        }
        self.hits_by_key: Dict[str, int] = {}
        self._by_key: Dict[str, Dict[str, Any]] = {}
        self.miss_reasons: Dict[str, str] = {}  # key -> why kernel() is None
        self._funcs: Dict[str, PrimFunc] = {}
        self._compiled: Dict[str, Optional[CompiledKernel]] = {}
        if tasks is not None:
            for t in tasks:
                self._funcs[t.key] = t.func
        elif self.db is not None:
            from ..core.workloads import WORKLOADS, get_workload

            for key in self.db.keys():
                try:
                    name, kw = parse_workload_key(key)
                    if name in WORKLOADS:
                        self._funcs[key] = get_workload(name, **kw)
                except Exception:
                    continue  # foreign key (e.g. operator-bench workload)

    # -- context management -------------------------------------------------

    def __enter__(self) -> "DispatchContext":
        stack = getattr(_TLS, "stack", None)
        if stack is None:
            stack = _TLS.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _TLS.stack.pop()

    # -- compilation --------------------------------------------------------

    def keys(self) -> List[str]:
        return list(self._funcs.keys())

    def _schedule_for(self, key: str, func: PrimFunc):
        """(schedule, source, latency); schedule None -> source is the
        miss reason ("no_database" | "no_record" | "invalid_trace")."""
        if self.db is None:
            return None, "no_database", float("inf")
        rec = self.db.best(key)
        if rec is None:
            return None, "no_record", float("inf")
        v = validate_trace(func, rec.trace())
        if not v.ok:
            return None, "invalid_trace", float("inf")
        return v.schedule, "database", rec.latency_s

    def kernel(self, key: str) -> Optional[CompiledKernel]:
        """Lowered kernel for ``key`` (lazy; None caches the miss, and
        ``miss_reasons[key]`` records why)."""
        if key in self._compiled:
            return self._compiled[key]
        func = self._funcs.get(key)
        kern: Optional[CompiledKernel] = None
        if func is None:
            self.miss_reasons[key] = "unknown_key"
        else:
            sch, source, lat = self._schedule_for(key, func)
            if sch is None:
                self.miss_reasons[key] = source
            else:
                try:
                    lowered = get_backend(self.backend).lower(
                        sch, workload_key=key
                    )
                except ScheduleRejected:
                    # a tile the card cannot run is a miss: the layer keeps
                    # its plain path
                    lowered = None
                    self.miss_reasons[key] = "lowering_failed"
                if lowered is not None:
                    kern = CompiledKernel(
                        key=key,
                        func=func,
                        fn=lowered.fn,
                        out_name=func.outputs[0].name,
                        source=source,
                        latency_s=lat,
                        meta=lowered.meta,
                    )
        self._compiled[key] = kern
        return kern

    # -- op-level lookups (called from model layers) ------------------------

    def _note(
        self,
        outcome: str,
        key: Optional[str],
        site: str,
        reason: Optional[str] = None,
    ) -> None:
        """Record a dispatch outcome ("hit" | "miss" | "fallback") in the
        per-key table, the metrics registry, and the trace stream."""
        row_key = key if key else f"site:{site}"
        row = self._by_key.get(row_key)
        if row is None:
            row = self._by_key[row_key] = {
                "site": site,
                "hits": 0,
                "misses": 0,
                "fallbacks": 0,
                "reasons": {},
            }
        row["hits" if outcome == "hit" else
            "misses" if outcome == "miss" else "fallbacks"] += 1
        if reason:
            row["reasons"][reason] = row["reasons"].get(reason, 0) + 1
        metrics().inc(
            f"dispatch.{outcome}",
            site=site,
            mode=self.mode,
            backend=self.backend,
        )
        if trace_enabled():
            emit(
                f"dispatch.{outcome}",
                key=key,
                site=site,
                reason=reason,
                mode=self.mode,
                backend=self.backend,
            )

    def stats_by_key(self) -> Dict[str, Dict[str, Any]]:
        """Per-key (or per-site for keyless fallbacks) outcome table:
        ``{key: {site, hits, misses, fallbacks, reasons: {reason: n}}}``."""
        return {
            k: {**row, "reasons": dict(row["reasons"])}
            for k, row in self._by_key.items()
        }

    def _lookup(self, key: str, site: str = "") -> Optional[CompiledKernel]:
        kern = self.kernel(key)
        if kern is None:
            self.stats["misses"] += 1
            self._note("miss", key, site, self.miss_reasons.get(key))
            return None
        self.stats["hits"] += 1
        self.hits_by_key[key] = self.hits_by_key.get(key, 0) + 1
        self._note("hit", key, site)
        return kern

    def dense(
        self, x: torch.Tensor, w: torch.Tensor, transpose_w: bool = False
    ) -> Optional[torch.Tensor]:
        """Tuned ``x @ w`` over the last dim of x; None -> caller falls back.

        ``transpose_w=True`` serves a weight stored (n, k) — the
        tied-embedding unembed ``bsd,vd->bsv`` — by reading it transposed:
        the same tuned ``dense`` (m, n, k) kernel runs on a strided view.
        """
        if x.ndim < 1 or w.ndim != 2:
            self._note("fallback", None, "dense", "shape_mismatch")
            return None
        if transpose_w:
            if x.shape[-1] != w.shape[1]:
                self._note("fallback", None, "dense", "shape_mismatch")
                return None
            n, k = int(w.shape[0]), int(w.shape[1])
        else:
            if x.shape[-1] != w.shape[0]:
                self._note("fallback", None, "dense", "shape_mismatch")
                return None
            k, n = int(w.shape[0]), int(w.shape[1])
        m = 1
        for s in x.shape[:-1]:
            m *= int(s)
        mesh = get_mesh()
        if mesh is not None:
            out = self._mesh_dense(x, w, transpose_w, m, n, k, mesh)
            if out is not None:
                return out
        kern = self._lookup(workload_key("dense", m=m, n=n, k=k), "dense")
        if kern is None:
            return None
        if kern.grad_fn is None:
            def fwd_kernel(x2, w2):
                return kern.fn({"X": x2, "W": w2})[kern.out_name]

            kern.grad_fn = _with_reference_grad(fwd_kernel, torch.matmul)
        x2 = x.reshape(m, k).float()
        w2 = w.float()
        if transpose_w:
            w2 = w2.t()  # (n, k) -> (k, n) view; the kernel reads strides
        out = kern.grad_fn(x2, w2)
        return out.reshape(*x.shape[:-1], n).to(x.dtype)

    def batch_matmul(
        self, a: torch.Tensor, b: torch.Tensor
    ) -> Optional[torch.Tensor]:
        """Tuned batched ``a @ b``; a: (..., M, K), b: (..., K, N) with
        identical leading (batch) dims.  Returns float32 (the workload's
        accumulate dtype); None -> caller falls back."""
        if a.ndim < 3 or b.ndim != a.ndim or a.shape[-1] != b.shape[-2]:
            self._note("fallback", None, "batch_matmul", "shape_mismatch")
            return None
        if a.shape[:-2] != b.shape[:-2]:
            self._note("fallback", None, "batch_matmul", "shape_mismatch")
            return None
        bdims = a.shape[:-2]
        B = 1
        for s in bdims:
            B *= int(s)
        M, K = int(a.shape[-2]), int(a.shape[-1])
        N = int(b.shape[-1])
        mesh = get_mesh()
        if mesh is not None:
            out = self._mesh_batch_matmul(a, b, B, M, N, K, bdims, mesh)
            if out is not None:
                return out
        kern = self._lookup(
            workload_key("batch_matmul", b=B, m=M, n=N, k=K), "batch_matmul"
        )
        if kern is None:
            return None
        if kern.grad_fn is None:
            def fwd_kernel(a2, b2):
                return kern.fn({"A": a2, "B": b2})[kern.out_name]

            kern.grad_fn = _with_reference_grad(fwd_kernel, torch.matmul)
        a2 = a.reshape(B, M, K).float()
        b2 = b.reshape(B, K, N).float()
        out = kern.grad_fn(a2, b2)
        return out.reshape(*bdims, M, N)

    def attention(
        self,
        q: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        *,
        causal: bool = True,
        window: Optional[int] = None,
        softcap: Optional[float] = None,
        scale: Optional[float] = None,
        q_offset: int = 0,
    ) -> Optional[torch.Tensor]:
        """Fused attention with database-tuned ``(block_q, block_kv)``.

        Lookup order: (1) a tuned ``attention`` workload record keyed by
        ``(b, h, kvh, s, d, causal, window, softcap)``; (2) the backend's
        default fused path (the pre-tuning fixed blocks).  A nonzero
        ``q_offset`` (decode) or a window the reference traces through its
        layer scan (a :class:`~repro_torch.models.layers.TracedWindow`)
        falls back to the layer's chunked path, whose contractions
        dispatch through ``bmm_op``.
        """
        if q_offset != 0:
            self._note("fallback", None, "attention", "decode_offset")
            return None
        B, H, S, D = (int(s) for s in q.shape)
        KVH, T = int(k.shape[1]), int(k.shape[2])
        if v.shape != k.shape or T != S or H % KVH != 0:
            self._note("fallback", None, "attention", "shape_mismatch")
            return None
        if isinstance(window, TracedWindow):
            self._note("fallback", None, "attention", "traced_window")
            return None
        if window is not None:
            w = int(window)
            # 0 = global; a window covering the whole sequence is global
            # too — the canonical form the extracted task keys use
            window = None if (w <= 0 or w >= S) else w

        def ref(q2, k2, v2):
            from ..kernels import ref as kref

            return kref.flash_attention(
                q2, k2, v2, causal=causal, window=window, softcap=softcap,
                scale=scale,
            )

        # (1) tuned workload record — only the workload's own scale and
        # causal windows are keyed
        default_scale = scale is None or abs(scale - D**-0.5) < 1e-12
        if default_scale and not (window is not None and not causal):
            mesh = get_mesh()
            if mesh is not None:
                out = self._mesh_attention(
                    q, k, v, B, H, KVH, S, D, causal, window, softcap, ref,
                    mesh,
                )
                if out is not None:
                    return out
            key = workload_key(
                "attention", b=B, h=H, kvh=KVH, s=S, d=D,
                causal=int(bool(causal)), window=int(window or 0),
                softcap=float(softcap or 0.0),
            )
            kern = self.kernel(key)
            unservable = kern is not None and not _attention_kern_servable(
                kern, B, H, S
            )
            if unservable:
                kern = None  # structural lowering too large to serve
            if kern is None:
                self.stats["misses"] += 1
                self._note(
                    "miss", key, "attention",
                    "unservable" if unservable else self.miss_reasons.get(key),
                )
            else:
                self.stats["hits"] += 1
                self.hits_by_key[key] = self.hits_by_key.get(key, 0) + 1
                self._note("hit", key, "attention")
                G = H // KVH
                if kern.grad_fn is None:
                    def fwd_kernel(q5, k2, v2):
                        return kern.fn({"Q": q5, "K": k2, "V": v2})[
                            kern.out_name
                        ]

                    def ref5(q5, k2, v2):
                        out = ref(q5.reshape(B, H, S, D), k2, v2)
                        return out.reshape(B, KVH, G, S, D)

                    kern.grad_fn = _with_reference_grad(fwd_kernel, ref5)
                self.stats["attention_tuned"] += 1
                q5 = q.reshape(B, KVH, G, S, D).float()
                out = kern.grad_fn(q5, k.float(), v.float())
                return out.reshape(B, H, S, D).to(q.dtype)

        # (2) backend default fused path (fixed pre-tuning blocks)
        be = get_backend(self.backend)
        fused = getattr(be, "fused_attention", None)
        if fused is None:
            self._note("fallback", None, "attention", "no_fused_backend")
            return None

        def kernel_fn(q2, k2, v2):
            return fused(
                q2.contiguous(), k2.contiguous(), v2.contiguous(),
                causal=causal, window=window, softcap=softcap, scale=scale,
            )

        self.stats["attention_fused"] += 1
        self._note("fallback", None, "attention", "backend_fused")
        out = _with_reference_grad(kernel_fn, ref)(
            q.float(), k.float(), v.float()
        )
        return out.to(q.dtype)

    def decode_attention(
        self,
        q: torch.Tensor,  # (B, H, 1, D)
        k: torch.Tensor,  # (B, KVH, T, D) — full fixed-shape cache
        v: torch.Tensor,
        *,
        length: Any,  # valid length: scalar or per-slot (B,)
        window: Optional[int] = None,
        softcap: Optional[float] = None,
        scale: Optional[float] = None,
    ) -> Optional[torch.Tensor]:
        """Tuned single-token decode attention (serving).

        Serves ``attention_decode`` records keyed by the *static* shape
        ``(b, h, kvh, t, d, softcap)`` — ``t`` is the fixed cache length,
        so the key is position-independent.  The dynamic part of decode
        (per-slot lengths, the layer's window) folds into an additive bias
        built as data on the cache's device and fed to the kernel as the
        workload's BIAS input: one tuned kernel serves every decode step of
        a continuous-batching arena.  A window the reference traces through
        its layer scan (a :class:`~repro_torch.models.layers.TracedWindow`,
        every layer of an aperiodic pattern) falls back to the plain path
        (``traced_window``), as in the reference.  The reference's
        ``traced_softcap`` cannot occur: every model's softcap is a config
        constant.
        """
        B, H, S, D = (int(s) for s in q.shape)
        KVH, T = int(k.shape[1]), int(k.shape[2])
        if S != 1:
            # in-tick prefill chunk: a (B, C) serve_step tick runs its chunk
            # queries through the plain staircase path; only single-token
            # decode has a tuned kernel shape
            self._note("fallback", None, "attention_decode", "chunked_query")
            return None
        if v.shape != k.shape or H % KVH != 0:
            self._note("fallback", None, "attention_decode", "shape_mismatch")
            return None
        if isinstance(window, TracedWindow):
            self._note("fallback", None, "attention_decode", "traced_window")
            return None
        if scale is not None and abs(scale - D**-0.5) > 1e-12:
            self._note(
                "fallback", None, "attention_decode", "nondefault_scale"
            )
            return None
        key = workload_key(
            "attention_decode", b=B, h=H, kvh=KVH, t=T, d=D,
            softcap=float(softcap or 0.0),
        )
        kern = self._lookup(key, "attention_decode")
        if kern is None:
            return None
        G = H // KVH
        w = int(window or 0)
        # mask as data: 0 where attendable, -1e30 where not — position <
        # length, and inside the window when the layer is local (ring
        # wraparound approximated by slot, like the plain path)
        pos = torch.arange(T, device=k.device)
        lv = torch.as_tensor(length, device=k.device).expand(B)
        valid = pos[None, :] < lv[:, None]
        if w > 0:
            valid = valid & (pos[None, :] > lv[:, None] - 1 - w)
        bias = torch.where(
            valid,
            torch.zeros((), dtype=torch.float32, device=k.device),
            torch.full((), -1e30, dtype=torch.float32, device=k.device),
        )
        if kern.grad_fn is None:
            def fwd_kernel(q4, k2, v2, b2):
                return kern.fn({"Q": q4, "K": k2, "V": v2, "BIAS": b2})[
                    kern.out_name
                ]

            def ref(q4, k2, v2, b2):
                from ..kernels import ref as kref

                return kref.decode_attention(q4, k2, v2, b2, softcap=softcap)

            kern.grad_fn = _with_reference_grad(fwd_kernel, ref)
        self.stats["attention_decode_tuned"] += 1
        q4 = q.reshape(B, KVH, G, D).float()
        out = kern.grad_fn(q4, k.float(), v.float(), bias)
        return out.reshape(B, H, 1, D).to(q.dtype)

    def rmsnorm(
        self, x: torch.Tensor, w: torch.Tensor, eps: float
    ) -> Optional[torch.Tensor]:
        """Tuned RMS norm over the last axis; None -> caller falls back.

        Serves ``rmsnorm`` records keyed ``(d, eps, tokens)``.  The workload
        has no hand-written kernel: the backend lowers its schedule
        structurally (``lowered_with: "torch-fallback"`` in the meta).
        Runs in f32 and returns ``x.dtype``."""
        if x.ndim < 1 or w.ndim != 1 or x.shape[-1] != w.shape[0]:
            self._note("fallback", None, "rmsnorm", "shape_mismatch")
            return None
        tokens = 1
        for s in x.shape[:-1]:
            tokens *= int(s)
        d = int(x.shape[-1])
        kern = self._lookup(
            workload_key("rmsnorm", d=d, eps=eps, tokens=tokens), "rmsnorm"
        )
        if kern is None:
            return None
        if kern.grad_fn is None:
            def ref(x2, w2):
                var = torch.mean(x2 * x2, dim=-1, keepdim=True)
                return x2 * torch.rsqrt(var + eps) * w2

            def fwd_kernel(x2, w2):
                return kern.fn({"X": x2, "W": w2})[kern.out_name]

            kern.grad_fn = _with_reference_grad(fwd_kernel, ref)
        x2 = x.reshape(tokens, d).float()
        out = kern.grad_fn(x2, w.float())
        return out.reshape(x.shape).to(x.dtype)

    # -- mesh-aware dispatch (shard_map-served per-shard kernels) -----------

    def _mesh_kernel(self, op: str, kwargs: Dict[str, Any], mesh):
        """(kernel, ShardedWorkload, key) for the per-shard shape of one
        call under ``mesh``, or ``(None, sw, key)`` when the per-shard key
        has no servable record (``no_shard_record``) or its schedule was
        rejected at lowering (``mesh_error``); the caller then falls
        through to the global path.  The per-shard shape comes from the same
        :func:`~repro_torch.distributed.sharding.shard_workload` rule task
        extraction uses, so tuned-under-mesh keys always line up."""
        sw = shard_workload(op, kwargs, mesh)
        if sw is None:
            return None, None, None
        key = workload_key(op, **sw.kwargs)
        kern = self.kernel(key)
        if kern is None:
            rejected = self.miss_reasons.get(key) == "lowering_failed"
            self._note("fallback", key, op,
                       "mesh_error" if rejected else "no_shard_record")
            return None, sw, key
        return kern, sw, key

    def _mesh_hit(self, key: str, site: str) -> None:
        self.stats["hits"] += 1
        self.stats["mesh_sharded"] += 1
        self.hits_by_key[key] = self.hits_by_key.get(key, 0) + 1
        self._note("hit", key, site, "mesh_shard")

    def _mesh_wrap(self, kern: CompiledKernel, mesh, specs, build: Callable):
        """The shard_map-wrapped call of a kernel under ``mesh`` with
        ``specs``, built once.  Two calls may share a per-shard key with
        different axes (a dense whose n the model axis splits and one whose
        n it cannot split, each with the same block shape), so the cache is
        keyed by the specs too; the reference keys it by the mesh alone and
        reuses the first call's specs."""
        if kern.mesh_grad_fn is None:
            kern.mesh_grad_fn = {}
        fn = kern.mesh_grad_fn.get((mesh, specs))
        if fn is None:
            fn = kern.mesh_grad_fn[(mesh, specs)] = build()
        return fn

    def _mesh_dense(self, x, w, transpose_w: bool, m: int, n: int, k: int,
                    mesh) -> Optional[torch.Tensor]:
        """The per-shard tuned dense kernel under shard_map: rows split
        over the data-parallel axes, columns over the model axis, the
        contraction whole — each block is an exact local tile.  The blocks
        are views (K1 reads any strides)."""
        kern, sw, key = self._mesh_kernel("dense", {"m": m, "n": n, "k": k}, mesh)
        if kern is None:
            return None
        m_ax, n_ax = sw.dim_axes.get("m"), sw.dim_axes.get("n")

        def build():
            def body(x2, w2):
                return kern.fn({"X": x2, "W": w2})[kern.out_name]

            fwd = shard_map(body, mesh, in_specs=(P(m_ax, None), P(None, n_ax)),
                            out_specs=P(m_ax, n_ax))
            return _with_reference_grad(fwd, torch.matmul)

        grad_fn = self._mesh_wrap(kern, mesh, (m_ax, n_ax), build)
        x2 = x.reshape(m, k).float()
        w2 = w.float()
        if transpose_w:
            w2 = w2.t()
        out = grad_fn(x2, w2)
        self._mesh_hit(key, "dense")
        return out.reshape(*x.shape[:-1], n).to(x.dtype)

    def _mesh_batch_matmul(self, a, b, B: int, M: int, N: int, K: int, bdims,
                           mesh) -> Optional[torch.Tensor]:
        """The per-shard tuned batch_matmul under shard_map: the batch dim
        (heads or experts) splits over the model axis, else the
        data-parallel axes."""
        kern, sw, key = self._mesh_kernel(
            "batch_matmul", {"b": B, "m": M, "n": N, "k": K}, mesh
        )
        if kern is None:
            return None
        spec = P(sw.dim_axes.get("b"), None, None)

        def build():
            def body(a2, b2):
                return kern.fn({"A": a2, "B": b2})[kern.out_name]

            fwd = shard_map(body, mesh, in_specs=(spec, spec), out_specs=spec)
            return _with_reference_grad(fwd, torch.matmul)

        grad_fn = self._mesh_wrap(kern, mesh, spec, build)
        out = grad_fn(a.reshape(B, M, K).float(), b.reshape(B, K, N).float())
        self._mesh_hit(key, "batch_matmul")
        return out.reshape(*bdims, M, N)

    def _mesh_attention(self, q, k, v, B: int, H: int, KVH: int, S: int, D: int,
                        causal, window, softcap, ref: Callable,
                        mesh) -> Optional[torch.Tensor]:
        """The per-shard tuned fused attention under shard_map: heads split
        over the model axis (q and kv heads together, so each block keeps
        whole GQA groups), batch over the data-parallel axes.  The
        sequence stays whole, so causal and window masks are exact."""
        kern, sw, key = self._mesh_kernel(
            "attention",
            {
                "b": B, "h": H, "kvh": KVH, "s": S, "d": D,
                "causal": int(bool(causal)), "window": int(window or 0),
                "softcap": float(softcap or 0.0),
            },
            mesh,
        )
        if kern is None:
            return None
        if not _attention_kern_servable(kern, sw.kwargs["b"], sw.kwargs["h"], S):
            self._note("fallback", key, "attention", "unservable")
            return None
        b_ax, h_ax = sw.dim_axes.get("b"), sw.dim_axes.get("h")
        G = H // KVH

        def build():
            q_spec = P(b_ax, h_ax, None, None, None)  # (B, KVH, G, S, D)
            kv_spec = P(b_ax, h_ax, None, None)       # (B, KVH, S, D)

            def body(q5, k2, v2):
                return kern.fn({"Q": q5, "K": k2, "V": v2})[kern.out_name]

            fwd = shard_map(body, mesh, in_specs=(q_spec, kv_spec, kv_spec),
                            out_specs=q_spec)

            def ref5(q5, k2, v2):
                return ref(q5.reshape(B, H, S, D), k2, v2).reshape(B, KVH, G, S, D)

            return _with_reference_grad(fwd, ref5)

        grad_fn = self._mesh_wrap(kern, mesh, (b_ax, h_ax, B, H, S, D), build)
        q5 = q.reshape(B, KVH, G, S, D).float()
        out = grad_fn(q5, k.float(), v.float())
        self._mesh_hit(key, "attention")
        self.stats["attention_tuned"] += 1
        return out.reshape(B, H, S, D).to(q.dtype)


# A structurally lowered (not fused) attention kernel materializes the
# (b, h, s, s) score buffer the chunked online-softmax path exists to
# avoid; it is served only while that buffer stays within this cap.  The
# fused flash lowering (K3, meta ``pallas_kernel: "flash_attention"``)
# streams kv blocks and has no such limit.
MAX_STRUCTURAL_ATTN_SCORE_BYTES = 256 << 20


def _attention_kern_servable(kern: CompiledKernel, b: int, h: int, s: int) -> bool:
    if kern.meta and kern.meta.get("pallas_kernel") == "flash_attention":
        return True
    return 4 * b * h * s * s <= MAX_STRUCTURAL_ATTN_SCORE_BYTES


def maybe_dispatch(ctx: Optional[DispatchContext]):
    """``with maybe_dispatch(ctx):`` — no-op when ctx is None."""
    from contextlib import nullcontext

    return ctx if ctx is not None else nullcontext()


def _with_reference_grad(kernel_fn: Callable, ref_fn: Callable) -> Callable:
    """Forward through the tuned kernel, backward through autograd of the
    plain PyTorch version."""

    class _KernelWithReferenceGrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *args):
            ctx.save_for_backward(*args)
            return kernel_fn(*args)

        @staticmethod
        def backward(ctx, g):
            args = [a.detach().requires_grad_(True) for a in ctx.saved_tensors]
            with torch.enable_grad():
                out = ref_fn(*args)
            return torch.autograd.grad(out, args, g, allow_unused=True)

    return _KernelWithReferenceGrad.apply
