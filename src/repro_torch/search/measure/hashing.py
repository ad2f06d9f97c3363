"""Canonical structural hashing of (workload_key, trace).

The evolutionary search mutates sampling decisions, and distinct mutation
paths frequently converge on the same program: identical instruction
sequence, identical decisions.  A canonical hash of the pair
``(workload_key, trace)`` lets the measurement cache and the crash
quarantine recognize such duplicates without comparing traces pairwise.

``Trace.to_json`` is already a canonical positional encoding: random
variables are numbered in definition order, untraced query inputs are
name-resolved, and ``ExprRV`` uids (which differ between equal traces)
never appear.  So two traces that replay to the same schedule serialize
to the same JSON, and hashing that string is both canonical and cheap.
"""

from __future__ import annotations

import hashlib
import json
import weakref
from typing import Any

import numpy as np

from ...core.trace import Trace

# hash memo keyed by trace identity: the search hashes the same trace in
# several places per round (measured-filter, cache, quarantine, provenance)
# and serializing it each time is pure waste.  Identity keying is safe for
# traces that are fully built before first being hashed — which holds for
# every trace the search produces (mutation returns fresh Trace objects).
_HASH_MEMO: "weakref.WeakKeyDictionary[Trace, Dict[str, str]]" = (
    weakref.WeakKeyDictionary()
)


def _jsonable(x: Any) -> Any:
    """Normalize numpy scalars/arrays hiding inside decisions."""
    if isinstance(x, np.integer):
        return int(x)
    if isinstance(x, np.floating):
        return float(x)
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    return x


def trace_canonical_json(trace: Trace) -> str:
    """Canonical JSON of a trace (decision values normalized)."""
    try:
        return trace.to_json()
    except TypeError:
        # decisions containing numpy scalars: normalize and retry
        fixed = Trace(
            [
                type(it)(it.name, it.inputs, it.attrs, it.outputs, _jsonable(it.decision))
                for it in trace.insts
            ]
        )
        return fixed.to_json()


def structural_hash(workload_key: str, trace: Trace) -> str:
    """Stable 16-hex-digit digest of (workload_key, trace structure+decisions)."""
    try:
        per_trace = _HASH_MEMO.setdefault(trace, {})
    except TypeError:  # un-weakref-able trace subclass: just don't memoize
        per_trace = {}
    h = per_trace.get(workload_key)
    if h is None:
        payload = workload_key + "\x00" + trace_canonical_json(trace)
        h = hashlib.sha256(payload.encode("utf-8")).hexdigest()[:16]
        per_trace[workload_key] = h
    return h


def _encode_expr(e: Any) -> Any:
    """Canonical nested-list encoding of a TIR scalar expression."""
    from ...core.tir import BinOp, Const, IterVar, Load, Select, UnOp

    if isinstance(e, Const):
        return ["const", float(e.value)]
    if isinstance(e, IterVar):
        return ["iter", e.name]
    if isinstance(e, Load):
        return ["load", e.buffer.name, [repr(ix) for ix in e.indices]]
    if isinstance(e, BinOp):
        return ["bin", e.op, _encode_expr(e.a), _encode_expr(e.b)]
    if isinstance(e, UnOp):
        return ["un", e.op, _encode_expr(e.a)]
    if isinstance(e, Select):
        return [
            "select",
            [[repr(b), int(n)] for b, n in e.bounds],
            _encode_expr(e.a),
            _encode_expr(e.b),
        ]
    return ["?", repr(e)]


def primfunc_canonical_json(func: Any) -> str:
    """Canonical JSON of a PrimFunc's structure (buffers, axes, exprs).

    Two workload instantiations hash equal iff they compute the same
    program over the same shapes — the dedup key for task extraction
    (repeated layer shapes collapse into one weighted task).
    """
    def buf(b):
        return [b.name, list(int(s) for s in b.shape), b.dtype]

    payload = {
        "inputs": [buf(b) for b in func.inputs],
        "outputs": [buf(b) for b in func.outputs],
        "blocks": [
            {
                "name": blk.name,
                "axes": [[a.name, int(a.extent), a.kind] for a in blk.axes],
                "expr": _encode_expr(blk.expr),
                "write": buf(blk.write),
                "write_indices": [repr(ix) for ix in blk.write_indices],
                "reduce_op": blk.reduce_op,
                "init": float(blk.init),
            }
            for blk in func.blocks
        ],
    }
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def primfunc_structural_hash(func: Any) -> str:
    """Stable 16-hex-digit digest of a PrimFunc's structure.

    Deliberately ignores ``func.name`` so that e.g. ``dense`` and an
    identically-shaped ``fused_dense`` with the same blocks dedup.
    """
    return hashlib.sha256(
        primfunc_canonical_json(func).encode("utf-8")
    ).hexdigest()[:16]


def decisions_digest(trace: Trace) -> str:
    """Digest of the sampling decisions alone (debug/provenance aid)."""
    dec = _jsonable(trace.decisions())
    return hashlib.sha256(
        json.dumps(dec, sort_keys=True, default=str).encode("utf-8")
    ).hexdigest()[:12]
