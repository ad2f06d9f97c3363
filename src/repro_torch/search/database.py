"""Tuning-record database.

Persists (workload key → top-k records) as JSON.  A record holds the
serialized trace, its decisions, the measured latency, and provenance.
Model layers look up tuned kernel parameters by workload key at build time
(DESIGN.md §4) — this is the end-to-end integration point of Appendix A.6.

The on-disk JSON schema — including every ``TuningRecord.meta`` provenance
field the measurement stack records and the sidecar files the learned
search persists next to the database — is documented in
``docs/db_format.md``; that contract is what CI caches and cross-run warm
starts rely on.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import asdict, dataclass, field, fields
from typing import Dict, List, Optional, Tuple

from ..core.trace import Trace


@dataclass
class TuningRecord:
    """One measured schedule: workload key, trace JSON, latency, provenance.

    ``meta`` carries free-form build/run provenance (runner, backend,
    sampled-vs-snapped Pallas blocks, ``run_wall_s``, recent errors, ...);
    consumers must tolerate missing keys — the documented schema only
    grows, it never requires (see ``docs/db_format.md``).
    """

    workload_key: str
    trace_json: str
    latency_s: float
    timestamp: float = 0.0
    meta: Dict = field(default_factory=dict)

    def trace(self) -> Trace:
        """Deserialize the stored trace."""
        return Trace.from_json(self.trace_json)


_RECORD_FIELDS = {f.name for f in fields(TuningRecord)}
_REQUIRED_FIELDS = ("workload_key", "trace_json", "latency_s")


def sidecar_path(db_path: str, kind: str) -> str:
    """Path of a persistence sidecar next to a tuning database.

    ``sidecar_path("results/tuning_db.json", "model")`` ->
    ``"results/tuning_db.model.json"`` — the cost model and the learned
    sampling distributions live beside the database they were trained on,
    so CI caching and cross-run warm starts move them as one unit.
    """
    base = db_path[:-5] if db_path.endswith(".json") else db_path
    return f"{base}.{kind}.json"


class Database:
    """Top-k tuning records per workload key, persisted as JSON."""

    def __init__(self, path: Optional[str] = None, top_k: int = 5):
        self.path = path
        self.top_k = top_k
        self.records: Dict[str, List[TuningRecord]] = {}
        if path and os.path.exists(path):
            self.load()

    # -- persistence (atomic rename so concurrent readers never see junk) --

    def load(self) -> None:
        """Load records from ``self.path``, tolerating schema drift.

        Forward/backward compatibility with the documented schema: unknown
        top-level record fields (written by a newer version) are dropped,
        optional fields (``timestamp``, ``meta``) default when absent, and
        records missing a required field are skipped rather than failing
        the whole load.
        """
        with open(self.path) as f:
            raw = json.load(f)
        self.records = {}
        for k, v in raw.items():
            rows = []
            for r in v:
                if not isinstance(r, dict) or any(
                    fld not in r for fld in _REQUIRED_FIELDS
                ):
                    continue
                rows.append(
                    TuningRecord(
                        **{kk: vv for kk, vv in r.items() if kk in _RECORD_FIELDS}
                    )
                )
            if rows:
                self.records[k] = rows

    def save(self) -> None:
        """Atomically write the database JSON to ``self.path`` (no-op when
        the database is in-memory only)."""
        if not self.path:
            return
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(
                    {k: [asdict(r) for r in v] for k, v in self.records.items()},
                    f,
                )
            os.replace(tmp, self.path)
        finally:
            # serialization failure: drop the temp file, leave the last
            # complete database on disk untouched
            if os.path.exists(tmp):
                os.unlink(tmp)

    # -- API ----------------------------------------------------------------

    def put(self, rec: TuningRecord) -> None:
        """Insert a record, keeping the best ``top_k`` per workload.

        Records for an identical trace are deduplicated: the lower-latency
        measurement wins and its meta (build/run provenance) is kept,
        augmented with a re-measurement count — so repeated bests from a
        caching runner never crowd the top-k with copies of one schedule.
        """
        rows = self.records.setdefault(rec.workload_key, [])
        for i, old in enumerate(rows):
            if old.trace_json == rec.trace_json:
                keep, drop = (rec, old) if rec.latency_s <= old.latency_s else (old, rec)
                n_seen = max(old.meta.get("times_measured", 1), 1) + 1
                keep.meta = {**drop.meta, **keep.meta, "times_measured": n_seen}
                rows[i] = keep
                break
        else:
            rows.append(rec)
        rows.sort(key=lambda r: r.latency_s)
        del rows[self.top_k:]
        self.save()

    def put_batch(self, recs: List[TuningRecord]) -> None:
        """Insert many records with a single save at the end."""
        path, self.path = self.path, None
        try:
            for r in recs:
                self.put(r)
        finally:
            self.path = path
        self.save()

    def best(self, workload_key: str) -> Optional[TuningRecord]:
        """The lowest-latency record for a workload key, or ``None``."""
        rows = self.records.get(workload_key)
        return rows[0] if rows else None

    def top(self, workload_key: str, k: int) -> List[TuningRecord]:
        """The ``k`` lowest-latency records for a workload key."""
        return self.records.get(workload_key, [])[:k]

    def keys(self) -> List[str]:
        """All workload keys with at least one record."""
        return list(self.records.keys())


def workload_key(name: str, **shape_kwargs) -> str:
    """Canonical workload key: ``name/k1=v1/k2=v2`` with sorted kwargs."""
    parts = [name] + [f"{k}={v}" for k, v in sorted(shape_kwargs.items())]
    return "/".join(parts)


def parse_workload_key(key: str) -> Tuple[str, Dict]:
    """Inverse of :func:`workload_key`: ``"dense/k=32/m=8"`` ->
    ``("dense", {"k": 32, "m": 8})``.  Values parse as int, then float,
    then stay strings (e.g. ``epilogue=bias_gelu``)."""
    parts = key.split("/")
    kwargs: Dict = {}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"malformed workload key segment {p!r} in {key!r}")
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                kwargs[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            kwargs[k] = v
    return parts[0], kwargs
