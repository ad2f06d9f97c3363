"""Trace-hash measurement cache.

Evolutionary mutation routinely regenerates candidates that were already
measured (in an earlier round, for a sibling task with the same workload
key, or twice within one batch).  ``CachedRunner`` wraps any ``Runner``
and memoizes results by the canonical structural hash of
``(workload_key, trace)``, so a duplicate costs a dict lookup instead of
a build + hardware measurement.  Failures are cached too — re-measuring
a schedule that cannot compile is as wasteful as re-measuring a good one.
"""

from __future__ import annotations

from typing import Any, Dict, List

from ...obs import emit, metrics, trace_enabled
from .hashing import structural_hash
from .protocol import MeasureInput, MeasureResult, Runner


class CachedRunner(Runner):
    def __init__(self, inner: Runner, cache_failures: bool = True):
        self.inner = inner
        self.cache_failures = cache_failures
        self.cache: Dict[str, MeasureResult] = {}
        self.hits = 0
        self.misses = 0

    @property
    def name(self) -> str:  # type: ignore[override]
        return f"cached+{self.inner.name}"

    @property
    def backend(self) -> str:  # type: ignore[override]
        return getattr(self.inner, "backend", "jnp")

    def _hash(self, mi: MeasureInput) -> str:
        # the backend is part of the cache key: the same trace measures
        # differently through different lowerings
        return structural_hash(f"{self.backend}::{mi.workload_key}", mi.trace)

    def _note(self, hit: bool, key: str, h: str) -> None:
        metrics().inc(
            "cache.hits" if hit else "cache.misses", backend=self.backend
        )
        if trace_enabled():
            emit(
                "cache.hit" if hit else "cache.miss",
                key=key,
                hash=h,
                backend=self.backend,
            )

    def run(self, inputs: List[MeasureInput]) -> List[MeasureResult]:
        results: List[MeasureResult] = [None] * len(inputs)  # type: ignore[list-item]
        primary: List[int] = []          # first occurrence of each missing hash
        primary_hash: List[str] = []
        followers: Dict[str, List[int]] = {}  # intra-batch duplicates
        for i, mi in enumerate(inputs):
            h = self._hash(mi)
            if h in self.cache:
                self.hits += 1
                self._note(True, mi.workload_key, h)
                results[i] = self.cache[h].as_cache_hit()
            elif h in followers:
                self.hits += 1
                self._note(True, mi.workload_key, h)
                followers[h].append(i)
            else:
                self.misses += 1
                self._note(False, mi.workload_key, h)
                primary.append(i)
                primary_hash.append(h)
                followers[h] = []
        if primary:
            fresh = self.inner.run([inputs[i] for i in primary])
            for i, h, res in zip(primary, primary_hash, fresh):
                results[i] = res
                # never cache timeouts/quarantines: a batch-budget timeout
                # can hit candidates that were still queued and never ran —
                # caching that would blacklist schedules nobody measured
                transient = res.source in ("timeout", "quarantine")
                if (res.ok or self.cache_failures) and not transient:
                    self.cache[h] = res
                for j in followers[h]:
                    results[j] = res.as_cache_hit()
        return results

    def stats(self) -> Dict[str, Any]:
        inner = {f"inner_{k}": v for k, v in self.inner.stats().items()}
        return {
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "cache_size": len(self.cache),
            **inner,
        }

    def close(self) -> None:
        self.inner.close()
