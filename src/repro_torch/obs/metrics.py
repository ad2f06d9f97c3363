"""Process-wide metrics registry: counters, gauges, histograms.

Every series is ``(name, labels)`` — labels are plain keyword strings
(``task=...``, ``backend=...``, ``model=...``) so the same metric name
fans out per task / workload key / backend without string mangling at
call sites.  Three instrument kinds:

* **counter** — monotonically increasing float (``inc``);
* **gauge** — last-write-wins float (``gauge``);
* **histogram** — bounded ring of observations with ``count``/``sum``/
  ``min``/``max`` tracked exactly and p50/p95/p99 computed from the
  retained window at snapshot time (``observe``).

``snapshot()`` is a plain JSON-able dict and ``merge_snapshots`` folds
any number of them (counters add, gauges last-wins, histogram windows
concatenate and re-quantile) — both pure stdlib, so snapshots can cross
process boundaries as JSON and be combined by the report tool.

A process-wide default registry is reachable via :func:`metrics`; tests
that need isolation construct their own ``MetricsRegistry`` or call
:func:`reset_metrics`.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# exact count/sum/min/max are tracked outside the ring, so capping only
# bounds memory and ages quantiles toward the recent window
MAX_HISTOGRAM_SAMPLES = 4096

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _series_key(name: str, labels: Dict[str, Any]) -> _Key:
    return name, tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def quantile(sorted_values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile of an already-sorted sequence."""
    n = len(sorted_values)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_values[0])
    pos = q * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac)


class _Histogram:
    __slots__ = ("count", "sum", "min", "max", "samples", "_next")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []
        self._next = 0  # ring cursor once the window is full

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if len(self.samples) < MAX_HISTOGRAM_SAMPLES:
            self.samples.append(v)
        else:
            self.samples[self._next] = v
            self._next = (self._next + 1) % MAX_HISTOGRAM_SAMPLES

    def summary(self) -> Dict[str, Any]:
        s = sorted(self.samples)
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
            "p50": quantile(s, 0.50) if s else None,
            "p95": quantile(s, 0.95) if s else None,
            "p99": quantile(s, 0.99) if s else None,
            "samples": list(self.samples),
        }


class MetricsRegistry:
    """Thread-safe labeled counters/gauges/histograms."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._hists: Dict[_Key, _Histogram] = {}

    # -- instruments --------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        k = _series_key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        k = _series_key(name, labels)
        with self._lock:
            self._gauges[k] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        k = _series_key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Histogram()
            h.observe(value)

    # -- reads --------------------------------------------------------------

    def get_counter(self, name: str, **labels) -> float:
        return self._counters.get(_series_key(name, labels), 0.0)

    def get_gauge(self, name: str, **labels) -> Optional[float]:
        return self._gauges.get(_series_key(name, labels))

    def get_histogram(self, name: str, **labels) -> Optional[Dict[str, Any]]:
        h = self._hists.get(_series_key(name, labels))
        return h.summary() if h is not None else None

    # -- snapshot / merge / export ------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": [
                    {"name": n, "labels": dict(ls), "value": v}
                    for (n, ls), v in sorted(self._counters.items())
                ],
                "gauges": [
                    {"name": n, "labels": dict(ls), "value": v}
                    for (n, ls), v in sorted(self._gauges.items())
                ],
                "histograms": [
                    {"name": n, "labels": dict(ls), **h.summary()}
                    for (n, ls), h in sorted(self._hists.items())
                ],
            }

    @staticmethod
    def merge_snapshots(*snapshots: Dict[str, Any]) -> Dict[str, Any]:
        counters: Dict[_Key, float] = {}
        gauges: Dict[_Key, float] = {}
        hists: Dict[_Key, Dict[str, Any]] = {}
        for snap in snapshots:
            for row in snap.get("counters", []):
                k = _series_key(row["name"], row["labels"])
                counters[k] = counters.get(k, 0.0) + row["value"]
            for row in snap.get("gauges", []):
                gauges[_series_key(row["name"], row["labels"])] = row["value"]
            for row in snap.get("histograms", []):
                k = _series_key(row["name"], row["labels"])
                cur = hists.get(k)
                if cur is None:
                    hists[k] = {key: row[key] for key in (
                        "count", "sum", "min", "max", "samples")}
                else:
                    cur["count"] += row["count"]
                    cur["sum"] += row["sum"]
                    mins = [m for m in (cur["min"], row["min"]) if m is not None]
                    maxs = [m for m in (cur["max"], row["max"]) if m is not None]
                    cur["min"] = min(mins) if mins else None
                    cur["max"] = max(maxs) if maxs else None
                    cur["samples"] = (
                        cur["samples"] + row["samples"]
                    )[-MAX_HISTOGRAM_SAMPLES:]
        out_h = []
        for (n, ls), h in sorted(hists.items()):
            s = sorted(h["samples"])
            out_h.append({
                "name": n, "labels": dict(ls), **h,
                "p50": quantile(s, 0.50) if s else None,
                "p95": quantile(s, 0.95) if s else None,
                "p99": quantile(s, 0.99) if s else None,
            })
        return {
            "counters": [
                {"name": n, "labels": dict(ls), "value": v}
                for (n, ls), v in sorted(counters.items())
            ],
            "gauges": [
                {"name": n, "labels": dict(ls), "value": v}
                for (n, ls), v in sorted(gauges.items())
            ],
            "histograms": out_h,
        }

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_DEFAULT = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide default registry."""
    return _DEFAULT


def reset_metrics() -> None:
    _DEFAULT.reset()


# -- rank correlation (shared by the search and the report tool) -------------


def _ranks(values: Sequence[float]) -> List[float]:
    """Average ranks (ties share the mean of their positions)."""
    n = len(values)
    order = sorted(range(n), key=lambda i: values[i])
    ranks = [0.0] * n
    i = 0
    while i < n:
        j = i
        while j + 1 < n and values[order[j + 1]] == values[order[i]]:
            j += 1
        r = (i + j) / 2.0
        for k in range(i, j + 1):
            ranks[order[k]] = r
        i = j + 1
    return ranks


def spearman(x: Sequence[float], y: Sequence[float]) -> Optional[float]:
    """Spearman rank correlation; None when undefined (n < 2 or a
    constant side)."""
    if len(x) != len(y) or len(x) < 2:
        return None
    rx, ry = _ranks(list(x)), _ranks(list(y))
    mx = sum(rx) / len(rx)
    my = sum(ry) / len(ry)
    sxx = sum((a - mx) ** 2 for a in rx)
    syy = sum((b - my) ** 2 for b in ry)
    if sxx <= 0 or syy <= 0:
        return None
    sxy = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    return sxy / (sxx * syy) ** 0.5
