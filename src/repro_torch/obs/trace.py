"""Structured event tracer: span-scoped JSONL events with ~zero off cost.

Instrumented code calls :func:`emit` (point event) or :func:`span`
(duration event with automatic parent linkage).  When tracing is off —
the default — both are a single ``is None`` check, so the hot paths in
the search/measure/dispatch/serving stack pay nothing.

Event schema (one JSON object per line in a JSONL sink)::

    {"ev": "measure.run",        # event type
     "ts": 12.345678,            # monotonic seconds (process clock)
     "pid": 4242,
     "span": 7, "parent": 3,     # span id / enclosing span id (0 = root)
     "dur_s": 0.0123,            # span events only
     ...}                        # free-form event fields

Enable ambiently with the ``REPRO_TRACE`` environment variable:

* unset / ``""`` / ``0`` — off;
* ``1`` / ``true`` / ``on`` — JSONL to ``REPRO_TRACE_PATH`` (default
  ``results/trace.jsonl``);
* ``console`` — compact lines to stdout;
* anything else — treated as a JSONL file path.

or programmatically via :func:`configure_tracing` (tests pass a
:class:`RingBufferSink`).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

DEFAULT_TRACE_PATH = "results/trace.jsonl"


# -- sinks -------------------------------------------------------------------


class Sink:
    def write(self, event: Dict[str, Any]) -> None:  # pragma: no cover
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class NullSink(Sink):
    def write(self, event: Dict[str, Any]) -> None:
        pass


class RingBufferSink(Sink):
    """In-memory ring for tests and short-lived diagnostics."""

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self.events: List[Dict[str, Any]] = []

    def write(self, event: Dict[str, Any]) -> None:
        self.events.append(event)
        if len(self.events) > self.capacity:
            del self.events[: len(self.events) - self.capacity]

    def of_type(self, ev: str) -> List[Dict[str, Any]]:
        return [e for e in self.events if e.get("ev") == ev]


class JsonlSink(Sink):
    """One JSON object per line, flushed per event (crash-safe traces
    beat buffered throughput for a diagnostics stream)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._lock = threading.Lock()

    def _handle(self):
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")
        return self._fh

    def write(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, default=_json_default)
        with self._lock:
            fh = self._handle()
            fh.write(line + "\n")
            fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


class ConsoleSink(Sink):
    """Compact human lines — the ``verbose=True`` alias of the tracer."""

    META = ("ev", "ts", "pid", "span", "parent")

    def write(self, event: Dict[str, Any]) -> None:
        parts = [str(event.get("ev", "?"))]
        for k, v in event.items():
            if k in self.META:
                continue
            if isinstance(v, float):
                v = f"{v:.6g}"
            parts.append(f"{k}={v}")
        print(" ".join(parts))


def _json_default(x: Any) -> Any:
    """Last-resort JSON coercion (numpy scalars etc. show up in fields)."""
    for attr in ("item",):
        if hasattr(x, attr):
            try:
                return x.item()
            except Exception:
                pass
    return str(x)


# -- tracer ------------------------------------------------------------------


class Tracer:
    def __init__(self, sinks: List[Sink]):
        self.sinks = list(sinks)
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> List[int]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def next_id(self) -> int:
        with self._lock:
            return next(self._ids)

    def current_span(self) -> int:
        stack = self._stack()
        return stack[-1] if stack else 0

    def emit(
        self,
        ev: str,
        *,
        span_id: Optional[int] = None,
        parent: Optional[int] = None,
        dur_s: Optional[float] = None,
        **fields,
    ) -> Dict[str, Any]:
        event: Dict[str, Any] = {
            "ev": ev,
            "ts": round(time.monotonic(), 6),
            "pid": os.getpid(),
        }
        if span_id is not None:
            event["span"] = span_id
        p = parent if parent is not None else self.current_span()
        if p:
            event["parent"] = p
        if dur_s is not None:
            event["dur_s"] = round(dur_s, 6)
        event.update(fields)
        for sink in self.sinks:
            try:
                sink.write(event)
            except Exception:
                pass  # a broken sink must never take down the tuner
        return event

    def span(self, ev: str, **fields) -> "_Span":
        return _Span(self, ev, fields)

    def flush(self) -> None:
        for sink in self.sinks:
            sink.flush()

    def close(self) -> None:
        for sink in self.sinks:
            sink.close()


class _Span:
    """Context manager: emits one event at exit with ``dur_s`` and links
    children emitted inside to it via the thread-local span stack."""

    __slots__ = ("tracer", "ev", "fields", "id", "parent", "t0")

    def __init__(self, tracer: Tracer, ev: str, fields: Dict[str, Any]):
        self.tracer = tracer
        self.ev = ev
        self.fields = fields
        self.id = 0
        self.parent = 0
        self.t0 = 0.0

    def note(self, **fields) -> None:
        """Attach fields known only at the end (results, counts...)."""
        self.fields.update(fields)

    def __enter__(self) -> "_Span":
        self.id = self.tracer.next_id()
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        dur = time.monotonic() - self.t0
        stack = self.tracer._stack()
        if stack and stack[-1] == self.id:
            stack.pop()
        if exc_type is not None:
            self.fields.setdefault("error", exc_type.__name__)
        self.tracer.emit(
            self.ev,
            span_id=self.id,
            parent=self.parent or None,
            dur_s=dur,
            **self.fields,
        )


class _NullSpan:
    """Shared no-op span: the entire cost of a disabled ``span(...)``."""

    __slots__ = ()
    id = 0

    def note(self, **fields) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()
_tracer: Optional[Tracer] = None


# -- module-level API (what instrumented code calls) -------------------------


def tracer() -> Optional[Tracer]:
    return _tracer


def trace_enabled() -> bool:
    return _tracer is not None


def emit(ev: str, **fields) -> None:
    t = _tracer
    if t is None:
        return
    t.emit(ev, **fields)


def span(ev: str, **fields):
    t = _tracer
    if t is None:
        return _NULL_SPAN
    return t.span(ev, **fields)


def configure_tracing(
    sink: Optional[Sink] = None, path: Optional[str] = None
) -> Tracer:
    """Install a process-wide tracer (replacing any current one) and emit
    a ``trace.start`` anchor event carrying the wall-clock epoch."""
    global _tracer
    disable_tracing()
    if sink is None:
        sink = JsonlSink(path or DEFAULT_TRACE_PATH)
    _tracer = Tracer([sink])
    _tracer.emit("trace.start", wall_time=time.time())
    return _tracer


def disable_tracing() -> None:
    global _tracer
    t, _tracer = _tracer, None
    if t is not None:
        t.close()


def init_from_env(environ=None) -> Optional[Tracer]:
    """Apply the ambient ``REPRO_TRACE`` setting (called at import)."""
    env = environ if environ is not None else os.environ
    raw = (env.get("REPRO_TRACE") or "").strip()
    if not raw or raw == "0":
        return None
    if raw.lower() in ("1", "true", "on"):
        return configure_tracing(
            path=env.get("REPRO_TRACE_PATH", DEFAULT_TRACE_PATH)
        )
    if raw.lower() == "console":
        return configure_tracing(sink=ConsoleSink())
    return configure_tracing(path=raw)


init_from_env()
