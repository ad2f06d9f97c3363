"""Observability: process-wide metrics registry + structured event tracer.

The instrumented stack (search, measure, dispatch, serving) imports from
this package only — ``from ..obs import emit, span, metrics`` — so the
whole layer can be reasoned about (and disabled) in one place.  Tracing
is off unless ``REPRO_TRACE`` is set (see :mod:`repro_torch.obs.trace`);
metrics are always on (dict updates, no I/O).
"""

from .metrics import (  # noqa: F401
    MetricsRegistry,
    metrics,
    quantile,
    reset_metrics,
    spearman,
)
from .trace import (  # noqa: F401
    ConsoleSink,
    JsonlSink,
    NullSink,
    RingBufferSink,
    Sink,
    Tracer,
    configure_tracing,
    disable_tracing,
    emit,
    init_from_env,
    span,
    trace_enabled,
    tracer,
)

__all__ = [
    "MetricsRegistry",
    "metrics",
    "reset_metrics",
    "quantile",
    "spearman",
    "ConsoleSink",
    "JsonlSink",
    "NullSink",
    "RingBufferSink",
    "Sink",
    "Tracer",
    "configure_tracing",
    "disable_tracing",
    "emit",
    "init_from_env",
    "span",
    "trace_enabled",
    "tracer",
]
