"""Measurement protocol: the builder/runner split of the paper's Figure 7.

The tuning loop produces candidate traces; turning a candidate into a
latency number is the job of this subsystem, decomposed exactly as in
MetaSchedule's architecture:

    MeasureInput  -- what to measure: (workload_key, func, trace)
    Builder       -- lowers + compiles a batch of inputs -> BuildResult
    Runner        -- times built artifacts (or does build+run fused when the
                     build cannot cross a process boundary) -> MeasureResult

Implementations live in sibling modules: :mod:`local` (in-process,
serial), :mod:`pool` (process-pool parallel with timeouts and crash
quarantine), :mod:`rpc` (a fleet of worker processes over a JSON wire
protocol) and :mod:`cached` (trace-hash memoization wrapper).  All are
selectable by name through :mod:`registry`.

Contract invariants every ``Runner`` must keep:

* ``run(inputs)`` returns exactly ``len(inputs)`` results **in input
  order**, regardless of internal completion order;
* a rejected candidate (a ``ScheduleRejected`` from the lowering, an
  invalid trace, a first call over the timeout, a worker process that
  died or hung on it) is reported as ``latency_s == inf`` with a
  human-readable ``error``, so the search treats it as rejection; any
  other error (a failed build, a CUDA error) raises in the caller;
* ``stats()`` returns a flat JSON-able dict of counters for provenance.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ...core.schedule import Schedule
from ...core.tir import PrimFunc
from ...core.trace import Trace


@dataclass
class MeasureInput:
    """One candidate to measure.

    ``schedule`` is an optional pre-validated schedule for in-process
    runners; cross-process runners re-replay ``trace`` instead (traces are
    compact and picklable, schedules are not guaranteed to be).
    """

    workload_key: str
    func: PrimFunc
    trace: Trace
    schedule: Optional[Schedule] = None


@dataclass
class BuildResult:
    """Output of a Builder: a runnable artifact or an error.

    ``meta`` carries lowering provenance from the selected backend
    (backend name, snapped Pallas block sizes, fallbacks) — see
    :class:`repro_torch.backends.registry.Lowered`.
    """

    artifact: Optional[Callable] = None  # callable(dict inputs) -> dict outputs
    error: str = ""
    build_time_s: float = 0.0
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.artifact is not None and not self.error


@dataclass
class MeasureResult:
    """Outcome of one measurement.  ``latency_s == inf`` means rejection.

    ``meta`` is the build's lowering provenance (see ``BuildResult.meta``)
    and flows into ``TuningRecord.meta`` for the winning candidates."""

    latency_s: float
    error: str = ""
    build_time_s: float = 0.0
    run_time_s: float = 0.0
    source: str = "measured"  # measured | cache | quarantine | timeout
    meta: Dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return np.isfinite(self.latency_s)

    def as_cache_hit(self) -> "MeasureResult":
        return replace(self, source="cache")


class Builder(abc.ABC):
    """Lowers and compiles a batch of candidates.

    ``backend`` names the lowering-backend spec the builder compiles
    through (see :mod:`repro_torch.backends.registry`)."""

    name: str = "builder"
    backend: str = "jnp"

    @abc.abstractmethod
    def build(self, inputs: List[MeasureInput]) -> List[BuildResult]:
        """Build every input; one BuildResult per input, in order."""


class Runner(abc.ABC):
    """Measures a batch of candidates end to end."""

    name: str = "runner"
    backend: str = "jnp"

    @abc.abstractmethod
    def run(self, inputs: List[MeasureInput]) -> List[MeasureResult]:
        """Measure every input; one MeasureResult per input, in order."""

    def stats(self) -> Dict[str, Any]:
        """Counters for provenance (cache hits, timeouts, crashes...)."""
        return {}

    def close(self) -> None:
        """Release pools/processes.  Idempotent; default is a no-op."""


class LegacyRunnerAdapter(Runner):
    """Wraps the serial ``repro_torch.search.runner.LocalRunner`` (any
    object with ``measure(schedule) -> result``) behind the batch
    protocol, so call sites written against it keep working."""

    name = "legacy-local"

    def __init__(self, inner):
        self.inner = inner

    def run(self, inputs: List[MeasureInput]) -> List[MeasureResult]:
        from ...core.validator import validate_trace

        out: List[MeasureResult] = []
        for mi in inputs:
            sch = mi.schedule
            if sch is None:
                v = validate_trace(mi.func, mi.trace)
                if not v.ok:
                    out.append(
                        MeasureResult(float("inf"), f"invalid trace: {v.reason}")
                    )
                    continue
                sch = v.schedule
            r = self.inner.measure(sch)
            out.append(
                MeasureResult(r.latency_s, getattr(r, "error", "") or "")
            )
        return out
