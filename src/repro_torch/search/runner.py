"""Legacy serial measurement runner: f(e) — the device latency of a
lowered schedule.

A thin layer over the batch protocol's serial
:class:`~repro_torch.search.measure.local.LocalRunner`: one schedule is
lowered through the selected backend (``"cuda"`` by default) and timed on
one device (CUDA events on a card, ``perf_counter`` on the CPU, under the
card's timing lock).  Only a rejection — a ``ScheduleRejected`` from the
lowering or a first call over the timeout — gives an ``inf`` latency,
which the search treats as rejection; any other error raises, as in
:mod:`repro_torch.search.measure.local`.

The search stack talks to the batch protocol in
:mod:`repro_torch.search.measure` (builder/runner split, process-pool and
RPC measurement, trace-hash caching); this module remains as the
in-process serial path — ``measure.as_runner`` adapts it — and as the home
of ``baseline()``, the plain version's time that reports compare against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..core.schedule import Schedule
from ..core.tir import PrimFunc
from .measure.local import LocalRunner as _BatchRunner
from .measure.local import time_call, timing_lock
from .measure.protocol import MeasureInput


@dataclass
class MeasureResult:
    """Latency of one measured schedule (legacy serial protocol)."""

    latency_s: float  # median device time; inf on rejection
    error: str = ""

    @property
    def ok(self) -> bool:
        """Whether the measurement succeeded (finite latency)."""
        return np.isfinite(self.latency_s)


class LocalRunner:
    """Measure schedules on one device through a lowering backend."""

    def __init__(
        self,
        repeats: int = 3,
        warmup: int = 1,
        timeout_s: float = 10.0,
        check_against_oracle: bool = False,
        backend: Optional[str] = None,
        device: str = "cuda",
    ):
        self.inner = _BatchRunner(
            repeats=repeats, warmup=warmup, timeout_s=timeout_s,
            backend=backend, device=device,
        )
        self.check = check_against_oracle
        self.backend = self.inner.backend
        self.device = self.inner.device

    def measure(self, sch: Schedule) -> MeasureResult:
        """Lower and time one schedule; ``inf`` latency on a rejection."""
        func = sch.func
        mi = MeasureInput(func.name, func, sch.trace, schedule=sch)
        if self.check:
            (br,) = self.inner.builder.build([mi])
            if br.ok:
                ins = self.inner._inputs(func)
                self._check_correct(func, br.artifact(ins), ins)
        (res,) = self.inner.run([mi])
        return MeasureResult(res.latency_s, res.error or "")

    def measure_callable(self, fn: Callable, ins) -> float:
        """Median device time of a callable on ``ins`` (one untimed call,
        then ``max(repeats, 2)`` timed ones)."""
        with timing_lock(self.device):
            times = time_call(lambda: fn(ins), self.device,
                              max(self.inner.repeats, 2), 1)
        return float(np.median(times))

    def baseline(self, func: PrimFunc) -> float:
        """Latency of the workload's plain PyTorch version on this runner's
        device (``LocalRunner.measure_plain`` of the batch protocol)."""
        return self.inner.measure_plain(func)

    def _check_correct(self, func: PrimFunc, out, ins) -> None:
        from ..backends.gpu_backend import plain

        ref = plain(func)(ins)
        for k in ref:
            torch.testing.assert_close(out[k], ref[k], rtol=5e-3, atol=1e-3)
