"""Fault tolerance: retry-with-backoff, straggler detection, and a
crash-resilient training loop.

At 1000+-node scale the failure model is: preemptions/hardware faults kill
the job (checkpoint/restart handles these), transient runtime errors abort
a step (retry handles these), and slow hosts stretch step time (the
straggler detector flags them for the scheduler to replace).  On a real
cluster the detector consumes per-host step timestamps; here it consumes
the local step-time series — the policy is identical.

A copy of the JAX package's ``training/fault_tolerance.py`` (which imports
only numpy), rewired to this package: ``FaultTolerantDriver`` checkpoints
through the port's ``training/checkpoint.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


class StepFailure(RuntimeError):
    pass


def retry(fn: Callable, max_attempts: int = 3, backoff_s: float = 0.5):
    """Run ``fn`` with exponential-backoff retries on transient failures."""
    last: Optional[Exception] = None
    for attempt in range(max_attempts):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — deliberately broad
            last = e
            if attempt + 1 < max_attempts:
                time.sleep(backoff_s * (2**attempt))
    raise StepFailure(f"step failed after {max_attempts} attempts: {last}")


@dataclass
class StragglerDetector:
    """Flags steps (hosts) whose duration exceeds median x threshold.

    Mitigations at scale: re-shard its data slice, eject the host and
    rescale the mesh (see checkpoint.restore's elastic reshard), or enable
    backup execution.  This detector provides the signal.
    """

    window: int = 32
    threshold: float = 2.0
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        self.times.append(duration_s)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 8:
            med = float(np.median(self.times))
            if duration_s > self.threshold * med:
                self.flagged.append(step)
                return True
        return False

    @property
    def median_step_s(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@dataclass
class FaultTolerantDriver:
    """Wraps a step function with retry + straggler detection + periodic
    checkpointing; resumes from the latest checkpoint after a crash."""

    step_fn: Callable  # (state, batch) -> (state, metrics)
    ckpt_dir: str
    ckpt_every: int = 100
    keep_last: int = 3
    max_retries: int = 3

    def run(self, state, pipeline, num_steps: int, start_step: int = 0):
        from . import checkpoint as ckpt

        detector = StragglerDetector()
        it = pipeline.iter_from(start_step)
        step = start_step
        for batch in it:
            if step >= num_steps:
                break
            t0 = time.perf_counter()
            state, metrics = retry(
                lambda: self.step_fn(state, batch), self.max_retries
            )
            dt = time.perf_counter() - t0
            if detector.record(step, dt):
                print(f"[ft] step {step}: straggler ({dt:.2f}s vs median "
                      f"{detector.median_step_s:.2f}s)")
            step += 1
            if step % self.ckpt_every == 0:
                ckpt.save(self.ckpt_dir, step, state)
                ckpt.gc_old(self.ckpt_dir, self.keep_last)
        return state, step
