"""In-process Builder and Runner (serial reference implementation).

``LocalBuilder`` lowers each candidate through the selected lowering
backend (``backend=`` registry spec, default ``"cuda"``); ``LocalRunner``
times the artifacts on one device.  Inputs are ``random_inputs(func, 0)``,
moved to the device once per workload (on a CUDA device drawn there from a
generator seeded 0: ``device_inputs``).  On a CUDA device every call is
bracketed by CUDA events; on the CPU by ``perf_counter``; the latency is
the median of the repeats.

Only a schedule rejection — a ``ScheduleRejected`` from the lowering (the
tile does not divide, or exceeds the grid, shared-memory or thread caps),
an invalid trace or a first call over the timeout — becomes an ``inf``
latency.  A failed kernel build, a refused launch, a fault on the card or
any other error propagates: it must never look like a search where every
candidate was merely rejected.  The process-pool and RPC runners raise
such an error from a worker as :class:`MeasurementFault`.

Timing holds the card alone (:func:`timing_lock`): several measuring
processes may share one card, and without MPS the card time-slices them,
so CUDA events in one process would count the others' kernels.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from ...backends.registry import DEFAULT_BACKEND, get_backend
from ...core.tir import PrimFunc, random_inputs
from ...core.validator import validate_trace
from ...device import resolve_device
from ...kernels import ScheduleRejected, launch_counts, launches_since
from ...obs import emit, metrics, trace_enabled
from .hashing import structural_hash
from .protocol import Builder, BuildResult, MeasureInput, MeasureResult, Runner


class MeasurementFault(RuntimeError):
    """An error other than a rejection, raised while a worker process
    measured a candidate (a CUDA error, a refused launch, a failed build);
    the message carries the worker's traceback.  It is never turned into
    an ``inf`` latency."""


class LocalBuilder(Builder):
    """Lower each candidate in the current process."""

    name = "local"

    def __init__(self, backend: Optional[str] = None):
        self.backend = backend or DEFAULT_BACKEND
        get_backend(self.backend)  # fail fast on a typo'd spec

    def build(self, inputs: List[MeasureInput]) -> List[BuildResult]:
        be = get_backend(self.backend)
        out: List[BuildResult] = []
        for mi in inputs:
            t0 = time.perf_counter()
            sch = mi.schedule
            if sch is None:
                v = validate_trace(mi.func, mi.trace)
                if not v.ok:
                    out.append(BuildResult(error=f"invalid trace: {v.reason}"))
                else:
                    sch = v.schedule
            if sch is not None:
                try:
                    lowered = be.lower(sch, workload_key=mi.workload_key)
                except ScheduleRejected as e:  # not a crash
                    out.append(
                        BuildResult(
                            error=f"rejected ({e.reason}): {e}",
                            build_time_s=time.perf_counter() - t0,
                        )
                    )
                else:
                    out.append(
                        BuildResult(
                            artifact=lowered.fn,
                            build_time_s=time.perf_counter() - t0,
                            meta=lowered.meta,
                        )
                    )
            br = out[-1]
            metrics().observe(
                "measure.build_s", br.build_time_s, backend=self.backend
            )
            if trace_enabled():
                emit(
                    "measure.build",
                    key=mi.workload_key,
                    hash=structural_hash(mi.workload_key, mi.trace),
                    ok=br.ok,
                    dur_s=br.build_time_s,
                    backend=self.backend,
                    **({"error": br.error} if br.error else {}),
                )
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_call(fn, device: torch.device, repeats: int, warmup: int) -> List[float]:
    """Seconds of each of ``repeats`` calls of ``fn()`` after ``warmup``
    calls: CUDA events around each call on a card, ``perf_counter`` on the
    CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return times


# the directory of the per-card timing locks; processes with different
# temporary directories that share a card set it to one directory
LOCK_DIR_ENV = "REPRO_TIMING_LOCK_DIR"


def timing_lock_path(uuid) -> str:
    """The lock file of the card with ``uuid``: in ``$REPRO_TIMING_LOCK_DIR``
    when set, else in the system temp directory."""
    lock_dir = os.environ.get(LOCK_DIR_ENV) or tempfile.gettempdir()
    return os.path.join(lock_dir, f"repro_torch-timing-{uuid}.lock")


@contextmanager
def timing_lock(device: torch.device):
    """Hold ``device`` alone while timing on it: an exclusive ``flock`` on a
    file named by the card's UUID (:func:`timing_lock_path`), so every
    process timing on the same card, whatever its device index, waits for
    the others.  Lowering and trace replay stay outside the lock and run in
    parallel.  Nothing to hold on the CPU."""
    if device.type != "cuda":
        yield
        return
    index = device.index if device.index is not None else torch.cuda.current_device()
    uuid = torch.cuda.get_device_properties(index).uuid
    with open(timing_lock_path(uuid), "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def time_artifact(
    fn,
    ins,
    repeats: int,
    warmup: int,
    timeout_s: float,
    device: torch.device,
) -> MeasureResult:
    """Shared timing loop: first call with timeout check, then warmup, then
    the median of ``repeats`` timed runs, all under :func:`timing_lock`.
    The result's ``meta["launches"]`` holds the kernel launches the calls
    made, read from the wrappers' counters (absent when none moved, as on
    the CPU).  Exceptions propagate."""
    before = launch_counts()
    with timing_lock(device):
        t0 = time.perf_counter()
        fn(ins)
        _sync(device)
        first = time.perf_counter() - t0
        if first > timeout_s:
            # a completed measurement (the schedule is too slow), cacheable
            res = MeasureResult(
                float("inf"), f"timeout (first call took {first:.2f}s)"
            )
        else:
            times = time_call(lambda: fn(ins), device, repeats, warmup)
            res = MeasureResult(float(np.median(times)), run_time_s=float(sum(times)))
    launched = launches_since(before)
    if launched:
        res.meta["launches"] = launched
    return res


def device_inputs(func: PrimFunc, device: torch.device) -> Dict[str, torch.Tensor]:
    """The workload's timing inputs on ``device``: ``random_inputs(func,
    0)`` off the card.  On a CUDA device they are drawn there, N(0, 1) from
    a ``torch.Generator`` seeded 0, in each buffer's shape and dtype: on
    the host of an H100 machine the float64 draws of one 4.46e9-element
    operand (arctic-480b's experts) took 113 s and 35.7 GB of host memory,
    against 0.02 s on the card (``tools/input_draws.py``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {
            k: torch.from_numpy(v).to(device)
            for k, v in random_inputs(func, 0).items()
        }
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {}
    for b in func.inputs:
        dtype = torch.from_numpy(np.empty(0, np.dtype(b.dtype))).dtype
        x = torch.randn(b.shape, generator=gen, device=device)
        out[b.name] = x if dtype == torch.float32 else x.to(dtype)
    return out


class LocalRunner(Runner):
    """Serial in-process measurement through a ``LocalBuilder``."""

    name = "local"

    def __init__(
        self,
        repeats: int = 3,
        warmup: int = 1,
        timeout_s: float = 10.0,
        backend: Optional[str] = None,
        device: str = "cuda",
    ):
        self.repeats = repeats
        self.warmup = warmup
        self.timeout_s = timeout_s
        self.device = resolve_device(device)
        self.builder = LocalBuilder(backend=backend)
        self.backend = self.builder.backend
        # kernels are built here, before anything is timed: an nvcc build
        # inside the first call would trip the first-call timeout
        get_backend(self.backend).prepare(self.device)
        self._inputs_cache: Dict[str, Dict] = {}
        self.n_measured = 0
        self.n_failed = 0

    def inputs(self, func: PrimFunc) -> Dict[str, torch.Tensor]:
        """The workload's timing inputs on this runner's device, drawn
        (``device_inputs``) once a runner."""
        key = func.name + str(tuple(b.shape for b in func.inputs))
        if key not in self._inputs_cache:
            self._inputs_cache[key] = device_inputs(func, self.device)
        return self._inputs_cache[key]

    def run(self, inputs: List[MeasureInput]) -> List[MeasureResult]:
        built = self.builder.build(inputs)
        out: List[MeasureResult] = []
        for mi, br in zip(inputs, built):
            if not br.ok:
                self.n_failed += 1
                metrics().inc("measure.failed", backend=self.backend)
                out.append(
                    MeasureResult(float("inf"), br.error, build_time_s=br.build_time_s)
                )
                continue
            t0 = time.perf_counter()
            res = time_artifact(
                br.artifact,
                self.inputs(mi.func),
                self.repeats,
                self.warmup,
                self.timeout_s,
                self.device,
            )
            run_wall = time.perf_counter() - t0
            res.build_time_s = br.build_time_s
            res.meta = {**br.meta, **res.meta}
            self.n_measured += 1
            metrics().inc("measure.measured", backend=self.backend)
            metrics().observe("measure.run_s", run_wall, backend=self.backend)
            if not res.ok:
                self.n_failed += 1
                metrics().inc("measure.failed", backend=self.backend)
            if trace_enabled():
                emit(
                    "measure.run",
                    key=mi.workload_key,
                    hash=structural_hash(mi.workload_key, mi.trace),
                    ok=res.ok,
                    latency_s=res.latency_s if res.ok else None,
                    dur_s=run_wall,
                    backend=self.backend,
                    **({"error": res.error} if res.error else {}),
                )
            out.append(res)
        return out

    def measure_plain(self, func: PrimFunc) -> float:
        """Median latency of the workload's plain PyTorch version on this
        runner's device — the baseline ``tune_workload`` reports."""
        from ...backends.gpu_backend import plain

        fn = plain(func)
        ins = self.inputs(func)
        with timing_lock(self.device):
            fn(ins)
            times = time_call(lambda: fn(ins), self.device,
                              max(self.repeats, 2), self.warmup)
        return float(np.median(times))

    def stats(self):
        return {
            "measured": self.n_measured,
            "failed": self.n_failed,
            "backend": self.backend,
            "device": str(self.device),
        }
