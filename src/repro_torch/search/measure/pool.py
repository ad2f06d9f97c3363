"""Process-pool measurement: parallel build+time with fault isolation.

Each worker process takes a candidate (the pre-validated schedule when
it ships, else a trace replay), lowers it through the lowering backend
named in the payload (see :mod:`repro_torch.backends.registry`) and times
it on the payload's device — build and run are fused inside the worker
because lowered callables cannot cross a process boundary.  Workers that
share one card take turns at timing (:func:`.local.timing_lock`), while
their lowering and trace replay overlap.  The parent enforces:

* **wall-clock timeouts** — a batch gets ``timeout_s`` per candidate
  (scaled by pool width on the CPU; on a card, where the workers time
  one at a time, by the whole batch); candidates still pending at the
  deadline are rejected with ``inf`` and the pool is torn down so hung
  workers cannot leak into the next round;
* **failure quarantine** — when a worker process dies (OOM, a segfault,
  ...) the batch's unfinished candidates are retried one at a time in a
  fresh pool to attribute the death; a trace whose structural hash kills
  a worker ``crash_threshold`` times is blacklisted and never submitted
  again;
* **no hidden faults** — a worker that raises anything but a rejection
  (a CUDA error, a refused launch, a failed build) does not die: its
  traceback comes back and the parent raises :class:`.local.MeasurementFault`;
* **deterministic ordering** — results always align with the input list,
  regardless of which worker finished first.

Workers are spawned (never forked: the parent holds a CUDA context, and
CUDA cannot fork).  The parent builds the backend's kernels before the
first spawn, so workers load them and never run ``nvcc`` side by side.
Worker startup (the torch import and the CUDA context, seconds) is
amortized by keeping the pool alive across ``run()`` batches; ``warm()``
pre-spawns workers so that startup overlaps the parent's own work.
"""

from __future__ import annotations

import concurrent.futures as cf
import math
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures.process import BrokenProcessPool
from typing import Callable, Dict, List, Optional, Set, Tuple

from ...obs import emit, metrics, trace_enabled
from .hashing import structural_hash
from .local import MeasurementFault
from .protocol import MeasureInput, MeasureResult, Runner


_WORKER_INPUT_CACHE: dict = {}  # per worker process: func signature -> device tensors


def _measure_worker(payload: dict) -> dict:
    """Runs inside a worker process: replay -> lower -> time.

    Takes/returns plain dicts so stub workers in tests can swap in
    without touching the pool logic.  A rejection (an invalid trace, a
    ``ScheduleRejected`` from the lowering, a first call over the
    timeout) comes back as an ``inf`` latency; any other exception
    propagates to the parent.
    """
    t_start = time.perf_counter()
    from ...backends.registry import get_backend
    from ...core.trace import Trace
    from ...core.validator import validate_trace
    from ...device import resolve_device
    from ...kernels import ScheduleRejected
    from .local import device_inputs, time_artifact

    func = payload["func"]
    sch = payload.get("schedule")
    if sch is None:
        # no pre-validated schedule shipped: replay the trace here
        trace = Trace.from_json(payload["trace_json"])
        v = validate_trace(func, trace)
        if not v.ok:
            return {
                "latency_s": float("inf"),
                "error": f"invalid trace: {v.reason}",
                "build_time_s": 0.0,
                "run_time_s": 0.0,
            }
        sch = v.schedule
    try:
        lowered = get_backend(payload["backend"]).lower(
            sch, workload_key=payload.get("workload_key", "")
        )
    except ScheduleRejected as e:  # not a fault
        return {
            "latency_s": float("inf"),
            "error": f"rejected ({e.reason}): {e}",
            "build_time_s": time.perf_counter() - t_start,
            "run_time_s": 0.0,
        }
    device = resolve_device(payload["device"])
    ins_key = func.name + str(tuple(b.shape for b in func.inputs))
    ins = _WORKER_INPUT_CACHE.get(ins_key)
    if ins is None:
        ins = _WORKER_INPUT_CACHE[ins_key] = device_inputs(func, device)
    build_s = time.perf_counter() - t_start
    # the one shared timing loop (first-call timeout, warmup, median)
    t_run = time.perf_counter()
    res = time_artifact(
        lowered.fn, ins, payload["repeats"], payload["warmup"],
        payload["timeout_s"], device,
    )
    # full run-stage wall (incl. first call + warmup): the parent's
    # measure.run events and the report's time breakdown consume it
    meta = {**lowered.meta, **res.meta}
    meta["run_wall_s"] = round(time.perf_counter() - t_run, 6)
    return {
        "latency_s": res.latency_s,
        "error": res.error,
        "build_time_s": build_s,
        "run_time_s": res.run_time_s,
        "meta": meta,
    }


def _warm_worker(device: str) -> bool:
    """Import the heavy deps and create the device context so the first
    real batch finds workers hot."""
    import torch

    from ...backends import gpu_backend, registry, torch_backend  # noqa: F401
    from ...device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
    return True


def _fault_text(exc: BaseException) -> str:
    """The exception a worker raised, with the worker's own traceback
    (``concurrent.futures`` chains it as the cause)."""
    cause = exc.__cause__
    tb = f"\n{cause}" if cause is not None else ""
    return f"{type(exc).__name__}: {exc}{tb}"


class ProcessPoolRunner(Runner):
    """Builds and times candidates across a pool of worker processes."""

    name = "pool"

    def __init__(
        self,
        max_workers: Optional[int] = None,
        timeout_s: float = 30.0,
        repeats: int = 3,
        warmup: int = 1,
        crash_threshold: int = 2,
        grace_s: float = 10.0,
        startup_grace_s: float = 60.0,
        worker_fn: Optional[Callable[[dict], dict]] = None,
        start_method: str = "spawn",
        backend: Optional[str] = None,
        device: str = "cuda",
    ):
        from ...backends.registry import DEFAULT_BACKEND, get_backend
        from ...device import resolve_device

        self.backend = backend or DEFAULT_BACKEND
        self.device = str(resolve_device(device))
        # workers on one card take turns at timing (timing_lock), so a
        # batch's wall time grows with its size, not with size / width
        self.serial_timing = self.device.startswith("cuda")
        # validate eagerly and build the kernels here, before any worker
        # exists: a typo'd spec or a failed build raises now, and workers
        # load the built libraries instead of running nvcc side by side
        get_backend(self.backend).prepare(self.device)
        self.max_workers = max_workers or min(max(os.cpu_count() or 2, 2), 8)
        self.timeout_s = timeout_s
        self.repeats = repeats
        self.warmup = warmup
        self.crash_threshold = crash_threshold
        self.grace_s = grace_s
        self.startup_grace_s = startup_grace_s
        self.worker_fn = worker_fn or _measure_worker
        self.start_method = start_method
        self._executor: Optional[cf.ProcessPoolExecutor] = None
        self._cold = True  # fresh pool: charge startup to the first batch
        self.crash_counts: Dict[str, int] = {}
        self.quarantined: Set[str] = set()
        self.n_measured = 0
        self.n_timeouts = 0
        self.n_crashes = 0
        self.n_quarantine_rejects = 0

    # -- pool lifecycle -----------------------------------------------------

    @staticmethod
    def _fix_unspawnable_main() -> None:
        """REPL/stdin parents carry ``__main__.__file__ == '<stdin>'`` (or
        another nonexistent path); spawn's preparation step would then try
        to re-run that file in every worker and kill the whole pool.
        Dropping the bogus attribute makes spawn skip main re-execution —
        our workers only need importable modules, never ``__main__``."""
        main = sys.modules.get("__main__")
        mf = getattr(main, "__file__", None)
        if mf and not os.path.exists(mf):
            try:
                del main.__file__
            except AttributeError:
                pass

    def _executor_or_new(self) -> cf.ProcessPoolExecutor:
        if self._executor is None:
            self._fix_unspawnable_main()
            ctx = mp.get_context(self.start_method)
            self._executor = cf.ProcessPoolExecutor(
                max_workers=self.max_workers, mp_context=ctx
            )
            self._cold = True
        return self._executor

    def _kill_pool(self) -> None:
        """Tear down the pool, terminating workers that may be hung."""
        ex, self._executor = self._executor, None
        if ex is None:
            return
        for p in list(getattr(ex, "_processes", {}).values()):
            try:
                p.terminate()
            except Exception:
                pass
        ex.shutdown(wait=False, cancel_futures=True)

    def warm(self, wait: bool = False) -> None:
        """Pre-spawn workers, import their deps and create their device
        contexts.  Async by default (overlaps with the caller's own work);
        ``wait=True`` blocks until every worker is hot and stops charging
        startup to the next batch."""
        ex = self._executor_or_new()
        futs = [ex.submit(_warm_worker, self.device) for _ in range(self.max_workers)]
        if wait:
            for f in futs:
                f.result(timeout=self.startup_grace_s)
            self._cold = False

    def close(self) -> None:
        self._kill_pool()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -- measurement --------------------------------------------------------

    def _payload(self, mi: MeasureInput) -> dict:
        payload = {
            "workload_key": mi.workload_key,
            "func": mi.func,
            "trace_json": mi.trace.to_json(),
            "timeout_s": self.timeout_s,
            "repeats": self.repeats,
            "warmup": self.warmup,
            "backend": self.backend,
            "device": self.device,
        }
        if mi.schedule is not None:
            # ship the pre-validated schedule (it pickles at ~KBs) so the
            # worker skips the replay+validation the parent already did
            payload["schedule"] = mi.schedule
        return payload

    def run(self, inputs: List[MeasureInput]) -> List[MeasureResult]:
        results: List[Optional[MeasureResult]] = [None] * len(inputs)
        live: List[Tuple[int, str, dict]] = []
        for i, mi in enumerate(inputs):
            h = structural_hash(mi.workload_key, mi.trace)
            if h in self.quarantined:
                self.n_quarantine_rejects += 1
                metrics().inc("measure.quarantine_rejects", backend=self.backend)
                if trace_enabled():
                    emit(
                        "measure.quarantine_reject",
                        key=mi.workload_key,
                        hash=h,
                        backend=self.backend,
                    )
                results[i] = MeasureResult(
                    float("inf"),
                    "quarantined after repeated worker crashes",
                    source="quarantine",
                )
            else:
                live.append((i, h, self._payload(mi)))
        if live:
            self._run_live(live, results)
        return results  # type: ignore[return-value]

    def _emit_result(self, h: str, payload: dict, out: dict) -> None:
        """Parent-side telemetry for one completed worker measurement
        (build and run happened fused inside the worker)."""
        key = payload.get("workload_key", "")
        meta = out.get("meta") or {}
        ok = not out.get("error")
        build_s = float(out.get("build_time_s", 0.0))
        run_wall = float(meta.get("run_wall_s", out.get("run_time_s", 0.0)))
        metrics().inc("measure.measured", backend=self.backend)
        if not ok:
            metrics().inc("measure.failed", backend=self.backend)
        metrics().observe("measure.build_s", build_s, backend=self.backend)
        metrics().observe("measure.run_s", run_wall, backend=self.backend)
        if trace_enabled():
            emit(
                "measure.build",
                key=key,
                hash=h,
                ok=ok,
                dur_s=build_s,
                backend=self.backend,
            )
            emit(
                "measure.run",
                key=key,
                hash=h,
                ok=ok,
                latency_s=out["latency_s"] if ok else None,
                dur_s=run_wall,
                backend=self.backend,
                **({"error": out["error"]} if out.get("error") else {}),
            )

    def _emit_timeout(self, h: str, key: str, note: str) -> None:
        metrics().inc("measure.timeouts", backend=self.backend)
        if trace_enabled():
            emit(
                "measure.timeout",
                key=key,
                hash=h,
                timeout_s=self.timeout_s,
                note=note,
                backend=self.backend,
            )

    def _fault(self, payload: dict, exc: BaseException) -> MeasurementFault:
        """Tear the pool down (its other futures are abandoned) and name
        the candidate whose worker raised."""
        self._kill_pool()
        return MeasurementFault(
            f"measuring {payload.get('workload_key', '')!r} raised in a pool "
            f"worker: {_fault_text(exc)}"
        )

    def _run_live(
        self,
        live: List[Tuple[int, str, dict]],
        results: List[Optional[MeasureResult]],
    ) -> None:
        ex = self._executor_or_new()
        futs = {}
        for i, h, payload in live:
            futs[ex.submit(self.worker_fn, payload)] = (i, h, payload)
        if self.serial_timing:
            waves = len(live)
        else:
            waves = math.ceil(len(live) / self.max_workers)
        budget = self.timeout_s * waves + self.grace_s
        if self._cold:
            budget += self.startup_grace_s
        pending = set(futs)
        crashed: List[Tuple[int, str, dict]] = []
        broken = False
        try:
            for fut in cf.as_completed(list(futs), timeout=budget):
                pending.discard(fut)
                self._cold = False  # a worker has answered: pool is hot
                i, h, payload = futs[fut]
                try:
                    out = fut.result()
                except BrokenProcessPool:
                    # worker process died; every pending future is now dead
                    # too — retry each in isolation to attribute the crash
                    broken = True
                    crashed.append((i, h, payload))
                    break
                except Exception as e:  # raised inside a live worker
                    raise self._fault(payload, e) from e
                results[i] = MeasureResult(**out)
                self.n_measured += 1
                self._emit_result(h, payload, out)
        except cf.TimeoutError:
            self.n_timeouts += len(pending)
            for fut in pending:
                i, h, payload = futs[fut]
                self._emit_timeout(
                    h, payload.get("workload_key", ""), "batch budget"
                )
                results[i] = MeasureResult(
                    float("inf"),
                    f"timeout (exceeded {self.timeout_s:.1f}s/candidate batch budget)",
                    source="timeout",
                )
            self._kill_pool()
            return
        if broken:
            crashed.extend(futs[f] for f in pending)
            crashed.sort(key=lambda t: t[0])
            self._kill_pool()
            for i, h, payload in crashed:
                results[i] = self._run_isolated(h, payload)

    def _run_isolated(self, h: str, payload: dict) -> MeasureResult:
        """Re-run one candidate alone in a fresh pool: a crash here is
        definitively attributable to this trace."""
        ex = self._executor_or_new()
        fut = ex.submit(self.worker_fn, payload)
        deadline = self.timeout_s + self.grace_s
        if self._cold:
            deadline += self.startup_grace_s
        try:
            out = fut.result(timeout=deadline)
        except cf.TimeoutError:
            self.n_timeouts += 1
            self._kill_pool()
            self._emit_timeout(
                h, payload.get("workload_key", ""), "isolated retry"
            )
            return MeasureResult(
                float("inf"),
                f"timeout (exceeded {self.timeout_s:.1f}s, isolated retry)",
                source="timeout",
            )
        except BrokenProcessPool as e:
            return self._attribute_crash(h, payload, e)
        except Exception as e:  # raised inside a live worker
            raise self._fault(payload, e) from e
        self.n_measured += 1
        self._cold = False
        self._emit_result(h, payload, out)
        return MeasureResult(**out)

    def _attribute_crash(
        self, h: str, payload: dict, exc: BaseException
    ) -> MeasureResult:
        self.n_crashes += 1
        self._kill_pool()
        n = self.crash_counts.get(h, 0) + 1
        self.crash_counts[h] = n
        key = payload.get("workload_key", "")
        metrics().inc("measure.crashes", backend=self.backend)
        if trace_enabled():
            emit(
                "measure.crash",
                key=key,
                hash=h,
                crash=n,
                threshold=self.crash_threshold,
                error=type(exc).__name__,
                backend=self.backend,
            )
        msg = f"worker crashed ({type(exc).__name__}), crash {n}/{self.crash_threshold}"
        if n >= self.crash_threshold:
            self.quarantined.add(h)
            metrics().inc("measure.quarantined", backend=self.backend)
            if trace_enabled():
                emit(
                    "measure.crash_quarantine",
                    key=key,
                    hash=h,
                    crashes=n,
                    backend=self.backend,
                )
            msg += "; trace quarantined"
        return MeasureResult(float("inf"), msg)

    def stats(self) -> Dict:
        return {
            "measured": self.n_measured,
            "timeouts": self.n_timeouts,
            "crashes": self.n_crashes,
            "quarantined_traces": len(self.quarantined),
            "quarantine_rejects": self.n_quarantine_rejects,
            "workers": self.max_workers,
            "backend": self.backend,
            "device": self.device,
        }
