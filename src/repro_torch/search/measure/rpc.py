"""RPC measurement fleet: a JSON-over-socket protocol and a fan-out runner.

MetaSchedule and Ansor both make large search spaces tractable by farming
candidate measurement out to a fleet of workers; this module is that
architecture for our stack.  Three pieces:

* a **versioned wire protocol** (newline-delimited JSON over TCP) that
  ships :class:`MeasureInput` / :class:`MeasureResult` across process and
  host boundaries.  Traces travel as ``Trace.to_json()`` strings and the
  ``PrimFunc`` travels as its workload key (the worker rebuilds it with
  :func:`repro_torch.core.workloads.get_workload`); result ``meta`` —
  lowering provenance — is preserved end to end;
* :class:`RPCRunner` — shards a measure batch across a pool of workers
  (``"rpc://host:port,host:port"`` in the runner-spec grammar), retries
  candidates whose worker died mid-batch on the survivors, attributes
  repeat crashers via the same structural-hash quarantine as
  :class:`~repro_torch.search.measure.pool.ProcessPoolRunner`, raises
  :class:`~repro_torch.search.measure.local.MeasurementFault` when a live
  worker reports an error that is not a rejection (an ``error`` reply
  marked ``"fault": true``), and emits per-worker ``measure.rpc.*``
  telemetry that :mod:`repro_torch.obs.report` folds into a fleet section;
* :func:`spawn_local_workers` — a convenience used by the smoke run and
  tests to launch ``python -m repro_torch.search.measure.worker``
  subprocesses on ephemeral ports, over :func:`spawn_ready_workers`, which
  the serving router uses too.

The worker-side loop lives in :mod:`repro_torch.search.measure.worker`.
"""

from __future__ import annotations

import json
import math
import os
import socket
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

from ...obs import emit, metrics, trace_enabled
from ..database import parse_workload_key
from .hashing import structural_hash
from .local import MeasurementFault
from .protocol import BuildResult, MeasureInput, MeasureResult, Runner

PROTOCOL_VERSION = 1

# generous ceiling: a single measure request is a batch of traces (KBs
# each); anything beyond this is a framing bug, not a real payload
MAX_MESSAGE_BYTES = 64 * 1024 * 1024


class ProtocolError(RuntimeError):
    """Malformed or version-incompatible message on the wire."""


# ---------------------------------------------------------------------------
# codecs: dataclasses <-> plain JSON-able dicts
# ---------------------------------------------------------------------------


def encode_measure_input(mi: MeasureInput) -> Dict[str, Any]:
    """Wire form of a candidate: workload key + trace JSON.

    The schedule (not guaranteed picklable, never JSON-able) and the func
    (rebuilt from the key on the far side) deliberately do not travel."""
    return {"workload_key": mi.workload_key, "trace": mi.trace.to_json()}


def decode_measure_input(d: Dict[str, Any]) -> MeasureInput:
    """Rebuild a :class:`MeasureInput` from its wire form.

    The PrimFunc is reconstructed from the workload key via the workload
    registry — the same canonical keys the tuning database uses."""
    from ...core.trace import Trace
    from ...core.workloads import get_workload

    key = d["workload_key"]
    name, kwargs = parse_workload_key(key)
    func = get_workload(name, **kwargs)
    return MeasureInput(
        workload_key=key, func=func, trace=Trace.from_json(d["trace"])
    )


def _encode_latency(latency_s: float) -> Optional[float]:
    # JSON has no inf/nan; a rejected measurement travels as null
    return float(latency_s) if math.isfinite(latency_s) else None


def _decode_latency(latency_s: Optional[float]) -> float:
    return float("inf") if latency_s is None else float(latency_s)


def encode_measure_result(r: MeasureResult) -> Dict[str, Any]:
    return {
        "latency_s": _encode_latency(r.latency_s),
        "error": r.error,
        "build_time_s": r.build_time_s,
        "run_time_s": r.run_time_s,
        "source": r.source,
        "meta": r.meta,
    }


def decode_measure_result(d: Dict[str, Any]) -> MeasureResult:
    return MeasureResult(
        latency_s=_decode_latency(d.get("latency_s")),
        error=d.get("error", ""),
        build_time_s=float(d.get("build_time_s", 0.0)),
        run_time_s=float(d.get("run_time_s", 0.0)),
        source=d.get("source", "measured"),
        meta=dict(d.get("meta") or {}),
    )


def encode_build_result(r: BuildResult) -> Dict[str, Any]:
    """Wire form of a build outcome.  The compiled artifact cannot cross
    a socket; only its presence travels (``built``) plus provenance."""
    return {
        "built": r.artifact is not None,
        "error": r.error,
        "build_time_s": r.build_time_s,
        "meta": r.meta,
    }


def decode_build_result(d: Dict[str, Any]) -> BuildResult:
    return BuildResult(
        artifact=None,
        error=d.get("error", ""),
        build_time_s=float(d.get("build_time_s", 0.0)),
        meta=dict(d.get("meta") or {}),
    )


def check_version(msg: Dict[str, Any]) -> None:
    """Reject messages from a different protocol generation."""
    v = msg.get("v")
    if v != PROTOCOL_VERSION:
        raise ProtocolError(
            f"protocol version mismatch: got {v!r}, expected {PROTOCOL_VERSION}"
        )


def measure_request(
    inputs: List[MeasureInput], opts: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """A ``measure`` request: batch of encoded candidates + runner opts."""
    return {
        "v": PROTOCOL_VERSION,
        "type": "measure",
        "opts": dict(opts or {}),
        "inputs": [encode_measure_input(mi) for mi in inputs],
    }


def results_response(results: List[MeasureResult]) -> Dict[str, Any]:
    return {
        "v": PROTOCOL_VERSION,
        "type": "results",
        "results": [encode_measure_result(r) for r in results],
    }


def error_response(message: str, fault: bool = False) -> Dict[str, Any]:
    """An ``error`` reply.  ``fault`` marks an exception raised while a live
    worker measured (not a malformed request): the client raises it as a
    :class:`MeasurementFault` instead of treating the worker as dead."""
    msg = {"v": PROTOCOL_VERSION, "type": "error", "error": message}
    if fault:
        msg["fault"] = True
    return msg


# ---------------------------------------------------------------------------
# framing: one JSON object per line
# ---------------------------------------------------------------------------


def send_message(sock: socket.socket, obj: Dict[str, Any]) -> None:
    """Send one newline-framed JSON message."""
    sock.sendall(json.dumps(obj).encode("utf-8") + b"\n")


def recv_message(rfile) -> Optional[Dict[str, Any]]:
    """Read one message from a socket makefile; ``None`` on clean EOF."""
    line = rfile.readline(MAX_MESSAGE_BYTES)
    if not line:
        return None
    if len(line) >= MAX_MESSAGE_BYTES:
        raise ProtocolError(f"message exceeds {MAX_MESSAGE_BYTES} bytes")
    try:
        msg = json.loads(line)
    except json.JSONDecodeError as e:
        raise ProtocolError(f"undecodable message: {e}") from e
    if not isinstance(msg, dict):
        raise ProtocolError(f"expected a JSON object, got {type(msg).__name__}")
    return msg


def parse_addresses(address: str) -> List[Tuple[str, int]]:
    """``"host:port,host:port"`` -> [(host, port), ...].  A bare ``:port``
    or plain port number means localhost."""
    out: List[Tuple[str, int]] = []
    for part in address.split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port_s = part.rpartition(":")
        if not sep:
            host, port_s = "", part
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"malformed rpc address {part!r}: expected host:port"
            ) from None
        out.append((host or "127.0.0.1", port))
    return out


# ---------------------------------------------------------------------------
# the fan-out runner
# ---------------------------------------------------------------------------


@dataclass
class _WorkerConn:
    """Parent-side state for one fleet worker."""

    host: str
    port: int
    sock: Optional[socket.socket] = None
    rfile: Any = None
    batches: int = 0
    candidates: int = 0
    deaths: int = 0
    dispatch_s: float = 0.0
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def connect(self, timeout_s: float) -> None:
        if self.sock is not None:
            return
        sock = socket.create_connection((self.host, self.port), timeout=timeout_s)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sock = sock
        self.rfile = sock.makefile("rb")

    def close(self) -> None:
        for closer in (self.rfile, self.sock):
            try:
                if closer is not None:
                    closer.close()
            except OSError:
                pass
        self.sock = None
        self.rfile = None

    def request(self, msg: Dict[str, Any], timeout_s: float) -> Dict[str, Any]:
        """One request/response exchange.  Raises ``OSError`` (incl.
        timeout) or :class:`ProtocolError` when the worker is unusable."""
        with self.lock:
            self.connect(timeout_s)
            self.sock.settimeout(timeout_s)
            send_message(self.sock, msg)
            resp = recv_message(self.rfile)
        if resp is None:
            raise ProtocolError("worker closed connection mid-request")
        check_version(resp)
        return resp


class RPCRunner(Runner):
    """Shards measure batches across a fleet of RPC workers.

    Candidates are split contiguously across the live workers and
    measured in parallel (one request thread per worker).  A worker that
    dies mid-batch (socket error, EOF, budget timeout) is marked dead for
    the round and its candidates are retried one at a time on the
    survivors; a candidate whose *isolated* retry also kills a worker is
    counted as a crasher and quarantined by structural trace hash after
    ``crash_threshold`` occurrences — the same attribution semantics as
    :class:`~repro_torch.search.measure.pool.ProcessPoolRunner`.  Dead
    workers get a reconnect attempt at the start of every batch, so a
    restarted worker process rejoins the fleet automatically.  An error
    reply marked as a fault raises :class:`MeasurementFault` in the caller.
    """

    name = "rpc"

    def __init__(
        self,
        address: str = "",
        timeout_s: float = 30.0,
        repeats: int = 3,
        warmup: int = 1,
        crash_threshold: int = 2,
        grace_s: float = 10.0,
        startup_grace_s: float = 60.0,
        connect_timeout_s: float = 60.0,
        backend: Optional[str] = None,
        device: str = "cuda",
        check: bool = True,
    ):
        from ...backends.registry import DEFAULT_BACKEND, get_backend

        addrs = parse_addresses(address)
        if not addrs:
            raise ValueError(
                "RPCRunner needs at least one worker address, e.g. "
                '"rpc://127.0.0.1:7070,127.0.0.1:7071"'
            )
        self.backend = backend or DEFAULT_BACKEND
        get_backend(self.backend)  # fail fast on a typo'd spec
        # the workers measure on their own device (``--device``); this is
        # the device they must report at the handshake
        self.device = str(device)
        # workers on one card take turns at timing (timing_lock): a shard
        # may wait for every other shard's candidates, so on a card each
        # shard's budget covers the whole batch
        self.serial_timing = self.device.startswith("cuda")
        self.timeout_s = timeout_s
        self.repeats = repeats
        self.warmup = warmup
        self.crash_threshold = crash_threshold
        self.grace_s = grace_s
        self.startup_grace_s = startup_grace_s
        self.connect_timeout_s = connect_timeout_s
        self.workers = [_WorkerConn(h, p) for h, p in addrs]
        self.crash_counts: Dict[str, int] = {}
        self.quarantined: set = set()
        self.n_measured = 0
        self.n_failed = 0
        self.n_timeouts = 0
        self.n_crashes = 0
        self.n_worker_deaths = 0
        self.n_retries = 0
        self.n_quarantine_rejects = 0
        if check:
            self._handshake()

    # -- fleet lifecycle ----------------------------------------------------

    def _handshake(self) -> None:
        """Ping every worker (waiting out its torch-import startup) and
        verify protocol version, lowering backend and device.  A fleet
        member built against a different backend or measuring on another
        device would silently poison the tuning db, so a mismatch raises
        here instead of failing per candidate."""
        deadline = time.monotonic() + self.connect_timeout_s
        for w in self.workers:
            last_err: Optional[Exception] = None
            while time.monotonic() < deadline:
                try:
                    pong = w.request(
                        {"v": PROTOCOL_VERSION, "type": "ping"}, timeout_s=5.0
                    )
                    if pong.get("type") == "error":
                        raise ProtocolError(pong.get("error", "worker error"))
                    wb = pong.get("backend")
                    if wb is not None and wb != self.backend:
                        raise RuntimeError(
                            f"rpc worker {w.addr} runs backend {wb!r} but this "
                            f"runner was created for {self.backend!r}"
                        )
                    wd = pong.get("device")
                    if wd is not None and wd != self.device:
                        raise RuntimeError(
                            f"rpc worker {w.addr} measures on device {wd!r} "
                            f"but this runner was created for {self.device!r}"
                        )
                    last_err = None
                    break
                except (ProtocolError, RuntimeError):
                    w.close()
                    raise
                except OSError as e:
                    last_err = e
                    w.close()
                    time.sleep(0.2)
            if last_err is not None:
                raise ConnectionError(
                    f"cannot reach rpc worker {w.addr} within "
                    f"{self.connect_timeout_s:.0f}s: {last_err}"
                )

    def _live_workers(self) -> List[_WorkerConn]:
        """Workers with a usable connection; dead ones get one reconnect
        attempt (a restarted worker process rejoins here)."""
        live = []
        for w in self.workers:
            if w.sock is None:
                try:
                    w.connect(timeout_s=2.0)
                except OSError:
                    continue
            live.append(w)
        return live

    def close(self) -> None:
        for w in self.workers:
            w.close()

    def shutdown_workers(self) -> None:
        """Ask every reachable worker process to exit (used by tests and
        benchmarks that own the worker lifecycle)."""
        for w in self.workers:
            try:
                w.request(
                    {"v": PROTOCOL_VERSION, "type": "shutdown"}, timeout_s=5.0
                )
            except (OSError, ProtocolError):
                pass
            w.close()

    # -- measurement --------------------------------------------------------

    def _opts(self) -> Dict[str, Any]:
        return {
            "repeats": self.repeats,
            "warmup": self.warmup,
            "timeout_s": self.timeout_s,
            "backend": self.backend,
        }

    def _budget(self, n: int, w: _WorkerConn, batch: int) -> float:
        """Seconds to wait for ``n`` candidates on ``w`` while ``batch``
        candidates are out across the fleet."""
        if self.serial_timing:
            n = batch
        budget = self.timeout_s * n + self.grace_s
        if w.batches == 0:
            budget += self.startup_grace_s
        return budget

    def run(self, inputs: List[MeasureInput]) -> List[MeasureResult]:
        results: List[Optional[MeasureResult]] = [None] * len(inputs)
        live: List[Tuple[int, str, MeasureInput]] = []
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
                live.append((i, h, mi))
        if live:
            self._run_live(live, results)
        return results  # type: ignore[return-value]

    def _run_live(
        self,
        live: List[Tuple[int, str, MeasureInput]],
        results: List[Optional[MeasureResult]],
    ) -> None:
        workers = self._live_workers()
        if not workers:
            for i, h, mi in live:
                results[i] = self._no_workers_result(mi)
            return
        # contiguous shards, one per worker, sized as evenly as possible
        shards: List[List[Tuple[int, str, MeasureInput]]] = []
        n_shards = min(len(workers), len(live))
        base, extra = divmod(len(live), n_shards)
        pos = 0
        for s in range(n_shards):
            size = base + (1 if s < extra else 0)
            shards.append(live[pos : pos + size])
            pos += size
        failed: List[Tuple[int, str, MeasureInput]] = []
        faults: List[MeasurementFault] = []
        failed_lock = threading.Lock()

        def _dispatch(w: _WorkerConn, shard) -> None:
            try:
                batch = self._measure_batch(w, shard, len(live))
            except (OSError, ProtocolError) as e:
                self._mark_death(w, "batch", e)
                with failed_lock:
                    failed.extend(shard)
                return
            except MeasurementFault as e:  # re-raised on the caller's thread
                with failed_lock:
                    faults.append(e)
                return
            for (i, h, mi), res in zip(shard, batch):
                results[i] = res
                self._emit_result(h, mi.workload_key, res)

        threads = [
            threading.Thread(target=_dispatch, args=(w, shard), daemon=True)
            for w, shard in zip(workers, shards)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if faults:
            raise faults[0]
        failed.sort(key=lambda t: t[0])
        for item in failed:
            i, h, mi = item
            self.n_retries += 1
            metrics().inc("measure.rpc.retries", backend=self.backend)
            if trace_enabled():
                emit(
                    "measure.rpc.retry",
                    key=mi.workload_key,
                    hash=h,
                    backend=self.backend,
                )
            results[i] = self._run_isolated(item)

    def _measure_batch(
        self,
        w: _WorkerConn,
        shard: List[Tuple[int, str, MeasureInput]],
        batch: Optional[int] = None,
    ) -> List[MeasureResult]:
        """One request against one worker (``batch``: the candidates out
        across the fleet meanwhile, default the shard); raises on worker
        death."""
        req = measure_request([mi for _, _, mi in shard], self._opts())
        t0 = time.perf_counter()
        try:
            resp = w.request(
                req, timeout_s=self._budget(len(shard), w, batch or len(shard))
            )
        except (OSError, ProtocolError):
            self._emit_dispatch(w, len(shard), time.perf_counter() - t0, ok=False)
            raise
        dur = time.perf_counter() - t0
        if resp.get("type") == "error":
            self._emit_dispatch(w, len(shard), dur, ok=False)
            if resp.get("fault"):
                raise MeasurementFault(
                    f"rpc worker {w.addr}: {resp.get('error', 'worker error')}"
                )
            raise ProtocolError(resp.get("error", "worker error"))
        batch = [decode_measure_result(d) for d in resp.get("results", [])]
        if len(batch) != len(shard):
            self._emit_dispatch(w, len(shard), dur, ok=False)
            raise ProtocolError(
                f"worker {w.addr} returned {len(batch)} results "
                f"for {len(shard)} inputs"
            )
        w.batches += 1
        w.candidates += len(shard)
        w.dispatch_s += dur
        metrics().inc("measure.rpc.batches", backend=self.backend)
        self._emit_dispatch(w, len(shard), dur, ok=True)
        return batch

    def _run_isolated(
        self, item: Tuple[int, str, MeasureInput]
    ) -> MeasureResult:
        """Retry one candidate from a dead worker's batch alone on a
        surviving worker; a death here is attributable to the candidate."""
        i, h, mi = item
        workers = self._live_workers()
        if not workers:
            return self._no_workers_result(mi)
        w = min(workers, key=lambda w: w.candidates)  # least-loaded survivor
        try:
            res = self._measure_batch(w, [item])[0]
        except (OSError, ProtocolError) as e:
            self._mark_death(w, "isolated", e)
            return self._attribute_crash(h, mi, e)
        self._emit_result(h, mi.workload_key, res)
        return res

    def _attribute_crash(
        self, h: str, mi: MeasureInput, exc: Exception
    ) -> MeasureResult:
        if isinstance(exc, socket.timeout):
            # a hang is a timeout, not a crash — same split as the pool
            self.n_timeouts += 1
            metrics().inc("measure.timeouts", backend=self.backend)
            if trace_enabled():
                emit(
                    "measure.timeout",
                    key=mi.workload_key,
                    hash=h,
                    timeout_s=self.timeout_s,
                    note="rpc isolated retry",
                    backend=self.backend,
                )
            return MeasureResult(
                float("inf"),
                f"timeout (exceeded {self.timeout_s:.1f}s, rpc isolated retry)",
                source="timeout",
            )
        self.n_crashes += 1
        n = self.crash_counts.get(h, 0) + 1
        self.crash_counts[h] = n
        metrics().inc("measure.crashes", backend=self.backend)
        if trace_enabled():
            emit(
                "measure.crash",
                key=mi.workload_key,
                hash=h,
                crash=n,
                threshold=self.crash_threshold,
                error=type(exc).__name__,
                backend=self.backend,
            )
        msg = (
            f"rpc worker died ({type(exc).__name__}), "
            f"crash {n}/{self.crash_threshold}"
        )
        if n >= self.crash_threshold:
            self.quarantined.add(h)
            metrics().inc("measure.quarantined", backend=self.backend)
            if trace_enabled():
                emit(
                    "measure.crash_quarantine",
                    key=mi.workload_key,
                    hash=h,
                    crashes=n,
                    backend=self.backend,
                )
            msg += "; trace quarantined"
        return MeasureResult(float("inf"), msg)

    def _no_workers_result(self, mi: MeasureInput) -> MeasureResult:
        self.n_failed += 1
        metrics().inc("measure.failed", backend=self.backend)
        return MeasureResult(float("inf"), "no live rpc workers")

    # -- telemetry ----------------------------------------------------------

    def _mark_death(self, w: _WorkerConn, stage: str, exc: Exception) -> None:
        w.close()
        w.deaths += 1
        self.n_worker_deaths += 1
        metrics().inc("measure.rpc.worker_deaths", backend=self.backend)
        if trace_enabled():
            emit(
                "measure.rpc.worker_death",
                worker=w.addr,
                stage=stage,
                error=type(exc).__name__,
                backend=self.backend,
            )

    def _emit_dispatch(
        self, w: _WorkerConn, n: int, dur_s: float, ok: bool
    ) -> None:
        metrics().observe("measure.rpc.dispatch_s", dur_s, backend=self.backend)
        if trace_enabled():
            emit(
                "measure.rpc.dispatch",
                worker=w.addr,
                n=n,
                dur_s=dur_s,
                ok=ok,
                backend=self.backend,
            )

    def _emit_result(self, h: str, key: str, res: MeasureResult) -> None:
        """Parent-side measure.build / measure.run telemetry for one
        remotely measured candidate (mirrors the pool's shape so the obs
        report needs no special casing)."""
        ok = res.ok
        run_wall = float(res.meta.get("run_wall_s", res.run_time_s))
        self.n_measured += 1
        metrics().inc("measure.measured", backend=self.backend)
        if not ok:
            self.n_failed += 1
            metrics().inc("measure.failed", backend=self.backend)
        metrics().observe("measure.build_s", res.build_time_s, backend=self.backend)
        metrics().observe("measure.run_s", run_wall, backend=self.backend)
        if trace_enabled():
            emit(
                "measure.build",
                key=key,
                hash=h,
                ok=ok,
                dur_s=res.build_time_s,
                backend=self.backend,
            )
            emit(
                "measure.run",
                key=key,
                hash=h,
                ok=ok,
                latency_s=res.latency_s if ok else None,
                dur_s=run_wall,
                backend=self.backend,
                **({"error": res.error} if res.error else {}),
            )

    def stats(self) -> Dict[str, Any]:
        return {
            "measured": self.n_measured,
            "failed": self.n_failed,
            "timeouts": self.n_timeouts,
            "crashes": self.n_crashes,
            "worker_deaths": self.n_worker_deaths,
            "retries": self.n_retries,
            "quarantined_traces": len(self.quarantined),
            "quarantine_rejects": self.n_quarantine_rejects,
            "workers": len(self.workers),
            "backend": self.backend,
            "per_worker": {
                w.addr: {
                    "batches": w.batches,
                    "candidates": w.candidates,
                    "deaths": w.deaths,
                    "dispatch_s": round(w.dispatch_s, 6),
                }
                for w in self.workers
            },
        }


# ---------------------------------------------------------------------------
# worker-process spawning (benchmarks / CI / tests)
# ---------------------------------------------------------------------------


# lines of a spawned worker's output kept for the error that reports its exit
TAIL_LINES = 20


@dataclass
class WorkerHandle:
    """A locally spawned worker subprocess, where it listens, its pid, and
    the last lines of its output (kept by a thread that drains the pipe)."""

    proc: subprocess.Popen
    host: str
    port: int
    pid: int = -1
    tail: Deque[str] = field(default_factory=lambda: deque(maxlen=TAIL_LINES))

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def parse_ready(line: str) -> Optional[Dict[str, str]]:
    """The ``key=value`` fields of a worker's ``READY host=... port=...
    pid=...`` line, or None for any other line."""
    if not line.startswith("READY "):
        return None
    return dict(kv.split("=", 1) for kv in line.split()[1:] if "=" in kv)


def _drain(h: WorkerHandle) -> None:
    # past READY nobody reads stdout: drain it so a chatty worker never
    # blocks on a full pipe, keeping the last lines
    for line in h.proc.stdout:
        h.tail.append(line.rstrip())


def spawn_ready_workers(
    n: int,
    module: str,
    args: List[str],
    what: str,
    backend: Optional[str] = None,
    device: str = "cuda",
    startup_timeout_s: float = 180.0,
) -> List[WorkerHandle]:
    """Launch ``n`` ``python -m <module> <args>`` worker processes and wait
    for each one's ``READY`` line.

    The backend's kernels are built here first (``prepare(device)``), so
    the workers load them instead of running ``nvcc`` side by side; then
    every worker starts at once.  The children's ``PYTHONPATH`` starts with
    the directory that holds this package, so they import the same
    ``repro_torch`` as the caller however the caller found it.  A worker
    that exits (or stays silent) before ``READY`` raises ``RuntimeError``
    naming ``what`` with the tail of its output, and every worker is
    stopped.  Caller owns the processes."""
    from ...backends.registry import get_backend

    get_backend(backend).prepare(device)
    src = str(Path(__file__).resolve().parents[3])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p
    )
    cmd = [sys.executable, "-m", module, *args]
    procs = [
        subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for _ in range(n)
    ]
    handles: List[WorkerHandle] = []
    try:
        for i, proc in enumerate(procs):
            deadline = time.monotonic() + startup_timeout_s
            h = WorkerHandle(proc=proc, host="", port=-1)
            fields = None
            while fields is None and time.monotonic() < deadline:
                line = proc.stdout.readline()
                if not line:
                    break
                h.tail.append(line.rstrip())
                fields = parse_ready(line)
            if fields is None:
                if proc.poll() is None and time.monotonic() >= deadline:
                    why = f"did not print READY within {startup_timeout_s:.0f}s"
                else:  # its output ended: it is exiting
                    why = f"exited before READY (rc={proc.wait()})"
                tail = "\n".join(h.tail)
                raise RuntimeError(f"{what} {i} {why}; output:\n{tail}")
            h.host = fields.get("host", "127.0.0.1")
            h.port = int(fields["port"])
            h.pid = int(fields.get("pid", proc.pid))
            threading.Thread(target=_drain, args=(h,), daemon=True).start()
            handles.append(h)
    except BaseException:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        raise
    return handles


def spawn_local_workers(
    n: int,
    backend: Optional[str] = None,
    runner: str = "local",
    timeout_s: Optional[float] = None,
    startup_timeout_s: float = 180.0,
    extra_args: Optional[List[str]] = None,
    device: str = "cuda",
) -> List[WorkerHandle]:
    """Launch ``n`` measurement workers on ephemeral localhost ports
    (:func:`spawn_ready_workers`).

    Each prints its ``READY`` line after importing torch and building its
    inner runner, so an ``RPCRunner`` created against the returned
    addresses connects immediately.  Caller owns the processes —
    ``handle.kill()`` or ``RPCRunner.shutdown_workers()`` to stop them."""
    args = ["--port", "0", "--device", device]
    if backend:
        args += ["--backend", backend]
    if runner:
        args += ["--runner", runner]
    if timeout_s is not None:
        args += ["--timeout-s", str(timeout_s)]
    args += list(extra_args or [])
    return spawn_ready_workers(
        n, "repro_torch.search.measure.worker", args, "measurement worker",
        backend=backend, device=device, startup_timeout_s=startup_timeout_s,
    )
