"""Multi-worker serving router: fan requests over N scheduler workers.

Run as ``python -m repro_torch.serving.router --workers 2 --requests 16
--device cuda`` (``--device cpu`` on a machine without a card).  The router
spawns N :mod:`repro_torch.serving.worker` processes (each owning a
:class:`~repro_torch.serving.scheduler.ContinuousBatchingScheduler` over
its own KV arena), parses their ``READY host=... port=...`` lines, and
speaks the newline-JSON wire protocol of
:mod:`repro_torch.search.measure.rpc` to each over one persistent
connection.  The wire format is the JAX package's, so either router drives
either package's workers.

Routing is least-loaded: a ``submit`` goes to the live worker with the
fewest outstanding requests.  ``drain`` polls workers until every request
finishes; a worker that dies mid-run (connection drops, process exits —
also a worker whose scheduler tick raised, which exits on purpose) has its
unfinished requests resubmitted — from scratch — to the survivors, so the
router-level contract is at-least-once completion as long as one worker
survives.

Workers on one card share it as the measurement pool's workers do: each
process has its own CUDA context, and the card time-slices their kernels.
They serve rather than time, so they take no timing lock
(:func:`repro_torch.search.measure.local.timing_lock`): a serving worker's
throughput is what it gets beside its neighbours.  The parent builds the
kernels once before spawning, so no two workers run ``nvcc``.

Telemetry (``repro_torch.obs``): ``serve.router.submit`` / ``.complete`` /
``.resubmit`` / ``.worker_death`` counters and the matching trace events,
with ``serve.router.drain`` at the end of a drain, folded into the obs
report's ``serving_router`` section.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from ..obs import emit, metrics, trace_enabled
from ..search.measure.rpc import (
    PROTOCOL_VERSION,
    ProtocolError,
    recv_message,
    send_message,
    spawn_ready_workers,
)


@dataclass
class RouterRequest:
    """Router-side request record — enough to resubmit after a death."""

    grid: int  # router-global request id
    prompt: List[int]
    max_new: int
    temperature: Optional[float]
    worker: int = -1  # index into the router's worker list
    remote_rid: int = -1
    tokens: List[int] = field(default_factory=list)
    done: bool = False
    resubmits: int = 0
    ttft_s: Optional[float] = None
    latency_s: Optional[float] = None


class _WorkerLink:
    """One serving worker: process handle + persistent connection.  ``tail``
    holds the last lines of a spawned worker's output."""

    def __init__(
        self,
        index: int,
        host: str,
        port: int,
        proc: Optional[subprocess.Popen] = None,
        pid: int = -1,
        tail: Optional[deque] = None,
    ):
        self.index = index
        self.host = host
        self.port = port
        self.proc = proc
        self.pid = pid
        self.alive = True
        self.completed = 0
        self.tail: deque = deque() if tail is None else tail
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._rfile = None

    def connect(self, timeout_s: float = 10.0) -> None:
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=timeout_s
        )
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock.settimeout(timeout_s)
        self._rfile = self._sock.makefile("rb")

    def request(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """One request/response exchange.  Raises on a dead worker."""
        with self._lock:
            if self._sock is None:
                raise ProtocolError(f"worker {self.index} not connected")
            send_message(self._sock, msg)
            reply = recv_message(self._rfile)
        if reply is None:
            raise ProtocolError(f"worker {self.index} closed the connection")
        if reply.get("type") == "error":
            raise ProtocolError(
                f"worker {self.index}: {reply.get('error')}"
            )
        return reply

    def close(self) -> None:
        with self._lock:
            for h in (self._rfile, self._sock):
                if h is not None:
                    try:
                        h.close()
                    except OSError:
                        pass
            self._rfile = self._sock = None

    def kill(self) -> None:
        self.close()
        self.alive = False
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)


def spawn_serving_workers(
    n: int,
    model: str = "smollm-135m",
    max_slots: int = 4,
    max_seq: int = 64,
    page_size: int = 16,
    prefill_chunk: int = 8,
    paged: bool = True,
    db: Optional[str] = None,
    startup_timeout_s: float = 180.0,
    extra_args: Sequence[str] = (),
    device: str = "cuda",
) -> List[_WorkerLink]:
    """Spawn N ``python -m repro_torch.serving.worker`` processes on
    ``device`` and link to each, through
    :func:`repro_torch.search.measure.rpc.spawn_ready_workers`: the ``cuda``
    backend's kernels are built here first, every worker starts at once, and
    a worker that exits before READY raises ``RuntimeError`` with the tail
    of its output (and the others are stopped)."""
    from ..device import resolve_device

    args = [
        "--port", "0", "--model", model,
        "--max-slots", str(max_slots), "--max-seq", str(max_seq),
        "--page-size", str(page_size),
        "--prefill-chunk", str(prefill_chunk),
        "--device", str(device),
    ]
    if not paged:
        args.append("--no-paged")
    if db:
        args += ["--db", db]
    args += list(extra_args)
    handles = spawn_ready_workers(
        n, "repro_torch.serving.worker", args, "serving worker",
        backend="cuda", device=resolve_device(device),
        startup_timeout_s=startup_timeout_s,
    )
    return [
        _WorkerLink(i, h.host, h.port, proc=h.proc, pid=h.pid, tail=h.tail)
        for i, h in enumerate(handles)
    ]


class ServingRouter:
    """Least-loaded request router over serving workers with failover."""

    def __init__(self, workers: List[_WorkerLink], model: str = ""):
        if not workers:
            raise ValueError("router needs at least one worker")
        self.workers = workers
        self.model = model
        self.requests: List[RouterRequest] = []
        # per-worker map: remote rid -> router-global rid
        self._outstanding: List[Dict[int, int]] = [{} for _ in workers]
        self.stats: Dict[str, int] = {
            "submitted": 0, "completed": 0, "resubmits": 0,
            "worker_deaths": 0,
        }
        for w in workers:
            w.connect()
            w.request({"v": PROTOCOL_VERSION, "type": "ping"})

    @classmethod
    def spawn(cls, n: int, model: str = "smollm-135m", **kw) -> "ServingRouter":
        return cls(spawn_serving_workers(n, model=model, **kw), model=model)

    # -- routing ------------------------------------------------------------

    def _live(self) -> List[_WorkerLink]:
        live = [w for w in self.workers if w.alive]
        if not live:
            raise RuntimeError(
                "no serving workers left alive; "
                f"{sum(len(o) for o in self._outstanding)} requests stranded"
            )
        return live

    def _pick(self) -> _WorkerLink:
        """Least-loaded live worker (fewest outstanding requests)."""
        return min(
            self._live(), key=lambda w: len(self._outstanding[w.index])
        )

    def _on_death(self, w: _WorkerLink, reason: str) -> None:
        """Mark a worker dead and resubmit its unfinished requests.

        Safe to call on an already-dead link (e.g. killed externally):
        the death is only counted once, but stranded requests are always
        drained onto the survivors."""
        stranded = list(self._outstanding[w.index].values())
        self._outstanding[w.index].clear()
        if w.alive:
            w.alive = False
            w.close()
            self.stats["worker_deaths"] += 1
            metrics().inc("serve.router.worker_death", model=self.model)
            if trace_enabled():
                emit(
                    "serve.router.worker_death",
                    model=self.model,
                    worker=w.index,
                    pid=w.pid,
                    reason=reason,
                    stranded=len(stranded),
                )
        for grid in stranded:
            r = self.requests[grid]
            r.resubmits += 1
            self.stats["resubmits"] += 1
            metrics().inc("serve.router.resubmit", model=self.model)
            if trace_enabled():
                emit(
                    "serve.router.resubmit",
                    model=self.model,
                    rid=grid,
                    from_worker=w.index,
                )
            self._place(r)

    def _place(self, r: RouterRequest) -> None:
        """Send a request to some live worker, failing over on error."""
        while True:
            w = self._pick()
            try:
                reply = w.request({
                    "v": PROTOCOL_VERSION,
                    "type": "submit",
                    "prompt": r.prompt,
                    "max_new": r.max_new,
                    "temperature": r.temperature,
                })
                r.worker = w.index
                r.remote_rid = int(reply["rid"])
                self._outstanding[w.index][r.remote_rid] = r.grid
                return
            except (OSError, ProtocolError) as e:
                self._on_death(w, f"submit failed: {e}")

    # -- public API ---------------------------------------------------------

    def submit(
        self,
        prompt: Sequence[int],
        max_new: int = 16,
        temperature: Optional[float] = None,
    ) -> RouterRequest:
        r = RouterRequest(
            len(self.requests), [int(t) for t in prompt], int(max_new),
            temperature,
        )
        self.requests.append(r)
        self.stats["submitted"] += 1
        metrics().inc("serve.router.submit", model=self.model)
        if trace_enabled():
            emit(
                "serve.router.submit",
                model=self.model,
                rid=r.grid,
                prompt_len=len(r.prompt),
            )
        self._place(r)
        return r

    def poll(self) -> int:
        """One poll round over all live workers.  Returns how many
        requests finished this round; worker deaths trigger failover."""
        finished = 0
        for w in list(self.workers):
            out = self._outstanding[w.index]
            if not w.alive:
                if out:  # link torn down externally with requests in flight
                    self._on_death(w, "link closed with requests outstanding")
                continue
            if w.proc is not None and w.proc.poll() is not None:
                self._on_death(w, f"process exited rc={w.proc.poll()}")
                continue
            if not out:
                continue
            try:
                reply = w.request({
                    "v": PROTOCOL_VERSION,
                    "type": "poll",
                    "rids": list(out),
                })
            except (OSError, ProtocolError) as e:
                self._on_death(w, f"poll failed: {e}")
                continue
            for rid_s, st in reply.get("requests", {}).items():
                rid = int(rid_s)
                if rid not in out or not isinstance(st, dict):
                    continue
                if st.get("error"):
                    continue
                grid = out[rid]
                r = self.requests[grid]
                r.tokens = list(st.get("tokens") or [])
                if st.get("done"):
                    r.done = True
                    r.ttft_s = st.get("ttft_s")
                    r.latency_s = st.get("latency_s")
                    del out[rid]
                    w.completed += 1
                    finished += 1
                    self.stats["completed"] += 1
                    metrics().inc(
                        "serve.router.complete", model=self.model
                    )
                    if trace_enabled():
                        emit(
                            "serve.router.complete",
                            model=self.model,
                            rid=grid,
                            worker=w.index,
                            tokens=len(r.tokens),
                            resubmits=r.resubmits,
                        )
        return finished

    def outstanding(self) -> int:
        return sum(len(o) for o in self._outstanding)

    def drain(
        self, poll_interval_s: float = 0.02, timeout_s: float = 600.0
    ) -> List[RouterRequest]:
        """Poll until every submitted request completes (or timeout)."""
        deadline = time.monotonic() + timeout_s
        while self.outstanding():
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"router drain timed out with {self.outstanding()} "
                    "requests outstanding"
                )
            if self.poll() == 0:
                time.sleep(poll_interval_s)
        if trace_enabled():
            emit(
                "serve.router.drain",
                model=self.model,
                completed=self.stats["completed"],
                resubmits=self.stats["resubmits"],
                worker_deaths=self.stats["worker_deaths"],
            )
        return self.requests

    def worker_stats(self) -> List[Optional[Dict[str, Any]]]:
        """Per-worker scheduler stats (None for dead workers)."""
        out: List[Optional[Dict[str, Any]]] = []
        for w in self.workers:
            if not w.alive:
                out.append(None)
                continue
            try:
                out.append(
                    w.request(
                        {"v": PROTOCOL_VERSION, "type": "stats"}
                    ).get("stats")
                )
            except (OSError, ProtocolError) as e:
                self._on_death(w, f"stats failed: {e}")
                out.append(None)
        return out

    def summary(self) -> Dict[str, Any]:
        """Router counters + per-worker completion/throughput rollup."""
        per_worker = []
        for w, st in zip(self.workers, self.worker_stats()):
            per_worker.append({
                "worker": w.index,
                "pid": w.pid,
                "alive": w.alive,
                "completed": w.completed,
                "scheduler": st,
            })
        return {"router": dict(self.stats), "workers": per_worker}

    def shutdown(self) -> None:
        for w in self.workers:
            if w.alive:
                try:
                    w.request({"v": PROTOCOL_VERSION, "type": "shutdown"})
                except (OSError, ProtocolError):
                    pass
            w.kill()


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: spawn workers, push synthetic load, print a JSON summary."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--model", default="smollm-135m")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--no-paged", action="store_true")
    ap.add_argument("--db", default=None)
    ap.add_argument(
        "--device", default="cuda", help="device the workers serve on (cuda | cpu)"
    )
    ap.add_argument("--json", default=None, help="write the summary here")
    args = ap.parse_args(argv)
    router = ServingRouter.spawn(
        args.workers, model=args.model,
        max_slots=args.max_slots, max_seq=args.max_seq,
        page_size=args.page_size, prefill_chunk=args.prefill_chunk,
        paged=not args.no_paged, db=args.db, device=args.device,
    )
    try:
        t0 = time.perf_counter()
        for i in range(args.requests):
            plen = 1 + (i * 7) % args.prompt_len
            router.submit(
                [(i * 13 + j) % 50 + 1 for j in range(plen)],
                max_new=args.max_new,
            )
        router.drain()
        elapsed = time.perf_counter() - t0
        out = router.summary()
        out["elapsed_s"] = round(elapsed, 4)
        out["total_tokens"] = sum(len(r.tokens) for r in router.requests)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(out, f, indent=2, sort_keys=True)
        print(json.dumps(out, indent=2, sort_keys=True))
    finally:
        router.shutdown()


if __name__ == "__main__":
    main()
