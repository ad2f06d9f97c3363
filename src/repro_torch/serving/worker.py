"""Serving worker process: one scheduler behind a TCP front door.

Run as ``python -m repro_torch.serving.worker --model smollm-135m --port 0
--device cuda`` (``--device``, default ``cuda``, raises before ``READY``
where there is no card; ``--device cpu`` serves on the CPU).  The worker
builds a model (random-init weights at a fixed seed, like the benchmarks),
wraps it in a
:class:`~repro_torch.serving.scheduler.ContinuousBatchingScheduler`
configured by one :class:`~repro_torch.serving.config.ServeConfig` from the
CLI's knobs, optionally loads a shared tuning database for tuned-kernel
dispatch (``--db``), prints a ``READY host=... port=... pid=...`` line, and
then serves newline-framed JSON requests — the same wire conventions as
the measurement fleet (:mod:`repro_torch.search.measure.rpc`), byte for
byte the JAX package's worker protocol:

    ping      -> pong (protocol version, model, slots, pid)
    submit    -> enqueue a prompt; replies with the worker-local rid
    poll      -> per-rid {tokens, done} status for a list of rids
    stats     -> scheduler stats + throughput counters, and ``launches``:
                 the kernel wrappers' launch counters of this process
                 (:func:`repro_torch.kernels.launch_counts`)
    shutdown  -> replies ``bye`` and exits

A background pump thread ticks the scheduler whenever work is pending, so
decoding makes progress between (and during) router round-trips; the
request handler and the pump share one lock around scheduler state.  The
scheduler enters its dispatch context and ``torch.no_grad()`` inside every
tick, so the pump thread sees both (each is thread-local).  A tick that
raises stops the pump: the worker prints the traceback, answers the next
request with an ``error`` reply (``pump failed: ...``) and stops serving,
and ``main`` exits with :data:`PUMP_FAILED_RC`; so the router counts a
death and resubmits instead of polling requests that will never finish.
One connection is served at a time; when a client disconnects the worker
goes back to ``accept`` so a restarted router can reconnect.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .. import kernels
from ..search.measure.rpc import (
    PROTOCOL_VERSION,
    ProtocolError,
    check_version,
    error_response,
    recv_message,
    send_message,
)

# the exit code of a worker whose pump thread raised
PUMP_FAILED_RC = 3
# how often an idle ``accept`` looks whether the pump has failed
ACCEPT_POLL_S = 0.5


class SchedulerHost:
    """Owns the scheduler + lock + pump thread behind the socket loop."""

    def __init__(self, scheduler):
        self.scheduler = scheduler
        self.lock = threading.Lock()
        # request handlers waiting for or holding the lock; one connection
        # is served at a time, so its handler thread is the only writer
        self._waiting = 0
        self._stop = threading.Event()
        # the exception that stopped the pump, once a tick raised
        self.error: Optional[Exception] = None
        self._pump = threading.Thread(target=self._pump_loop, daemon=True)
        self._pump.start()

    def _pump_loop(self) -> None:
        try:
            while not self._stop.is_set():
                with self.lock:
                    worked = (
                        self.scheduler.step()
                        if self.scheduler.pending()
                        else False
                    )
                if not worked or self._waiting:
                    # a lock is not fair: the pump would take it again the
                    # moment a tick ends, ahead of a waiting request
                    time.sleep(0.002)
        except Exception as e:
            # a failed tick (a kernel or CUDA error) leaves requests that
            # will never finish: refuse further work, so the router sees a
            # death
            traceback.print_exc()
            print("serving worker: the scheduler's pump failed",
                  file=sys.stderr, flush=True)
            self.error = e

    def failure(self) -> Optional[str]:
        """The error reply's text once the pump has failed, else None."""
        e = self.error
        return None if e is None else f"pump failed: {type(e).__name__}: {e}"

    @contextmanager
    def _locked(self):
        """The lock, for a request handler: the pump steps aside after its
        tick while one waits."""
        self._waiting += 1
        try:
            with self.lock:
                yield
        finally:
            self._waiting -= 1

    def submit(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        prompt = np.asarray(msg.get("prompt") or [], np.int32)
        with self._locked():
            r = self.scheduler.submit(
                prompt,
                max_new_tokens=int(msg.get("max_new", 16)),
                temperature=msg.get("temperature"),
            )
        return {"v": PROTOCOL_VERSION, "type": "accepted", "rid": r.rid}

    def poll(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        rids = msg.get("rids") or []
        out: Dict[str, Any] = {}
        with self._locked():
            reqs = self.scheduler._requests
            for rid in rids:
                if not 0 <= int(rid) < len(reqs):
                    out[str(rid)] = {"error": "unknown rid"}
                    continue
                r = reqs[int(rid)]
                out[str(rid)] = {
                    "done": bool(r.done),
                    "tokens": [int(t) for t in r.generated],
                    "ttft_s": r.ttft_s,
                    "latency_s": r.latency_s,
                }
        return {"v": PROTOCOL_VERSION, "type": "status", "requests": out}

    def stats(self) -> Dict[str, Any]:
        with self._locked():
            s = dict(self.scheduler.stats)
            s["decode_tok_s"] = self.scheduler.decode_tok_s
            s["prefill_tok_s"] = self.scheduler.prefill_tok_s
            s["queue_depth"] = len(self.scheduler.queue)
            s["active"] = len(self.scheduler.active)
            s["prefilling"] = len(self.scheduler.prefilling)
            s["launches"] = kernels.launch_counts()
        return {"v": PROTOCOL_VERSION, "type": "stats", "stats": s, "pid": os.getpid()}

    def close(self) -> None:
        self._stop.set()
        self._pump.join(timeout=2.0)


def build_scheduler(
    model: str,
    max_slots: int = 4,
    max_seq: int = 64,
    page_size: int = 16,
    prefill_chunk: int = 8,
    paged: Optional[bool] = None,
    db: Optional[str] = None,
    seed: int = 0,
    smoke: bool = True,
    device: str = "cuda",
):
    """Random-init a model on ``device`` and wrap it in a configured
    scheduler; ``db`` (a database file) dispatches its keys to the ``cuda``
    backend's kernels."""
    from ..configs.base import get_config
    from ..device import resolve_device
    from ..models.registry import build_model
    from .config import ServeConfig
    from .scheduler import ContinuousBatchingScheduler

    dev = resolve_device(device)
    cfg = get_config(model, smoke=smoke)
    params = build_model(cfg).init(seed=seed, device=str(dev))
    dispatch = None
    if db:
        from ..integration.dispatch import DispatchContext
        from ..search.database import Database

        dispatch = DispatchContext(Database(db), backend="cuda")
    sc = ServeConfig(
        max_slots=max_slots, max_seq=max_seq, paged=paged,
        page_size=page_size, prefill_chunk=prefill_chunk, seed=seed,
        dispatch=dispatch,
    )
    return ContinuousBatchingScheduler(cfg, params, config=sc)


def _handle_connection(conn: socket.socket, host: SchedulerHost) -> bool:
    """Serve one client until EOF.  Returns False when asked to shut down
    or once the pump has failed."""
    rfile = conn.makefile("rb")
    try:
        while True:
            try:
                msg = recv_message(rfile)
            except ProtocolError as e:
                send_message(conn, error_response(str(e)))
                continue
            if msg is None:
                return True  # client went away; accept the next one
            try:
                check_version(msg)
            except ProtocolError as e:
                send_message(conn, error_response(str(e)))
                continue
            mtype = msg.get("type")
            failure = host.failure()
            if failure is not None and mtype != "shutdown":
                send_message(conn, error_response(failure))
                return False
            try:
                if mtype == "ping":
                    send_message(
                        conn,
                        {
                            "v": PROTOCOL_VERSION,
                            "type": "pong",
                            "model": host.scheduler.cfg.name,
                            "slots": host.scheduler.n_slots,
                            "pid": os.getpid(),
                        },
                    )
                elif mtype == "submit":
                    send_message(conn, host.submit(msg))
                elif mtype == "poll":
                    send_message(conn, host.poll(msg))
                elif mtype == "stats":
                    send_message(conn, host.stats())
                elif mtype == "shutdown":
                    send_message(conn, {"v": PROTOCOL_VERSION, "type": "bye"})
                    return False
                else:
                    send_message(
                        conn, error_response(f"unknown request {mtype!r}")
                    )
            except Exception as e:  # never die on a bad request
                send_message(
                    conn,
                    error_response(f"{mtype} failed: {type(e).__name__}: {e}"),
                )
    except OSError:
        return True  # connection dropped mid-reply; back to accept
    finally:
        try:
            rfile.close()
        except OSError:
            pass


def serve(
    host: str = "127.0.0.1",
    port: int = 0,
    scheduler=None,
    once: bool = False,
) -> Optional[Exception]:
    """Bind, announce READY, and serve clients until shutdown or until the
    pump fails.  Returns the exception that stopped the pump, else None."""
    shost = SchedulerHost(scheduler)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    srv.settimeout(ACCEPT_POLL_S)
    bound_port = srv.getsockname()[1]
    print(
        f"READY host={host} port={bound_port} pid={os.getpid()} "
        f"model={scheduler.cfg.name}",
        flush=True,
    )
    try:
        while shost.error is None:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            keep_going = _handle_connection(conn, shost)
            try:
                conn.close()
            except OSError:
                pass
            if not keep_going or once:
                break
    finally:
        srv.close()
        shost.close()
    return shost.error


def main(argv: Optional[List[str]] = None) -> None:
    """CLI entrypoint: ``python -m repro_torch.serving.worker``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument("--model", default="smollm-135m")
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument(
        "--no-paged", action="store_true",
        help="force the contiguous slot-pool arena",
    )
    ap.add_argument(
        "--db", default=None,
        help="shared tuning database for tuned-kernel dispatch",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--full-size", action="store_true",
        help="real config sizes (default: smoke-scaled)",
    )
    ap.add_argument(
        "--device", default="cuda", help="device to serve on (cuda | cpu)"
    )
    ap.add_argument(
        "--once", action="store_true", help="exit after the first client leaves"
    )
    args = ap.parse_args(argv)
    scheduler = build_scheduler(
        args.model,
        max_slots=args.max_slots,
        max_seq=args.max_seq,
        page_size=args.page_size,
        prefill_chunk=args.prefill_chunk,
        paged=False if args.no_paged else None,
        db=args.db,
        seed=args.seed,
        smoke=not args.full_size,
        device=args.device,
    )
    failed = serve(host=args.host, port=args.port, scheduler=scheduler, once=args.once)
    if failed is not None:
        sys.exit(PUMP_FAILED_RC)


if __name__ == "__main__":
    main()
