"""Measurement worker process: the fleet-side half of :mod:`rpc`.

Run as ``python -m repro_torch.search.measure.worker --port N --device
cuda`` (``--backend``, default ``cuda``; ``--device``, default ``cuda``,
raises where there is no card).  The worker binds a TCP port, prints a
``READY host=... port=... pid=...`` line once its inner runner is
constructed (torch imported, backend validated, kernels built), and then
serves newline-framed JSON requests:

    ping      -> pong (protocol version, backend, device, pid) — used by
                 RPCRunner's handshake to verify compatibility
    measure   -> builds + times each candidate through the inner runner
                 (default ``local``; ``--runner pool`` adds in-worker
                 process isolation with crash quarantine) and returns one
                 result per input, meta preserved.  An exception from the
                 inner runner (anything but a rejection, which is an
                 ``inf`` result) is replied as an ``error`` marked
                 ``"fault": true`` with its traceback, which the client
                 raises; the worker itself keeps serving
    shutdown  -> replies ``bye`` and exits

One connection is served at a time; when a client disconnects the worker
goes back to ``accept`` so a restarted ``RPCRunner`` can reconnect.
Candidates that fail to decode are reported as per-input errors — the
worker never lets one bad input poison a batch.
"""

from __future__ import annotations

import argparse
import os
import socket
import traceback
from typing import Any, Dict, List, Optional

from .protocol import MeasureResult, Runner
from .rpc import (
    PROTOCOL_VERSION,
    ProtocolError,
    check_version,
    decode_measure_input,
    error_response,
    recv_message,
    results_response,
    send_message,
)


def make_worker_runner(
    spec: str = "local",
    backend: Optional[str] = None,
    timeout_s: Optional[float] = None,
    repeats: Optional[int] = None,
    warmup: Optional[int] = None,
    device: str = "cuda",
) -> Runner:
    """Build the worker's inner runner from a registry spec."""
    from .registry import create_runner

    kw: Dict[str, Any] = {"device": device}
    if timeout_s is not None:
        kw["timeout_s"] = timeout_s
    if repeats is not None:
        kw["repeats"] = repeats
    if warmup is not None:
        kw["warmup"] = warmup
    return create_runner(spec, backend=backend, **kw)


def handle_measure(runner: Runner, msg: Dict[str, Any]) -> Dict[str, Any]:
    """Decode a measure request, run it, encode the response in order."""
    opts = msg.get("opts") or {}
    for attr in ("repeats", "warmup", "timeout_s"):
        if attr in opts and hasattr(runner, attr):
            setattr(runner, attr, opts[attr])
    raw_inputs = msg.get("inputs") or []
    decoded = []  # (original index, MeasureInput)
    results: List[Optional[MeasureResult]] = [None] * len(raw_inputs)
    for i, d in enumerate(raw_inputs):
        try:
            decoded.append((i, decode_measure_input(d)))
        except Exception as e:
            results[i] = MeasureResult(
                float("inf"), f"undecodable input: {type(e).__name__}: {e}"
            )
    if decoded:
        measured = runner.run([mi for _, mi in decoded])
        for (i, _), res in zip(decoded, measured):
            results[i] = res
    # every slot is filled: decode failures above, measurements here
    return results_response([r for r in results if r is not None])


def _device_name(runner: Runner) -> Optional[str]:
    device = getattr(runner, "device", None)
    return None if device is None else str(device)


def _handle_connection(conn: socket.socket, runner: Runner) -> bool:
    """Serve one client until EOF.  Returns False when asked to shut down."""
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
            if mtype == "ping":
                send_message(
                    conn,
                    {
                        "v": PROTOCOL_VERSION,
                        "type": "pong",
                        "backend": runner.backend,
                        # None for an inner runner that names no device
                        "device": _device_name(runner),
                        "runner": runner.name,
                        "pid": os.getpid(),
                    },
                )
            elif mtype == "measure":
                try:
                    reply = handle_measure(runner, msg)
                except Exception as e:  # never die on a bad batch
                    # a fault, not a rejection: the client raises it
                    reply = error_response(
                        f"measure failed: {type(e).__name__}: {e}\n"
                        f"{traceback.format_exc()}",
                        fault=True,
                    )
                send_message(conn, reply)
            elif mtype == "shutdown":
                send_message(conn, {"v": PROTOCOL_VERSION, "type": "bye"})
                return False
            else:
                send_message(conn, error_response(f"unknown request {mtype!r}"))
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
    runner: Optional[Runner] = None,
    once: bool = False,
) -> None:
    """Bind, announce READY, and serve clients until shutdown."""
    runner = runner or make_worker_runner()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(8)
    bound_port = srv.getsockname()[1]
    print(
        f"READY host={host} port={bound_port} pid={os.getpid()} "
        f"backend={runner.backend}",
        flush=True,
    )
    try:
        while True:
            conn, _ = srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            keep_going = _handle_connection(conn, runner)
            try:
                conn.close()
            except OSError:
                pass
            if not keep_going or once:
                return
    finally:
        srv.close()
        runner.close()


def main(argv: Optional[List[str]] = None) -> None:
    """CLI entrypoint: ``python -m repro_torch.search.measure.worker``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0, help="0 = ephemeral")
    ap.add_argument(
        "--backend", default=None, help="lowering-backend spec (default cuda)"
    )
    ap.add_argument(
        "--device", default="cuda", help="device to measure on (cuda | cpu)"
    )
    ap.add_argument(
        "--runner",
        default="local",
        help="inner runner registry spec (local | pool | cached+local ...)",
    )
    ap.add_argument("--timeout-s", type=float, default=None)
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=None)
    ap.add_argument(
        "--once", action="store_true", help="exit after the first client leaves"
    )
    args = ap.parse_args(argv)
    runner = make_worker_runner(
        args.runner,
        backend=args.backend,
        timeout_s=args.timeout_s,
        repeats=args.repeats,
        warmup=args.warmup,
        device=args.device,
    )
    serve(host=args.host, port=args.port, runner=runner, once=args.once)


if __name__ == "__main__":
    main()
