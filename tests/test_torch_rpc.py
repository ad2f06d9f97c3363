"""The port's RPC measurement fleet against the JAX package's.

* Wire protocol v1: ``encode_measure_input`` / ``encode_measure_result``
  and the request/response builders give the same JSON text in both
  packages for the same seeded traces (compared as strings, exactly).
* The fan-out runner against in-process stub workers (sharding in input
  order, a worker death retried on the survivor, a fleet that is all dead,
  quarantine after repeat crashes): equal results and ``stats()`` (all
  but the ``backend`` name, timings and the stub workers' addresses).
* The deliberate difference: a worker whose inner runner raises replies
  with an ``error`` marked ``"fault": true``, and the port's runner raises
  ``MeasurementFault``; the reference takes the same reply as a worker
  death, retries and quarantines, so the error ends as an ``inf``.
* End to end on the CPU: ``tune_workload("dense", ...)`` through
  ``rpc://`` to two spawned CPU workers gives the same workload key, the
  full trial budget and a re-validating best, as ``local`` does.
"""

import json
import math
import socket
import threading
import time

import numpy as np
import pytest

import repro.search.measure as jm
import repro.search.measure.rpc as jrpc
import repro.search.measure.worker as jworker
import repro_torch.search.measure as tm
import repro_torch.search.measure.rpc as trpc
import repro_torch.search.measure.worker as tworker
from repro.core.modules import SpaceGenerator as JSpace
from repro.core.modules import default_modules as jmodules
from repro.core.trace import Instruction as JInst
from repro.core.trace import Trace as JTrace
from repro.core.trace import new_expr_rv as jrv
from repro.core.workloads import get_workload as jget
from repro_torch.core.modules import SpaceGenerator as TSpace
from repro_torch.core.modules import default_modules as tmodules
from repro_torch.core.trace import Instruction as TInst
from repro_torch.core.trace import Trace as TTrace
from repro_torch.core.trace import new_expr_rv as trv
from repro_torch.core.workloads import get_workload as tget
from repro_torch.search.database import workload_key

PKGS = {
    "repro": (jm, jrpc, jworker, JTrace, JInst, jrv),
    "repro_torch": (tm, trpc, tworker, TTrace, TInst, trv),
}

WIRE_CASES = [
    ("dense", dict(m=32, n=64, k=32)),
    ("attention", dict(b=1, h=2, kvh=1, s=16, d=8)),
    ("batch_matmul", dict(b=2, m=16, n=16, k=16)),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kw", WIRE_CASES)
def test_wire_messages_equal_the_reference(name, kw, seed):
    key = workload_key(name, **kw)
    jt = JSpace(jmodules()).generate(jget(name, **kw), seed=seed).trace
    tt = TSpace(tmodules()).generate(tget(name, **kw), seed=seed).trace
    jmi = jm.MeasureInput(key, jget(name, **kw), jt)
    tmi = tm.MeasureInput(key, tget(name, **kw), tt)
    assert json.dumps(trpc.encode_measure_input(tmi)) == json.dumps(
        jrpc.encode_measure_input(jmi))
    opts = {"repeats": 3, "warmup": 1, "timeout_s": 30.0, "backend": "cuda"}
    assert json.dumps(trpc.measure_request([tmi], opts)) == json.dumps(
        jrpc.measure_request([jmi], opts))
    meta = {"backend": "cuda", "pallas_kernel": "matmul",
            "pallas_blocks_snapped": [32, 8, 16], "run_wall_s": 0.25}
    for lat, err in ((1.25e-4, ""), (float("inf"), "rejected (grid): too fine")):
        tr = tm.MeasureResult(lat, err, build_time_s=0.5, run_time_s=0.1, meta=meta)
        jr = jm.MeasureResult(lat, err, build_time_s=0.5, run_time_s=0.1, meta=meta)
        assert json.dumps(trpc.encode_measure_result(tr)) == json.dumps(
            jrpc.encode_measure_result(jr))
        assert json.dumps(trpc.results_response([tr])) == json.dumps(
            jrpc.results_response([jr]))
    assert trpc.error_response("boom") == jrpc.error_response("boom")
    # the port decodes what either package encodes, func rebuilt from the key
    back = trpc.decode_measure_input(jrpc.encode_measure_input(jmi))
    assert back.workload_key == key and back.func.name == tget(name, **kw).name
    assert back.trace.to_json() == jt.to_json()
    dec = trpc.decode_measure_result(jrpc.encode_measure_result(
        jm.MeasureResult(float("inf"), "boom", meta=meta)))
    assert dec.latency_s == math.inf and dec.error == "boom" and dec.meta == meta


def test_addresses_and_versions_match_the_reference():
    for addr in ("127.0.0.1:7070,host2:7071", "7070", ":7071", "h:1, ,h:2"):
        assert trpc.parse_addresses(addr) == jrpc.parse_addresses(addr)
    for p in (jrpc, trpc):
        with pytest.raises(ValueError, match="malformed rpc address"):
            p.parse_addresses("host:notaport")
        with pytest.raises(p.ProtocolError, match="version mismatch"):
            p.check_version({"v": p.PROTOCOL_VERSION + 1, "type": "ping"})
    assert trpc.PROTOCOL_VERSION == jrpc.PROTOCOL_VERSION == 1
    assert trpc.MAX_MESSAGE_BYTES == jrpc.MAX_MESSAGE_BYTES == 64 * 1024 * 1024


# -- stub fleet ------------------------------------------------------------


class StubWorker:
    """In-process protocol speaker (the reference's test stub): pongs
    handshakes, returns canned latencies, optionally dies; ``fault=True``
    replies to a measure with an error marked as a fault instead;
    ``turn=(lock, seconds)`` holds a lock shared with other stubs that long
    for each input, as a worker holds the card's timing lock."""

    def __init__(self, pkg, backend, device=None, die_after_measures=None,
                 die_forever=True, latency=1e-4, fault=False, turn=None):
        self.rpc = PKGS[pkg][1]
        self.mm = PKGS[pkg][0]
        self.backend, self.device = backend, device
        self.die_after = die_after_measures
        self.die_forever = die_forever
        self.latency = latency
        self.fault = fault
        self.turn = turn
        self.measures = 0
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    @property
    def addr(self):
        return f"127.0.0.1:{self.port}"

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            try:
                self._handle(conn)
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def _handle(self, conn):
        rpc = self.rpc
        rfile = conn.makefile("rb")
        while True:
            try:
                msg = rpc.recv_message(rfile)
            except (rpc.ProtocolError, OSError):
                return
            if msg is None:
                return
            if msg.get("type") == "ping":
                pong = {"v": rpc.PROTOCOL_VERSION, "type": "pong",
                        "backend": self.backend, "runner": "stub", "pid": 0}
                if self.device is not None:
                    pong["device"] = self.device
                rpc.send_message(conn, pong)
                continue
            if msg.get("type") == "measure":
                self.measures += 1
                if self.die_after is not None and self.measures > self.die_after:
                    if self.die_forever:
                        self.close()
                    return
                if self.fault:
                    rpc.send_message(conn, {
                        "v": rpc.PROTOCOL_VERSION, "type": "error", "fault": True,
                        "error": "measure failed: RuntimeError: CUDA error"})
                    continue
                if self.turn is not None:
                    lock, seconds = self.turn
                    for _ in msg["inputs"]:
                        with lock:
                            time.sleep(seconds)
                results = [
                    self.mm.MeasureResult(
                        self.latency * (1 + d["trace"].count("x")), "",
                        meta={"decision": i})
                    for i, d in enumerate(msg["inputs"])
                ]
                rpc.send_message(conn, rpc.results_response(results))

    def close(self):
        self._stop.set()
        try:
            self.srv.close()
        except OSError:
            pass


def _mi(pkg, decision):
    _, _, _, Trace, Inst, rv = PKGS[pkg]
    trace = Trace([Inst("sample_categorical", [], {"candidates": [0, 1, 2, 3]},
                        [rv(decision)], decision)])
    return PKGS[pkg][0].MeasureInput("gmm/k=8/m=8/n=8", None, trace)


def _shards(pkg, backend):
    stubs = [StubWorker(pkg, backend), StubWorker(pkg, backend)]
    return stubs, [_mi(pkg, i % 4) for i in range(5)], 1


def _death(pkg, backend):
    stubs = [StubWorker(pkg, backend, die_after_measures=0), StubWorker(pkg, backend)]
    return stubs, [_mi(pkg, i % 4) for i in range(4)], 1


def _all_dead(pkg, backend):
    stubs = [StubWorker(pkg, backend, die_after_measures=0) for _ in range(2)]
    return stubs, [_mi(pkg, 1), _mi(pkg, 2)], 1


def _quarantine(pkg, backend):
    stubs = [StubWorker(pkg, backend, die_after_measures=0, die_forever=False)
             for _ in range(2)]
    return stubs, [_mi(pkg, 3)], 3


FLEETS = {"shards": _shards, "death": _death, "all_dead": _all_dead,
          "quarantine": _quarantine}


def _run_fleet(pkg, scenario):
    backend = "cuda" if pkg == "repro_torch" else "jnp"
    stubs, inputs, times = FLEETS[scenario](pkg, backend)
    addr = ",".join(s.addr for s in stubs)
    kw = dict(address=addr, timeout_s=5.0, connect_timeout_s=10.0,
              crash_threshold=2, backend=backend)
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    r = PKGS[pkg][0].RPCRunner(**kw)
    try:
        out = []
        for _ in range(times):
            out.extend(r.run(inputs))
        stats = r.stats()
    finally:
        r.close()
        for s in stubs:
            s.close()
    by_addr = stats.pop("per_worker")
    per = [by_addr[s.addr] for s in stubs]
    for row in per:
        row.pop("dispatch_s")
    stats.pop("backend")
    return [(x.latency_s, x.error, x.source, x.meta) for x in out], stats, per


@pytest.mark.parametrize("scenario", sorted(FLEETS))
def test_stub_fleet_matches_the_reference(scenario):
    assert _run_fleet("repro_torch", scenario) == _run_fleet("repro", scenario)


def test_a_fault_reply_raises_where_the_reference_quarantines():
    stub = StubWorker("repro_torch", "cuda", fault=True)
    r = tm.RPCRunner(address=stub.addr, timeout_s=5.0, connect_timeout_s=10.0,
                     device="cpu")
    try:
        with pytest.raises(tm.MeasurementFault, match="CUDA error"):
            r.run([_mi("repro_torch", 1)])
        assert r.stats()["worker_deaths"] == 0 and not r.quarantined
    finally:
        r.close()
        stub.close()


class _RaisingRunner:
    """An inner runner whose measurement fails with an error that is not a
    rejection, behind each package's ``Runner`` base."""

    @staticmethod
    def make(pkg):
        base = PKGS[pkg][0].Runner

        class Raising(base):
            name = "raising"
            backend = "cuda" if pkg == "repro_torch" else "jnp"
            device = "cpu"

            def run(self, inputs):
                raise RuntimeError("CUDA error: misaligned address")

        return Raising()


class LoopWorker:
    """A package's real worker loop (``_handle_connection``) in a thread,
    over a stub inner runner."""

    def __init__(self, pkg, runner):
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.addr = f"127.0.0.1:{self.srv.getsockname()[1]}"
        loop = PKGS[pkg][2]._handle_connection

        def serve():
            while True:
                try:
                    conn, _ = self.srv.accept()
                except OSError:
                    return
                loop(conn, runner)
                conn.close()

        threading.Thread(target=serve, daemon=True).start()

    def close(self):
        self.srv.close()


def test_the_worker_replies_a_fault_and_keeps_serving():
    port = LoopWorker("repro_torch", _RaisingRunner.make("repro_torch"))
    r = tm.RPCRunner(address=port.addr, timeout_s=5.0, connect_timeout_s=10.0,
                     device="cpu")
    try:
        for _ in range(2):  # the worker is alive for the second request too
            with pytest.raises(tm.MeasurementFault) as e:
                r.run([tm.MeasureInput("gmm/k=8/m=8/n=8", None,
                                       _mi("repro_torch", 1).trace)])
            assert "misaligned address" in str(e.value) and "Traceback" in str(e.value)
        assert r.stats()["worker_deaths"] == 0
    finally:
        r.close()
        port.close()
    # the reference's worker sends the same error unmarked: its client
    # takes it for a death, retries and ends with an inf latency
    ref = LoopWorker("repro", _RaisingRunner.make("repro"))
    r = jm.RPCRunner(address=ref.addr, timeout_s=5.0, connect_timeout_s=10.0,
                     backend="jnp")
    try:
        out = r.run([jm.MeasureInput("gmm/k=8/m=8/n=8", None,
                                     _mi("repro", 1).trace)])
        assert not out[0].ok and r.stats()["worker_deaths"] >= 1
    finally:
        r.close()
        ref.close()


def test_rpc_specs_create_with_a_device_and_check_it():
    stubs = [StubWorker("repro_torch", "cuda", device="cpu") for _ in range(2)]
    addr = ",".join(s.addr for s in stubs)
    try:
        for spec in (f"rpc://{addr}", f"cached+rpc://{addr}"):
            r = tm.create_runner(spec, device="cpu")
            inner = getattr(r, "inner", r)
            assert isinstance(inner, tm.RPCRunner) and len(inner.workers) == 2
            r.close()
        with pytest.raises(RuntimeError, match="device"):
            tm.create_runner(f"rpc://{addr}", device="cuda", connect_timeout_s=5.0)
        with pytest.raises(ValueError, match="at least one worker address"):
            tm.create_runner("rpc", device="cpu")
    finally:
        for s in stubs:
            s.close()


def test_tune_through_rpc_workers_equals_local_on_the_cpu():
    import repro_torch
    from repro_torch.core.validator import validate_trace
    from repro_torch.search.database import Database
    from repro_torch.search.evolutionary import SearchConfig

    search = SearchConfig(max_trials=8, init_random=4, population=8,
                          measure_per_round=4, seed=0)
    kw = dict(m=32, n=64, k=32)
    local_db, rpc_db = Database(), Database()
    config = dict(search=search, warm_start=False)
    local = repro_torch.tune_workload(
        "dense", kw, database=local_db, device="cpu",
        config=repro_torch.TuneConfig(runner_spec="local", **config))
    handles = tm.spawn_local_workers(2, device="cpu")
    try:
        addr = ",".join(h.addr for h in handles)
        fleet = repro_torch.tune_workload(
            "dense", kw, database=rpc_db, device="cpu",
            config=repro_torch.TuneConfig(runner_spec=f"rpc://{addr}", **config))
    finally:
        for h in handles:
            h.kill()
    assert fleet.workload_key == local.workload_key
    assert fleet.trials == local.trials == search.max_trials
    for db, res in ((local_db, local), (rpc_db, fleet)):
        assert math.isfinite(res.best_latency_s)
        assert validate_trace(tget("dense", **kw), db.best(res.workload_key).trace()).ok
    stats = fleet.runner_stats
    assert all(w["candidates"] > 0 for w in stats["per_worker"].values())
    assert (stats["worker_deaths"], stats["crashes"], stats["timeouts"]) == (0, 0, 0)
    assert stats["measured"] >= search.max_trials
    assert np.isfinite([r.latency_s for r in rpc_db.records[fleet.workload_key]]).all()


def test_serialized_timing_stretches_each_shard_budget():
    """Workers on one card take turns at timing, so a shard may wait for
    the other shards' candidates: on a card each shard's budget covers the
    whole batch, and no legal candidate is taken for a dead worker.  Two
    stubs share a lock held 0.6 s an input (of a 1.0 s timeout); the batch
    of 4 takes about 2.4 s against a budget of 4.2 s (2.2 s by shard)."""
    lock = threading.Lock()
    stubs = [StubWorker("repro_torch", "cuda", device="cuda", turn=(lock, 0.6))
             for _ in range(2)]
    r = tm.RPCRunner(address=",".join(s.addr for s in stubs), timeout_s=1.0,
                     grace_s=0.2, startup_grace_s=0.0, connect_timeout_s=10.0,
                     device="cuda")
    try:
        assert r.serial_timing
        out = r.run([_mi("repro_torch", i) for i in range(4)])
        stats = r.stats()
    finally:
        r.close()
        for s in stubs:
            s.close()
    assert all(x.ok and x.source == "measured" for x in out)
    assert (stats["worker_deaths"], stats["retries"]) == (0, 0)
    assert [w["candidates"] for w in stats["per_worker"].values()] == [2, 2]
