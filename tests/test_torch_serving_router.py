"""The port's serving worker and router against the JAX package's.

The workers under test run their real ``serve()`` loop, on a thread of this
process (in-process) or as ``python -m repro_torch.serving.worker``
subprocesses; the schedulers behind the in-process ones run smollm-smoke in
float32 (``dataclasses.replace(cfg, dtype="float32")``, the reference's
parameters carried across by ``params_from_jax``) at the settings of
``benchmarks/router_smoke.py``: 2 slots, max_seq 32, 8-token pages,
4-token prefill chunks.

* (a) wire parity: the same lines (``ping``, 8 ``submit``s, an empty
  prompt, ``poll`` with an unknown rid, ``stats``, an unknown type, a wrong
  version, a malformed line, ``shutdown``) to both workers give replies with
  equal keys and value types; error strings, rids and token streams are
  equal exactly.  Excepted: pid, model name and times (keys ending in
  ``_s``), and the port's one addition, ``stats["launches"]``.
* (b) router parity: each router over each package's workers, the prompts
  of ``router_smoke.py``; greedy float32 streams are equal exactly, to each
  other and to one in-process reference scheduler (tolerance: none).
* (c) failover in process: ``workers[1].kill()`` after the first poll, with
  both schedulers held idle until then, gives equal ``stats`` in both
  packages, and the streams of (b).
* (d) subprocess workers (smoke bf16 on the CPU): one SIGKILLed mid-run;
  every request completes, one death is counted, and the streams equal an
  in-process port scheduler built the same way (``build_scheduler``, same
  seed).  A worker asked for CUDA here raises ``RuntimeError`` naming it,
  from the parent and from the worker itself.  No process is left after
  ``shutdown``.
* (e) a worker whose scheduler tick raises answers the next request with
  ``pump failed: ...`` and stops serving (``serve()`` returns the
  exception, in process); the CLI worker then exits with
  ``PUMP_FAILED_RC`` and its traceback; the router counts the death and
  the survivor serves.
* (f) the router's trace folds (in both packages' ``obs.report``) into a
  ``serving_router`` section whose counts equal ``router.stats``.
* A worker built with ``--db`` dispatches from its pump thread: its
  context counts hits.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.obs.report as jreport
import repro.serving.router as jrouter
import repro.serving.worker as jworker
import repro_torch
import repro_torch.obs.report as treport
import repro_torch.serving.router as trouter
import repro_torch.serving.worker as tworker
from repro_torch.search.measure.rpc import parse_ready
from repro.configs.base import get_config as jcfg
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingScheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config as tcfg
from repro_torch.models.convert import params_from_jax
from repro_torch.obs import RingBufferSink, configure_tracing, disable_tracing
from repro_torch.search.database import Database
from repro_torch.search.evolutionary import SearchConfig
from repro_torch.serving import ContinuousBatchingScheduler as TScheduler
from repro_torch.serving import ServeConfig as TServeConfig

SRC = str(Path(__file__).resolve().parents[1] / "src")
HOST = "127.0.0.1"
MODEL = "smollm-135m"
# benchmarks/router_smoke.py's settings
SERVE = dict(max_slots=2, max_seq=32, page_size=8, prefill_chunk=4)
MAX_NEW = 6
N_REQ = 8
ROUTERS = {"repro": jrouter, "repro_torch": trouter}
WORKERS = {"repro": jworker, "repro_torch": tworker}


def _prompts(n):
    # benchmarks/router_smoke.py:_prompts
    return [[(i * 13 + j) % 50 + 1 for j in range(1 + (i * 7) % 12)] for i in range(n)]


def _free_port():
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _request(port, msg):
    with socket.create_connection((HOST, port), timeout=30) as s:
        s.sendall(json.dumps(msg).encode() + b"\n")
        return json.loads(s.makefile("rb").readline())


class Served:
    """One package's ``serve()`` on a thread, on a free port, over a
    scheduler whose ticks wait while ``gate`` is clear."""

    def __init__(self, pkg, scheduler):
        self.pkg = pkg
        self.scheduler = scheduler
        self.gate = threading.Event()
        self.gate.set()
        pending = scheduler.pending
        scheduler.pending = lambda: self.gate.is_set() and pending()
        self.port = _free_port()
        self.returned = None

        def run():
            self.returned = WORKERS[pkg].serve(host=HOST, port=self.port,
                                               scheduler=scheduler)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        deadline = time.monotonic() + 30
        while True:  # wait until it listens (the probe is a client that leaves)
            try:
                socket.create_connection((HOST, self.port), timeout=1).close()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.01)

    def link(self, router_pkg, index):
        return ROUTERS[router_pkg]._WorkerLink(index, HOST, self.port)

    def stop(self):
        assert _request(self.port, {"v": 1, "type": "shutdown"})["type"] == "bye"
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


def _f32_pair():
    jc = dataclasses.replace(jcfg(MODEL, smoke=True), dtype="float32")
    tc = dataclasses.replace(tcfg(MODEL, smoke=True), dtype="float32")
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), JT.init_params(jc, jax.random.PRNGKey(0)))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def f32():
    return _f32_pair()


def _scheduler(pkg, f32):
    jc, tc, jp, tp = f32
    if pkg == "repro":
        return JScheduler(jc, jp, config=JServeConfig(**SERVE))
    return TScheduler(tc, tp, config=TServeConfig(**SERVE))


@pytest.fixture(scope="module")
def served(f32):
    """Two in-process workers of each package, shared by the tests below."""
    out = {pkg: [Served(pkg, _scheduler(pkg, f32)) for _ in range(2)] for pkg in WORKERS}
    yield out
    for pair in out.values():
        for s in pair:
            s.gate.set()
            s.stop()


@pytest.fixture(scope="module")
def reference_streams(f32):
    """One in-process reference scheduler over every prompt."""
    sched = _scheduler("repro", f32)
    reqs = [sched.submit(np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
            for p in _prompts(N_REQ)]
    sched.run()
    return [list(map(int, r.generated)) for r in reqs]


def _route(router_pkg, servers, kill_after_first_poll=False):
    """Each prompt through ``router_pkg``'s router over ``servers``; with
    ``kill_after_first_poll`` the schedulers stay idle until worker 1's link
    is killed after the first poll round.  Returns (streams, stats)."""
    links = [s.link(router_pkg, i) for i, s in enumerate(servers)]
    router = ROUTERS[router_pkg].ServingRouter(links, model=MODEL)
    try:
        if kill_after_first_poll:
            for s in servers:
                s.gate.clear()
        for p in _prompts(N_REQ):
            router.submit(p, max_new=MAX_NEW)
        if kill_after_first_poll:
            assert router.poll() == 0
            router.workers[1].kill()
            for s in servers:
                s.gate.set()
        router.drain(timeout_s=120)
        return [r.tokens for r in router.requests], dict(router.stats)
    finally:
        for s in servers:
            s.gate.set()
        for w in links:
            w.close()  # the in-process workers go back to accept


# ---------------------------------------------------------------------------
# (a) the wire format
# ---------------------------------------------------------------------------


def _skeleton(x, key=""):
    """Keys and value types of a reply; times, pid and model excepted."""
    if key in ("pid", "model") or key.endswith("_s"):
        return "*"
    if isinstance(x, dict):
        return {k: _skeleton(v, k) for k, v in x.items()}
    if isinstance(x, list):
        return [_skeleton(v) for v in x]
    return type(x).__name__


def _conversation(port):
    msgs = [{"v": 1, "type": "ping"}]
    msgs += [{"v": 1, "type": "submit", "prompt": p, "max_new": MAX_NEW,
              "temperature": None} for p in _prompts(N_REQ)]
    msgs.append({"v": 1, "type": "submit", "prompt": [], "max_new": MAX_NEW})
    with socket.create_connection((HOST, port), timeout=60) as s:
        rfile = s.makefile("rb")

        def send(raw):
            s.sendall(raw)
            return json.loads(rfile.readline())

        replies = [send(json.dumps(m).encode() + b"\n") for m in msgs]
        poll = {"v": 1, "type": "poll", "rids": list(range(N_REQ)) + [99]}
        deadline = time.monotonic() + 60
        while True:  # until every request is done
            status = send(json.dumps(poll).encode() + b"\n")
            if all(st.get("done") for rid, st in status["requests"].items() if rid != "99"):
                break
            assert time.monotonic() < deadline
            time.sleep(0.01)
        replies.append(status)
        for raw in (b'{"v": 1, "type": "stats"}\n', b'{"v": 1, "type": "frobnicate"}\n',
                    b'{"v": 2, "type": "ping"}\n', b"this is not json\n",
                    b'{"v": 1, "type": "shutdown"}\n'):
            replies.append(send(raw))
    return replies


def test_wire_replies_match_the_reference(f32):
    got = {}
    for pkg in WORKERS:
        srv = Served(pkg, _scheduler(pkg, f32))
        got[pkg] = _conversation(srv.port)
        srv.thread.join(timeout=30)  # the shutdown above ends serve()
        assert not srv.thread.is_alive()
    ref, port = got["repro"], got["repro_torch"]
    launches = port[-5]["stats"].pop("launches")
    assert set(launches) >= {"matmul", "decode_flash_attention", "matmul/splitk"}
    assert all(isinstance(n, int) for n in launches.values())
    assert [_skeleton(r) for r in port] == [_skeleton(r) for r in ref]
    # everything that is not a time, a pid or a counter of the run is equal
    assert [r.get("error") for r in port] == [r.get("error") for r in ref]
    assert [r.get("rid") for r in port] == [r.get("rid") for r in ref] == \
        [None] + list(range(N_REQ)) + [None] * 7
    assert port[0]["slots"] == ref[0]["slots"] == SERVE["max_slots"]
    tok = lambda st: {rid: (v.get("tokens"), v.get("done"), v.get("error"))  # noqa: E731
                      for rid, v in st["requests"].items()}
    assert tok(port[-6]) == tok(ref[-6])
    assert port[-6]["requests"]["99"] == {"error": "unknown rid"}
    assert ref[9]["error"] == ("submit failed: ValueError: prompt must have at least "
                               "one token")
    assert [r["error"] for r in ref[-4:-1]] == [
        "unknown request 'frobnicate'", "protocol version mismatch: got 2, expected 1",
        "undecodable message: Expecting value: line 1 column 1 (char 0)"]
    assert port[-1] == ref[-1] == {"v": 1, "type": "bye"}


# ---------------------------------------------------------------------------
# (b), (c) the router in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("router_pkg,worker_pkg", [
    ("repro", "repro"), ("repro_torch", "repro_torch"),
    ("repro_torch", "repro"), ("repro", "repro_torch")])
def test_router_streams_match_the_reference(served, reference_streams, router_pkg,
                                            worker_pkg):
    streams, stats = _route(router_pkg, served[worker_pkg])
    assert streams == reference_streams
    assert stats == {"submitted": N_REQ, "completed": N_REQ, "resubmits": 0,
                     "worker_deaths": 0}


def test_failover_in_process_matches_the_reference(served, reference_streams):
    got = {pkg: _route(pkg, served[pkg], kill_after_first_poll=True) for pkg in ROUTERS}
    for streams, _ in got.values():
        assert streams == reference_streams
    # worker 1 held requests 1, 3, 5, 7; ``kill()`` marks its link dead
    # itself, so the router resubmits them but counts no death of its own
    assert got["repro"][1] == got["repro_torch"][1] == {
        "submitted": N_REQ, "completed": N_REQ, "resubmits": N_REQ // 2,
        "worker_deaths": 0}


# ---------------------------------------------------------------------------
# (d) spawned workers, one SIGKILLed
# ---------------------------------------------------------------------------


def test_spawned_workers_survive_a_sigkill():
    router = trouter.ServingRouter.spawn(2, model=MODEL, device="cpu", **SERVE)
    procs = [w.proc for w in router.workers]
    try:
        for p in _prompts(N_REQ):
            router.submit(p, max_new=MAX_NEW)
        victim = router.workers[0]
        assert router._outstanding[victim.index]
        os.kill(victim.pid, signal.SIGKILL)
        victim.proc.wait(timeout=30)
        router.drain(timeout_s=120)
        summary = router.summary()
    finally:
        router.shutdown()
    assert all(p.poll() is not None for p in procs)  # no worker left
    assert summary["router"]["completed"] == N_REQ
    assert summary["router"]["worker_deaths"] == 1
    assert summary["router"]["resubmits"] >= 1
    assert [w["alive"] for w in summary["workers"]] == [False, True]
    assert summary["workers"][1]["scheduler"]["released"] >= N_REQ // 2
    # the same model, seed and settings, served in this process
    sched = tworker.build_scheduler(MODEL, device="cpu", **SERVE)
    reqs = [sched.submit(np.asarray(p, np.int32), max_new_tokens=MAX_NEW)
            for p in _prompts(N_REQ)]
    sched.run()
    assert [r.tokens for r in router.requests] == [list(map(int, r.generated))
                                                    for r in reqs]


def test_a_worker_asked_for_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trouter.spawn_serving_workers(1, device="cuda", **SERVE)
    # the worker itself, before READY: the tail of its output is in the error
    with pytest.raises(RuntimeError, match=r"exited before READY[\s\S]*CUDA is not "
                                           r"available"):
        trouter.spawn_serving_workers(2, device="cpu", extra_args=["--device", "cuda"],
                                      **SERVE)


# ---------------------------------------------------------------------------
# a busy pump
# ---------------------------------------------------------------------------


class _BusyScheduler:
    """Always has work; each tick holds the lock for ``TICK_S``."""

    TICK_S = 0.05

    def __init__(self):
        self._requests = []

    def pending(self):
        return True

    def step(self):
        time.sleep(self.TICK_S)
        return True


def test_a_busy_pump_lets_each_request_in_within_two_ticks():
    # a lock is not fair: a pump that took it again the moment a tick ended
    # would keep a request waiting for as many ticks as the scheduler has
    host = tworker.SchedulerHost(_BusyScheduler())
    try:
        waits = []
        for _ in range(20):
            t0 = time.perf_counter()
            assert host.poll({"rids": []})["requests"] == {}
            waits.append(time.perf_counter() - t0)
            time.sleep(0.003)
    finally:
        host.close()
    assert max(waits) < 2 * _BusyScheduler.TICK_S + 0.05, waits


# ---------------------------------------------------------------------------
# (e) a failing pump
# ---------------------------------------------------------------------------

_BAD_WORKER = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.serving import worker
from repro_torch.serving.scheduler import ContinuousBatchingScheduler


def step(self):
    raise RuntimeError("injected tick failure")


ContinuousBatchingScheduler.step = step
worker.main({argv!r})
"""


def _fail_step():
    raise RuntimeError("injected tick failure")


def _route_past_a_failing_pump(bad, good):
    """Two prompts through the port's router over ``bad`` and ``good``;
    returns the router and the death's traced reason."""
    sink = RingBufferSink()
    configure_tracing(sink)
    try:
        router = trouter.ServingRouter([bad, good], model=MODEL)
        for p in _prompts(2):
            router.submit(p, max_new=MAX_NEW)
        router.drain(timeout_s=60)
    finally:
        disable_tracing()
        good.close()
    deaths = sink.of_type("serve.router.worker_death")
    assert len(deaths) == 1
    return router, deaths[0]["reason"]


def test_a_failing_pump_ends_the_worker_and_the_router_counts_it(served):
    argv = ["--device", "cpu", "--model", MODEL] + [
        a for k, v in SERVE.items() for a in ("--" + k.replace("_", "-"), str(v))]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-c", _BAD_WORKER.format(src=SRC, argv=argv)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    try:
        line = proc.stdout.readline()
        ready = parse_ready(line)
        assert ready, line
        bad = trouter._WorkerLink(0, ready["host"], int(ready["port"]), proc=proc,
                                  pid=int(ready["pid"]))
        good = served["repro_torch"][0].link("repro_torch", 1)
        router, reason = _route_past_a_failing_pump(bad, good)
        out = proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
    assert proc.returncode == tworker.PUMP_FAILED_RC
    assert "Traceback" in out and "injected tick failure" in out
    assert "pump failed: RuntimeError: injected tick failure" in reason
    assert router.stats["worker_deaths"] == 1
    assert router.stats["completed"] == 2 and router.workers[1].completed == 2


def test_a_failing_pump_in_process_ends_serve_and_the_router_counts_it(served):
    # the same fault planted in a worker on a thread of this process: the
    # host exits nothing, serve() returns the exception
    sched = tworker.build_scheduler(MODEL, device="cpu", **SERVE)
    sched.step = _fail_step
    bad = Served("repro_torch", sched)
    router, reason = _route_past_a_failing_pump(
        bad.link("repro_torch", 0), served["repro_torch"][0].link("repro_torch", 1))
    bad.thread.join(timeout=30)
    assert not bad.thread.is_alive()
    assert isinstance(bad.returned, RuntimeError)
    assert str(bad.returned) == "injected tick failure"
    assert reason == "poll failed: worker 0: pump failed: RuntimeError: injected tick failure"
    assert router.stats == {"submitted": 2, "completed": 2, "resubmits": 1,
                            "worker_deaths": 1}
    assert [w.completed for w in router.workers] == [0, 2]


# ---------------------------------------------------------------------------
# (f) the router's trace, folded
# ---------------------------------------------------------------------------


def test_router_trace_folds_into_its_stats(served):
    servers = served["repro_torch"]
    sink = RingBufferSink()
    configure_tracing(sink)
    links = [s.link("repro_torch", i) for i, s in enumerate(servers)]
    try:
        router = trouter.ServingRouter(links, model=MODEL)
        for s in servers:
            s.gate.clear()
        for p in _prompts(N_REQ):
            router.submit(p, max_new=MAX_NEW)
        assert router.poll() == 0
        links[1]._sock.shutdown(socket.SHUT_RDWR)  # the connection drops
        for s in servers:
            s.gate.set()
        router.drain(timeout_s=120)
    finally:
        disable_tracing()
        for s in servers:
            s.gate.set()
        for w in links:
            w.close()
    assert router.stats == {"submitted": N_REQ, "completed": N_REQ,
                            "resubmits": N_REQ // 2, "worker_deaths": 1}
    folded = treport.fold(sink.events)["serving_router"]
    assert folded == jreport.fold(sink.events)["serving_router"]
    assert {k: folded[k] for k in router.stats} == router.stats
    assert folded["workers"] == {
        str(w.index): {"completed": w.completed, "deaths": int(not w.alive)}
        for w in router.workers}
    assert len(sink.of_type("serve.router.drain")) == 1


# ---------------------------------------------------------------------------
# a dispatched worker
# ---------------------------------------------------------------------------


def test_a_worker_with_a_database_dispatches_from_its_pump(tmp_path):
    cfg = tcfg(MODEL, smoke=True)
    tasks = repro_torch.extract_decode_tasks(
        cfg, batch=SERVE["max_slots"], max_seq=SERVE["max_seq"],
        dispatchable_only=True, ops=("attention_decode",))
    path = str(tmp_path / "serve_db.json")
    db = Database(path)
    search = SearchConfig(max_trials=3, init_random=2, population=3, measure_per_round=2)
    repro_torch.TaskScheduler(
        tasks, database=db,
        config=repro_torch.TuneConfig(search=search, runner_spec="cached+local",
                                      backend="cuda", device="cpu"),
    ).tune(total_rounds=len(tasks))
    db.save()
    sched = tworker.build_scheduler(MODEL, db=path, device="cpu", **SERVE)
    assert sched.dispatch is not None and sched.dispatch.db.keys() == [tasks[0].key]
    srv = Served("repro_torch", sched)
    router = trouter.ServingRouter([srv.link("repro_torch", 0)], model=MODEL)
    try:
        for p in _prompts(4):
            router.submit(p, max_new=MAX_NEW)
        router.drain(timeout_s=60)
    finally:
        router.shutdown()
    srv.thread.join(timeout=30)
    assert router.stats["completed"] == 4
    # the pump thread ran every tick under the worker's context
    assert sched.dispatch.stats["attention_decode_tuned"] > 0
    assert sched.dispatch.hits_by_key[tasks[0].key] > 0
