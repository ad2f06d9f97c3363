"""The port's trace report against the JAX package's.

``repro_torch/obs/report.py`` is the reference's fold with its imports
rewired, so on the same events file ``load_events``, ``fold`` and
``render_text`` must give equal results (dicts and text compared exactly).
Two files: a synthetic one that fills every section (tuning, cost model,
learned search, measurement health, dispatch, extraction skips, the RPC
fleet, serving, the serving router), and one the port writes itself while
it tunes through ``cached+local`` and through an RPC fleet in which one
worker dies, so the port's own ``tune.*``, ``costmodel.*``, ``search.*``,
``cache.*`` and ``measure.*`` events are folded, and the fleet section's
counts must equal ``RPCRunner.stats()``.
"""

import json
import socket
import threading

import pytest

import repro.obs.report as jreport
import repro_torch.obs.report as treport


def _synthetic_events():
    h = "abc123"
    return [
        {"ev": "trace.start", "ts": 89.0, "pid": 1},
        {"ev": "measure.build", "ts": 91.0, "dur_s": 1.0, "ok": True, "key": "w", "hash": h},
        {"ev": "measure.build", "ts": 91.5, "dur_s": 0.1, "ok": False, "key": "w",
         "hash": "bad", "error": "rejected (grid): too fine"},
        {"ev": "measure.run", "ts": 95.0, "dur_s": 5.0, "ok": True, "key": "w", "hash": h,
         "latency_s": 2e-3},
        {"ev": "measure.run", "ts": 98.0, "dur_s": 3.0, "ok": True, "key": "w",
         "hash": "def456", "latency_s": 1e-3},
        {"ev": "measure.timeout", "ts": 98.5, "key": "w", "hash": "t", "timeout_s": 30.0},
        {"ev": "measure.crash", "ts": 98.6, "key": "w", "hash": "c", "crash": 1},
        {"ev": "measure.crash_quarantine", "ts": 98.7, "key": "w", "hash": "c"},
        {"ev": "cache.hit", "ts": 98.8, "key": "w", "hash": h},
        {"ev": "cache.miss", "ts": 98.9, "key": "w", "hash": h},
        {"ev": "costmodel.round", "ts": 96.0, "task": "w", "round": 1, "n": 4,
         "spearman": None, "trained": False},
        {"ev": "costmodel.round", "ts": 99.0, "task": "w", "round": 2, "n": 4,
         "spearman": 0.8, "trained": True},
        {"ev": "costmodel.warm_start", "ts": 90.0, "model_samples": 12, "dist_sites": 3},
        {"ev": "costmodel.prune", "ts": 96.1, "scored": 24, "kept": 16},
        {"ev": "search.sample", "ts": 96.2, "learned": 5, "valid": 16},
        {"ev": "search.dists", "ts": 96.3, "sites": 7},
        {"ev": "tune.round", "ts": 96.5, "dur_s": 6.0, "task": "w", "best_latency_s": 2e-3},
        {"ev": "tune.round", "ts": 99.9, "dur_s": 3.0, "task": "w", "best_latency_s": 1e-3},
        {"ev": "tune.session", "ts": 100.0, "dur_s": 10.0, "tasks": ["w"]},
        {"ev": "dispatch.hit", "ts": 101.0, "key": "w", "site": "dense", "mode": "best"},
        {"ev": "dispatch.miss", "ts": 101.2, "key": "x", "site": "rmsnorm",
         "mode": "best", "reason": "no_record"},
        {"ev": "dispatch.fallback", "ts": 101.3, "key": None, "site": "attention",
         "mode": "best", "reason": "decode_offset"},
        {"ev": "extract.skip", "ts": 101.4, "site": "moe", "reason": "dynamic"},
        {"ev": "measure.rpc.dispatch", "ts": 97.0, "worker": "h:1", "n": 4,
         "dur_s": 0.5, "ok": True},
        {"ev": "measure.rpc.dispatch", "ts": 97.1, "worker": "h:2", "n": 4,
         "dur_s": 0.2, "ok": False},
        {"ev": "measure.rpc.worker_death", "ts": 97.2, "worker": "h:2", "stage": "batch"},
        {"ev": "measure.rpc.retry", "ts": 97.3, "key": "w", "hash": h},
        {"ev": "serve.prefill", "ts": 102.0, "tokens": 100, "dur_s": 2.0, "chunked": True},
        {"ev": "serve.decode", "ts": 104.0, "tokens": 30, "dur_s": 3.0},
        {"ev": "serve.admit", "ts": 102.1},
        {"ev": "serve.evict", "ts": 104.1, "ttft_s": 0.5, "latency_s": 2.0},
        {"ev": "serve.router.submit", "ts": 105.0},
        {"ev": "serve.router.complete", "ts": 105.5, "worker": 0},
        {"ev": "serve.router.worker_death", "ts": 105.6, "worker": 1},
        {"ev": "serve.router.resubmit", "ts": 105.7},
    ]


def _fold_both(path):
    ref = jreport.fold(jreport.load_events([path]))
    port = treport.fold(treport.load_events([path]))
    assert port == ref
    assert treport.render_text(port) == jreport.render_text(ref)
    return port


def test_synthetic_events_fold_as_in_the_reference(tmp_path):
    path = tmp_path / "events.jsonl"
    with open(path, "w") as fh:
        for e in _synthetic_events():
            fh.write(json.dumps(e) + "\n")
        fh.write("not json\n")  # bad lines are skipped by both
    rep = _fold_both(str(path))
    for section in ("measure", "dispatch", "rpc", "serving", "serving_router",
                    "learned", "extract_skips"):
        assert rep[section], section
    assert rep["rpc"]["workers"]["h:2"] == {"batches": 1, "candidates": 4,
                                           "failed_batches": 1, "dispatch_s": 0.2,
                                           "deaths": 1}


class _DyingStub:
    """A protocol speaker (backend cuda, device cpu) that answers every
    measure with canned results, or drops the connection from its
    ``die_after``-th measure on and stops listening, as a dead process."""

    def __init__(self, die_after=None):
        from repro_torch.search.measure import MeasureResult
        from repro_torch.search.measure import rpc

        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.addr = f"127.0.0.1:{self.srv.getsockname()[1]}"
        self.measures = 0

        def handle(conn):
            rfile = conn.makefile("rb")
            while True:
                msg = rpc.recv_message(rfile)
                if msg is None:
                    return
                if msg["type"] == "ping":
                    rpc.send_message(conn, {"v": 1, "type": "pong", "backend": "cuda",
                                            "device": "cpu", "runner": "stub", "pid": 0})
                    continue
                self.measures += 1
                if die_after is not None and self.measures > die_after:
                    self.srv.close()
                    return
                rpc.send_message(conn, rpc.results_response(
                    [MeasureResult(1e-4 * (1 + i)) for i in range(len(msg["inputs"]))]))

        def serve():
            while True:
                try:
                    conn, _ = self.srv.accept()
                except OSError:
                    return
                try:
                    handle(conn)
                except OSError:
                    pass
                conn.close()

        threading.Thread(target=serve, daemon=True).start()

    def close(self):
        self.srv.close()


def test_the_ports_own_events_fold_as_in_the_reference(tmp_path):
    import repro_torch
    from repro_torch.obs import JsonlSink, configure_tracing, disable_tracing
    from repro_torch.search.evolutionary import SearchConfig
    from repro_torch.search.measure import RPCRunner

    path = str(tmp_path / "port.jsonl")
    search = SearchConfig(max_trials=8, init_random=4, population=8,
                          measure_per_round=4, seed=0)
    stubs = [_DyingStub(die_after=1), _DyingStub()]
    configure_tracing(JsonlSink(path))
    try:
        repro_torch.tune_workload(
            "dense", dict(m=32, n=64, k=32), device="cpu",
            config=repro_torch.TuneConfig(search=search, runner_spec="cached+local",
                                          warm_start=False))
        rpc = RPCRunner(address=",".join(s.addr for s in stubs), timeout_s=5.0,
                        connect_timeout_s=10.0, device="cpu")
        try:
            repro_torch.tune_workload(
                "dense", dict(m=32, n=64, k=32), device="cpu",
                config=repro_torch.TuneConfig(search=search, runner_spec=rpc,
                                              warm_start=False))
            stats = rpc.stats()
        finally:
            rpc.close()
    finally:
        disable_tracing()
        for s in stubs:
            s.close()
    rep = _fold_both(path)
    assert rep["measure"]["cache_misses"] > 0 and rep["tasks"] and rep["cost_model"]
    fleet = rep["rpc"]
    assert stats["worker_deaths"] == fleet["worker_deaths"] == 1
    assert stats["retries"] == fleet["retries"] >= 1
    for addr, row in stats["per_worker"].items():
        got = fleet["workers"][addr]
        assert got["batches"] - got["failed_batches"] == row["batches"]
        assert got["deaths"] == row["deaths"]
    assert fleet["batches"] == sum(
        row["batches"] for row in stats["per_worker"].values()) + stats["worker_deaths"]
