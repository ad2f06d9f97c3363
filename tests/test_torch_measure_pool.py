"""The port's process-pool runner against the JAX package's.

The reference's stub-worker scenarios (results in input order, a batch
timeout and recovery, crash quarantine, a crash attributed inside a mixed
batch) run through both packages' ``ProcessPoolRunner`` with the same
stub workers and must give equal latencies, errors, sources, crash counts
and ``stats()`` (all but the ``backend`` and ``device`` names, which
differ by design).  One deliberate difference: a worker that *raises*
anything but a rejection (here a stand-in for a CUDA error) is a crash
the reference turns into an ``inf`` latency, while the port raises
``MeasurementFault`` in the caller, so a kernel fault never looks like a
rejected candidate.  A worker process that *dies* is attributed and
quarantined the same way in both.

The stub workers live at module level (spawn pickles them by reference)
and each pool worker imports this module, so it imports neither package
at the top: the packages come from the ``pkgs`` fixture.  Latencies are
compared exactly (the stubs return them from the workload key), and the
end-to-end run on the CPU compares workload keys, trial counts and
re-validating best traces, not times.
"""

import math
import os
import time

import pytest


def _keyed_worker(payload):
    """Latency encoded in the workload key: 'ok:<latency>'; 'sleep' hangs;
    'crash' kills the worker process; 'fault' raises, as a worker whose
    kernel launch failed would."""
    key = payload["workload_key"]
    if key.startswith("sleep"):
        time.sleep(60)
    if key.startswith("crash"):
        os._exit(13)
    if key.startswith("fault"):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")
    return {
        "latency_s": float(key.split(":")[1]),
        "error": "",
        "build_time_s": 0.0,
        "run_time_s": 0.0,
    }


def _turn_worker(payload):
    """'turn:<seconds>': hold a file lock shared by the pool's workers for
    that long, as a worker holds the card's timing lock while it times."""
    import fcntl
    import tempfile

    seconds = float(payload["workload_key"].split(":")[1])
    path = os.path.join(tempfile.gettempdir(), f"turn-stub-{os.getppid()}.lock")
    with open(path, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            time.sleep(seconds)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return {"latency_s": seconds, "error": "", "build_time_s": 0.0, "run_time_s": 0.0}


class _Pkg:
    """One package's measurement names."""

    def __init__(self, name):
        import importlib

        self.name = name
        self.measure = importlib.import_module(f"{name}.search.measure")
        self.trace = importlib.import_module(f"{name}.core.trace")

    def mi(self, key, decision=0):
        t = self.trace
        trace = t.Trace([t.Instruction(
            "sample_categorical", [], {"candidates": [0, 1, 2, 3]},
            [t.new_expr_rv(decision)], decision)])
        return self.measure.MeasureInput(key, None, trace)

    def pool(self, **kw):
        kw.setdefault("max_workers", 2)
        kw.setdefault("timeout_s", 20.0)
        kw.setdefault("grace_s", 10.0)
        kw.setdefault("worker_fn", _keyed_worker)
        if self.name == "repro_torch":
            kw["device"] = "cpu"
        return self.measure.ProcessPoolRunner(**kw)


@pytest.fixture(scope="module")
def pkgs():
    return _Pkg("repro"), _Pkg("repro_torch")


def _results(out):
    return [(r.latency_s, r.error, r.source) for r in out]


def _stats(runner):
    return {k: v for k, v in runner.stats().items() if k not in ("backend", "device")}


def _order(p):
    r = p.pool()
    try:
        lats = [0.004, 0.001, 0.003, 0.002]
        out = r.run([p.mi(f"ok:{l}", i) for i, l in enumerate(lats)])
        assert [x.latency_s for x in out] == lats
        return _results(out), _stats(r), dict(r.crash_counts)
    finally:
        r.close()


def _timeout(p):
    r = p.pool(timeout_s=0.2, grace_s=1.5, startup_grace_s=30.0)
    try:
        r.warm(wait=True)  # charge the tight budget to candidates only
        out = r.run([p.mi("sleep", 0), p.mi("ok:0.001", 1)])
        assert out[0].source == "timeout" and "timeout" in out[0].error
        # the pool was torn down; a fresh batch must still work
        out += r.run([p.mi("ok:0.002", 2)])
        return _results(out), _stats(r), dict(r.crash_counts)
    finally:
        r.close()


def _quarantine(p):
    r = p.pool(crash_threshold=2)
    try:
        bad = p.mi("crash", 7)
        out = r.run([bad]) + r.run([bad]) + r.run([bad])  # third: quarantined
        out += r.run([p.mi("ok:0.001", 1)])  # an unrelated trace is unaffected
        assert out[2].source == "quarantine" and out[3].ok
        return _results(out), _stats(r), dict(r.crash_counts)
    finally:
        r.close()


def _mixed_batch(p):
    r = p.pool(crash_threshold=2)
    try:
        out = r.run([p.mi("ok:0.001", 1), p.mi("crash", 7), p.mi("ok:0.002", 2)])
        assert list(r.crash_counts.values()) == [1]  # only the crasher
        return _results(out), _stats(r), dict(r.crash_counts)
    finally:
        r.close()


SCENARIOS = {"order": _order, "timeout": _timeout, "quarantine": _quarantine,
             "mixed_batch": _mixed_batch}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_stub_scenario_matches_the_reference(pkgs, scenario):
    ref, port = (SCENARIOS[scenario](p) for p in pkgs)
    assert port == ref


def test_a_raising_worker_is_a_fault_not_a_rejection(pkgs):
    """The deliberate difference from the reference: a worker that raises
    (not a rejection, not a death) reaches the caller."""
    jp, tp = pkgs
    ref = jp.pool()
    try:
        out = ref.run([jp.mi("ok:0.001", 1), jp.mi("fault", 2)])
        assert out[0].latency_s == 0.001
        assert not out[1].ok and "RuntimeError" in out[1].error  # a "crash"
    finally:
        ref.close()
    port = tp.pool()
    try:
        with pytest.raises(tp.measure.MeasurementFault, match="illegal memory access"):
            port.run([tp.mi("ok:0.001", 1), tp.mi("fault", 2)])
        assert port.stats()["crashes"] == 0 and not port.quarantined
        # the pool was torn down with the fault; the next batch gets a new one
        assert port.run([tp.mi("ok:0.003", 3)])[0].latency_s == 0.003
    finally:
        port.close()


def test_measurement_fault_is_raised_by_every_runner_in_the_caller(pkgs, monkeypatch):
    """``local`` and the legacy serial runner: an error that is not a
    rejection raises; a ``ScheduleRejected`` is an ``inf`` latency."""
    from repro_torch.backends import registry
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels import ScheduleRejected
    from repro_torch.search.measure import MeasureInput, create_runner
    from repro_torch.search.runner import LocalRunner as LegacyRunner

    func = get_workload("dense", m=16, n=16, k=16)
    sch = SpaceGenerator(default_modules()).generate(func, seed=0)
    be = registry.get_backend("cuda")
    local = create_runner("local", device="cpu")
    legacy = LegacyRunner(device="cpu")
    for exc, rejected in ((ScheduleRejected("grid", "too fine"), True),
                          (RuntimeError("launch refused"), False)):
        def lower(*a, _e=exc, **k):
            raise _e

        monkeypatch.setattr(be, "lower", lower)
        if rejected:
            r = local.run([MeasureInput("dense/k=16/m=16/n=16", func, sch.trace, sch)])[0]
            assert r.latency_s == math.inf and r.error.startswith("rejected (grid)")
            r = legacy.measure(sch)
            assert r.latency_s == math.inf and r.error.startswith("rejected (grid)")
        else:
            with pytest.raises(RuntimeError, match="launch refused"):
                local.run([MeasureInput("dense/k=16/m=16/n=16", func, sch.trace, sch)])
            with pytest.raises(RuntimeError, match="launch refused"):
                legacy.measure(sch)


@pytest.mark.parametrize(
    "spec",
    ["local", "pool", "cached+pool", "pool://workers=4&timeout_s=30",
     "pool://workers=4&timeout_s=30.5&verbose=true&tag=x",
     "cached+rpc://127.0.0.1:7070,127.0.0.1:7071", "rpc://127.0.0.1:7070,7071",
     "cached+rpc://host:7070", "cached+local", "rpc://7070&timeout_s=5"],
)
def test_spec_grammar_matches_the_reference(pkgs, spec):
    jp, tp = pkgs
    assert tp.measure.parse_runner_spec(spec) == jp.measure.parse_runner_spec(spec)


def test_spec_errors_match_the_reference(pkgs):
    for p in pkgs:
        with pytest.raises(ValueError, match="malformed runner spec"):
            p.measure.parse_runner_spec("+local")
        with pytest.raises(KeyError, match="available:"):
            p.measure.create_runner("warp-drive")
        with pytest.raises(KeyError, match="wrapper"):
            p.measure.create_runner("bogus+local")
        with pytest.raises(ValueError, match="invalid options"):
            p.measure.create_runner("local://bogus_option=1")
    # the port refuses an unknown name while parsing, before any factory
    with pytest.raises(KeyError, match="available:"):
        pkgs[1].measure.parse_runner_spec("warp-drive://7070")
    assert pkgs[1].measure.runner_names() == pkgs[0].measure.runner_names()


@pytest.mark.parametrize("spec", ["pool", "pool://workers=2", "cached+pool"])
def test_pool_specs_create_with_a_device(pkgs, spec):
    tp = pkgs[1]
    # ``workers=`` in the spec is the factory's alias of ``max_workers``
    kw = {} if "workers=" in spec else {"max_workers": 1}
    r = tp.measure.create_runner(spec, device="cpu", **kw)
    try:
        pool = getattr(r, "inner", r)
        assert isinstance(pool, tp.measure.ProcessPoolRunner)
        assert pool.device == "cpu" and pool.backend == "cuda"
        assert pool.max_workers == (2 if "workers=2" in spec else 1)
    finally:
        r.close()


def test_pool_needs_a_card_when_asked_for_one(pkgs, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pkgs[1].measure.ProcessPoolRunner(max_workers=1)


def test_tune_through_the_pool_equals_local_on_the_cpu():
    """``tune_workload("dense", ...)`` through ``pool://workers=2``: the
    same workload key as ``local``, the full trial budget, and a best
    record that re-validates."""
    import repro_torch
    from repro_torch.core.validator import validate_trace
    from repro_torch.core.workloads import get_workload
    from repro_torch.search.database import Database
    from repro_torch.search.evolutionary import SearchConfig

    search = SearchConfig(max_trials=8, init_random=4, population=8,
                          measure_per_round=4, seed=0)
    out = {}
    for spec in ("local", "pool://workers=2"):
        db = Database()
        res = repro_torch.tune_workload(
            "dense", dict(m=32, n=64, k=32), database=db, device="cpu",
            config=repro_torch.TuneConfig(search=search, runner_spec=spec,
                                          warm_start=False))
        rec = db.best(res.workload_key)
        assert validate_trace(get_workload("dense", m=32, n=64, k=32), rec.trace()).ok
        assert math.isfinite(res.best_latency_s)
        out[spec] = res
    assert out["pool://workers=2"].workload_key == out["local"].workload_key
    assert out["pool://workers=2"].trials == out["local"].trials == search.max_trials
    stats = out["pool://workers=2"].runner_stats
    assert stats["measured"] >= search.max_trials
    assert (stats["timeouts"], stats["crashes"], stats["workers"]) == (0, 0, 2)


def test_legacy_serial_runner_measures_and_adapts(pkgs, monkeypatch):
    """``search/runner.py``: ``measure`` and ``baseline`` on the CPU,
    ``check_against_oracle`` against the plain version (5e-3 relative,
    1e-3 absolute, the reference's tolerance), and ``as_runner`` adapting
    it to the batch protocol in both packages."""
    from repro.search.runner import LocalRunner as JLegacy
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.search.runner import LocalRunner as TLegacy

    jp, tp = pkgs
    assert isinstance(jp.measure.as_runner(JLegacy()), jp.measure.LegacyRunnerAdapter)
    legacy = TLegacy(device="cpu", check_against_oracle=True)
    adapted = tp.measure.as_runner(legacy)
    assert isinstance(adapted, tp.measure.LegacyRunnerAdapter)
    func = get_workload("dense", m=32, n=64, k=32)
    sch = SpaceGenerator(default_modules()).generate(func, seed=0)
    res = legacy.measure(sch)
    assert res.ok and res.latency_s > 0 and res.error == ""
    assert math.isfinite(legacy.baseline(func)) and legacy.baseline(func) > 0
    (batch,) = adapted.run([tp.measure.MeasureInput("dense/k=32/m=32/n=64", func,
                                                    sch.trace)])
    assert batch.ok
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TLegacy()  # the card by default, never a quiet CPU run


def test_serialized_timing_stretches_the_batch_deadline(pkgs):
    """On a card the pool's workers time one at a time (the card's timing
    lock), so a batch whose candidates each finish well inside
    ``timeout_s`` can outlast ``timeout_s`` times the batch over the pool's
    width.  A stub worker holding a lock shared by the workers stands in
    for the card's (the CPU has none).  With ``serial_timing``, which a
    pool on a card sets, the deadline covers the whole batch and no legal
    candidate times out.  Times: each candidate holds the lock 0.6 s of a
    1.0 s timeout, the batch about 3.6 s; the deadline is 6.2 s (2.2 s by
    the pool's width)."""
    tp = pkgs[1]
    r = tp.pool(max_workers=3, timeout_s=1.0, grace_s=0.2, startup_grace_s=60.0,
                worker_fn=_turn_worker)
    assert not r.serial_timing  # a CPU pool has no timing lock
    r.serial_timing = True  # as a pool on a card
    try:
        r.warm(wait=True)  # charge the budget to the candidates only
        out = r.run([tp.mi("turn:0.6", i % 4) for i in range(6)])
        stats = r.stats()
    finally:
        r.close()
    assert [(x.latency_s, x.source) for x in out] == [(0.6, "measured")] * 6
    assert (stats["timeouts"], stats["crashes"]) == (0, 0)


def _counting_lowering(monkeypatch):
    """Make the ``cuda`` backend lower every schedule to a function that
    counts one K1 ``tc`` launch a call, as the wrapper does on a card, and
    return the wrapper."""
    from repro_torch.backends import registry
    from repro_torch.kernels import matmul as mm

    def lower(sch, workload_key=""):
        out = sch.func.outputs[0]

        def fn(ins):
            mm.matmul.launches += 1
            mm.matmul.launches_by_variant["tc"] += 1
            return {out.name: None}

        return registry.Lowered(fn, {"backend": "cuda", "pallas_kernel": "matmul"})

    monkeypatch.setattr(registry.get_backend("cuda"), "lower", lower)
    return mm.matmul


def test_timing_reads_the_launch_counters(pkgs, monkeypatch):
    """Every timing reads the wrappers' counters before and after and
    returns the launches it made in ``meta["launches"]`` — one first call,
    one warmup and three repeats here — in ``local`` and in the pool's
    worker function alike; a timing that launched nothing adds no key."""
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels import launch_counts, launches_since
    from repro_torch.search.measure import MeasureInput, create_runner
    from repro_torch.search.measure.pool import _measure_worker

    func = get_workload("dense", m=16, n=16, k=16)
    sch = SpaceGenerator(default_modules()).generate(func, seed=0)
    key = "dense/k=16/m=16/n=16"
    local = create_runner("local", device="cpu", repeats=3, warmup=1)
    (plain,) = local.run([MeasureInput(key, func, sch.trace, sch)])
    assert plain.ok and "launches" not in plain.meta  # the CPU launches no kernel

    wrapper = _counting_lowering(monkeypatch)
    before = launch_counts()
    (res,) = local.run([MeasureInput(key, func, sch.trace, sch)])
    want = {"matmul": 5, "matmul/tc": 5}
    assert res.meta["launches"] == want and res.meta["pallas_kernel"] == "matmul"
    out = _measure_worker(dict(func=func, trace_json=sch.trace.to_json(),
                               workload_key=key, backend="cuda", device="cpu",
                               repeats=3, warmup=1, timeout_s=10.0))
    assert out["meta"]["launches"] == want and "run_wall_s" in out["meta"]
    assert launches_since(before) == {"matmul": 10, "matmul/tc": 10}
    assert wrapper.launches == before["matmul"] + 10


def test_legacy_runner_checks_against_the_plain_version(pkgs, monkeypatch):
    """``check_against_oracle`` still holds a lowering's output against the
    plain version (5e-3 relative, 1e-3 absolute): a lowering that returns
    zeros fails the measurement."""
    import torch

    from repro_torch.backends import registry
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.search.runner import LocalRunner as TLegacy

    func = get_workload("dense", m=16, n=16, k=16)
    sch = SpaceGenerator(default_modules()).generate(func, seed=0)
    out = func.outputs[0]

    def lower(s, workload_key=""):
        return registry.Lowered(
            lambda ins: {out.name: torch.zeros(out.shape)}, {"backend": "cuda"})

    monkeypatch.setattr(registry.get_backend("cuda"), "lower", lower)
    with pytest.raises(AssertionError):
        TLegacy(device="cpu", check_against_oracle=True).measure(sch)
    assert TLegacy(device="cpu").measure(sch).ok  # unchecked, it is timed


def test_timing_lock_path_follows_the_lock_directory(monkeypatch, tmp_path):
    """Processes that share a card but not a temporary directory take one
    timing lock when they share ``REPRO_TIMING_LOCK_DIR``."""
    import tempfile

    from repro_torch.search.measure import local

    monkeypatch.delenv(local.LOCK_DIR_ENV, raising=False)
    default = local.timing_lock_path("GPU-1")
    assert default == os.path.join(tempfile.gettempdir(), "repro_torch-timing-GPU-1.lock")
    monkeypatch.setenv(local.LOCK_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("TMPDIR", str(tmp_path / "elsewhere"))
    assert local.timing_lock_path("GPU-1") == str(tmp_path / "repro_torch-timing-GPU-1.lock")
