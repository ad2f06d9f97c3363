"""The port's search and measurement stack against the JAX package's.

The probabilistic-program language, the search and the database are
copies of the reference's framework-neutral modules, so from one seed both
packages must sample the same traces (equal ``Trace.to_json`` and equal
``structural_hash``), and a database written by either must load in the
other with the same keys, traces and latencies.  Tuning itself runs on the
CPU here, through the port's ``cuda`` backend, whose wrappers run the
kernels' plain versions for CPU tensors.
"""

import json
import math

import numpy as np
import pytest

from repro.core.modules import SpaceGenerator as JSpace
from repro.core.modules import default_modules as jmodules
from repro.core.workloads import get_workload as jget
from repro.search.database import Database as JDatabase
from repro.search.database import TuningRecord as JRecord
from repro.search.measure.hashing import structural_hash as jhash
import repro_torch
from repro_torch.core.modules import SpaceGenerator as TSpace
from repro_torch.core.modules import default_modules as tmodules
from repro_torch.core.workloads import get_workload as tget
from repro_torch.search.database import Database as TDatabase
from repro_torch.search.database import workload_key
from repro_torch.search.evolutionary import SearchConfig
from repro_torch.search.measure import create_runner, runner_names
from repro_torch.search.measure.hashing import structural_hash as thash

SMALL = SearchConfig(max_trials=6, init_random=3, population=6, measure_per_round=3)

WORKLOADS = [
    ("dense", dict(m=32, n=64, k=32)),
    ("dense", dict(m=16, n=32, k=16, epilogue="bias_relu")),
    ("batch_matmul", dict(b=2, m=16, n=16, k=16)),
    ("attention", dict(b=1, h=2, kvh=1, s=16, d=8)),
    ("gmm", dict(n=16, m=16, k=16)),
]


@pytest.mark.parametrize("mxu", [False, True])
@pytest.mark.parametrize("name,kw", WORKLOADS)
def test_same_seed_samples_the_same_traces(name, kw, mxu):
    key = workload_key(name, **kw)
    jfunc, tfunc = jget(name, **kw), tget(name, **kw)
    jspace, tspace = JSpace(jmodules(use_mxu=mxu)), TSpace(tmodules(use_mxu=mxu))
    for seed in range(3):
        jt = jspace.generate(jfunc, seed=seed).trace
        tt = tspace.generate(tfunc, seed=seed).trace
        assert tt.to_json() == jt.to_json()
        assert thash(key, tt) == jhash(key, jt)


def test_tune_workload_on_cpu_finishes_with_a_finite_best():
    r = repro_torch.tune_workload(
        "dense", m=32, n=64, k=32, device="cpu",
        config=repro_torch.TuneConfig(search=SMALL),
    )
    assert r.workload_key == "dense/k=32/m=32/n=64"
    assert math.isfinite(r.best_latency_s) and r.best_latency_s > 0
    assert math.isfinite(r.baseline_latency_s)
    assert r.backend == "cuda"
    assert r.trials > 0


def test_tune_workload_gmm_64_cubed_on_cpu_goes_through_the_structural_lowering():
    """ROADMAP's M3 acceptance run: a paper operator with no kernel tunes on
    the ``cuda`` backend through the structural fallback."""
    db = TDatabase()
    r = repro_torch.tune_workload(
        "gmm", dict(n=64, m=64, k=64), database=db, device="cpu",
        config=repro_torch.TuneConfig(
            search=SearchConfig(max_trials=4, init_random=4, population=4,
                                measure_per_round=4),
            runner_spec="cached+local", warm_start=False,
        ),
    )
    assert r.workload_key == "gmm/k=64/m=64/n=64"
    assert math.isfinite(r.best_latency_s) and math.isfinite(r.baseline_latency_s)
    assert db.best(r.workload_key).meta["lowered_with"] == "torch-fallback"


@pytest.mark.parametrize("name,kw,kernel", [
    ("rmsnorm", dict(tokens=16, d=32), None),
    ("sfm", dict(m=32, n=32), "row_softmax"),
])
def test_rmsnorm_and_sfm_records_load_in_both_packages(name, kw, kernel, tmp_path):
    from repro.core.validator import validate_trace
    from repro_torch.backends.torch_backend import build_oracle
    from repro_torch.core.tir import random_inputs

    # the port's records in the reference
    path = str(tmp_path / "port_db.json")
    db = TDatabase(path)
    repro_torch.tune_workload(
        name, kw, database=db, device="cpu",
        config=repro_torch.TuneConfig(search=SMALL, runner_spec="cached+local",
                                      warm_start=False),
    )
    db.save()
    key = workload_key(name, **kw)
    ref = JDatabase(path)
    rb = ref.best(key)
    assert rb.trace_json == db.best(key).trace_json
    assert rb.meta.get("pallas_kernel") == kernel
    assert kernel or rb.meta["lowered_with"] == "torch-fallback"
    assert validate_trace(jget(name, **kw), rb.trace()).ok
    # the reference's records in the port
    path = str(tmp_path / "ref_db.json")
    jdb = JDatabase(path)
    jfunc = jget(name, **kw)
    for seed, lat in ((0, 3e-5), (1, 2e-5)):
        tr = JSpace(jmodules()).generate(jfunc, seed=seed).trace
        jdb.put(JRecord(key, tr.to_json(), lat, meta={"backend": "jnp"}))
    jdb.save()
    tdb = TDatabase(path)
    assert tdb.best(key).latency_s == 2e-5
    _, lowered = repro_torch.apply_best(name, tdb, kw)
    import torch

    ins = {k: torch.from_numpy(v) for k, v in random_inputs(tget(name, **kw), 0).items()}
    out, want = lowered.fn(ins), build_oracle(tget(name, **kw))(ins)
    for k in want:
        np.testing.assert_allclose(out[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_port_database_loads_in_the_reference(tmp_path):
    path = str(tmp_path / "port_db.json")
    db = TDatabase(path)
    repro_torch.tune_workload(
        "batch_matmul", dict(b=2, m=16, n=16, k=16), database=db, device="cpu",
        config=repro_torch.TuneConfig(search=SMALL, runner_spec="cached+local"),
    )
    db.save()
    ref = JDatabase(path)
    assert ref.keys() == db.keys()
    key = db.keys()[0]
    tb, rb = db.best(key), ref.best(key)
    assert rb.trace_json == tb.trace_json
    assert rb.latency_s == tb.latency_s
    assert rb.meta["backend"] == "cuda"
    assert rb.meta["pallas_kernel"] == "batch_matmul"
    # the reference replays the port's trace on its own program
    from repro.core.validator import validate_trace

    assert validate_trace(jget("batch_matmul", b=2, m=16, n=16, k=16), rb.trace()).ok


def test_reference_database_loads_in_the_port(tmp_path):
    path = str(tmp_path / "ref_db.json")
    func = jget("dense", m=32, n=32, k=32)
    key = workload_key("dense", m=32, n=32, k=32)
    jdb = JDatabase(path)
    for seed, lat in ((0, 3e-5), (1, 2e-5)):
        tr = JSpace(jmodules(use_mxu=True)).generate(func, seed=seed).trace
        jdb.put(JRecord(key, tr.to_json(), lat, meta={"backend": "pallas"}))
    jdb.save()
    tdb = TDatabase(path)
    assert tdb.keys() == [key]
    assert tdb.best(key).latency_s == 2e-5
    with open(path) as f:
        assert json.load(f)  # plain JSON, the documented format
    _, lowered = repro_torch.apply_best("dense", tdb, dict(m=32, n=32, k=32))
    r = np.random.default_rng(0)
    import torch

    x = torch.from_numpy(r.standard_normal((32, 32), dtype=np.float32))
    w = torch.from_numpy(r.standard_normal((32, 32), dtype=np.float32))
    out = lowered.fn({"X": x, "W": w})["Y"]
    np.testing.assert_allclose(out.numpy(), (x @ w).numpy(), rtol=1e-5, atol=1e-5)


def test_only_local_runners_are_registered():
    # the reference's three base runners, each also under the cache wrapper
    assert runner_names() == ["local", "pool", "rpc", "cached+local",
                              "cached+pool", "cached+rpc"]
    for spec in ("warp", "warp://127.0.0.1:7070", "cached+warp"):
        with pytest.raises(KeyError, match="available: local, pool, rpc, cached"):
            create_runner(spec, device="cpu")


def test_schedule_rejection_is_inf_and_other_failures_propagate(monkeypatch):
    from repro_torch.core.schedule import Schedule
    from repro_torch.search.measure import LocalRunner, MeasureInput

    runner = LocalRunner(device="cpu")
    # a 64 x 4096 x 64 tile needs more shared memory than a CTA has
    func = tget("dense", m=64, n=4096, k=64)
    from repro_torch.backends import gpu_backend as gb

    sch = Schedule(func, seed=None)
    with monkeypatch.context() as mp:
        mp.setattr(gb, "extract_matmul_blocks", lambda s: (64, 4096, 64))
        res = runner.run([MeasureInput("k", func, sch.trace, sch)])[0]
    assert not res.ok and "shared memory" in res.error
    assert res.error.startswith("rejected (shared_memory): ")
    # a workload without a kernel is measured through the structural lowering
    gmm = tget("gmm", n=16, m=16, k=16)
    gs = Schedule(gmm, seed=None)
    res = runner.run([MeasureInput("g", gmm, gs.trace, gs)])[0]
    assert res.ok and math.isfinite(res.latency_s)
    assert res.meta == {"backend": "cuda", "lowered_with": "torch-fallback"}
    # ... and a failure inside it propagates like any other
    from repro_torch.backends import torch_backend as tb

    with monkeypatch.context() as mp:
        mp.setattr(tb, "build", lambda s: 1 / 0)
        with pytest.raises(ZeroDivisionError):
            runner.run([MeasureInput("g", gmm, gs.trace, gs)])


@pytest.mark.parametrize("reason,blocks", [
    ("shared_memory", (64, 4096, 64)),
    ("threads", (4096, 4096, 1)),
    ("grid", (1, 1, 1)),
])
def test_each_cap_is_a_rejection_with_its_reason(reason, blocks, monkeypatch):
    from repro_torch.backends import gpu_backend as gb
    from repro_torch.core.schedule import Schedule
    from repro_torch.kernels import ScheduleRejected

    monkeypatch.setattr(gb, "extract_matmul_blocks", lambda s: blocks)
    sch = Schedule(tget("dense", m=4096, n=4096, k=64), seed=None)
    with pytest.raises(ScheduleRejected) as e:
        gb.lower_dense(sch)
    assert e.value.reason == reason


def test_a_lowering_bug_is_not_a_rejected_candidate(monkeypatch):
    """A ValueError that is not a ScheduleRejected is a bug in the lowering:
    the runner lets it propagate instead of scoring the candidate inf."""
    from repro_torch.core.schedule import Schedule
    from repro_torch.search.measure import LocalRunner, MeasureInput
    from repro_torch.backends import gpu_backend as gb

    def bug(sch):
        raise ValueError("not enough values to unpack")

    monkeypatch.setattr(gb, "extract_matmul_blocks", bug)
    func = tget("dense", m=32, n=32, k=32)
    sch = Schedule(func, seed=None)
    with pytest.raises(ValueError, match="not enough values"):
        LocalRunner(device="cpu").run([MeasureInput("k", func, sch.trace, sch)])


def test_runner_specs_take_only_key_value_options():
    from repro_torch.search.measure import parse_runner_spec

    assert parse_runner_spec("cached+local://repeats=5&device=cpu") == (
        ["cached"], "local", {"repeats": 5, "device": "cpu"})
    # a bare segment is an address, as in the reference's grammar; a runner
    # that takes no address refuses it when it is created
    assert parse_runner_spec("local://127.0.0.1:7070") == (
        [], "local", {"address": "127.0.0.1:7070"})
    with pytest.raises(ValueError, match="invalid options"):
        create_runner("local://127.0.0.1:7070", device="cpu")


def test_tune_config_is_the_only_way_in():
    tasks = []
    with pytest.raises(TypeError):
        repro_torch.TaskScheduler(tasks, runner="local")
    with pytest.raises(TypeError, match="must be a TuneConfig"):
        repro_torch.tune_workload("dense", m=32, n=32, k=32, device="cpu",
                                  config=SMALL)
    with pytest.raises(TypeError, match="as a Runner"):
        repro_torch.as_runner(object(), device="cpu")


def test_backend_none_is_cuda_and_reads_no_environment(monkeypatch):
    from repro_torch.backends import DEFAULT_BACKEND, get_backend

    monkeypatch.setenv("REPRO_TORCH_BACKEND", "jnp")
    assert DEFAULT_BACKEND == "cuda"
    assert get_backend(None).name == "cuda"
