"""The slice end to end on the CPU: extract -> tune -> dispatch.

Task extraction must give the reference's keys and weights (the port
records hook calls on meta tensors where the reference walks a jaxpr).
Dispatch over a database the port tuned on the CPU must hit, and the
dispatched forward must equal the plain one: in float32 on the CPU both
run the same plain PyTorch products, up to the online-vs-full softmax of
attention (rtol/atol 1e-4).
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import get_config as jcfg
from repro.integration.extract import extract_task_specs as jextract
from repro_torch.configs.base import get_config as tcfg
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.integration.extract import extract_task_specs as textract
from repro_torch.models import transformer as TT
from repro_torch.search.database import Database, TuningRecord
from repro_torch.search.evolutionary import SearchConfig

OPS = ("dense", "batch_matmul", "attention")


@pytest.mark.parametrize("arch,smoke,seq", [
    ("smollm-135m", False, 32),
    ("gemma2-2b", True, 32),
    ("qwen1.5-110b", True, 16),
])
@pytest.mark.parametrize("dispatchable_only", [False, True])
def test_extracted_keys_and_weights_match_reference(arch, smoke, seq,
                                                    dispatchable_only):
    kw = dict(batch=1, seq=seq, ops=OPS, dispatchable_only=dispatchable_only)
    want = {t.key: t.weight for t in jextract(jcfg(arch, smoke=smoke), mesh=None, **kw)}
    got = {t.key: t.weight for t in textract(tcfg(arch, smoke=smoke), **kw)}
    assert got == want
    if arch == "smollm-135m":
        assert got["dense/k=576/m=32/n=1536"] == 60
        assert got["attention/b=1/causal=1/d=64/h=9/kvh=3/s=32/softcap=0.0/window=0"] == 30


def test_extraction_refuses_ops_of_later_slices():
    with pytest.raises(NotImplementedError):
        textract(tcfg("smollm-135m", smoke=True), ops=("dense", "rmsnorm"))


@pytest.fixture(scope="module")
def tuned():
    cfg = tcfg("smollm-135m", smoke=True)
    tasks = repro_torch.extract_tasks(cfg, batch=1, seq=32, dispatchable_only=True)
    db = Database()
    search = SearchConfig(max_trials=4, init_random=2, population=4,
                          measure_per_round=2)
    sched = repro_torch.TaskScheduler(
        tasks, database=db,
        config=repro_torch.TuneConfig(search=search, runner_spec="cached+local",
                                      backend="cuda", device="cpu"),
    )
    best = sched.tune(total_rounds=len(tasks))
    return cfg, tasks, db, best


def _f32_params(cfg):
    p = TT.init_params(cfg, seed=0, device="cpu")

    def cast(t):
        return {k: cast(v) if isinstance(v, dict) else v.float() for k, v in t.items()}

    return cast(p)


def test_every_task_tunes_to_a_finite_best_with_block_provenance(tuned):
    _, tasks, db, best = tuned
    assert set(best) == {t.key for t in tasks}
    assert all(np.isfinite(v) for v in best.values())
    for t in tasks:
        meta = db.best(t.key).meta
        assert meta["backend"] == "cuda"
        assert meta["pallas_kernel"] in ("matmul", "batch_matmul", "flash_attention")
        assert "pallas_blocks_snapped" in meta


def test_dispatched_forward_hits_and_equals_plain(tuned):
    cfg, tasks, db, _ = tuned
    params = _f32_params(cfg)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (1, 32))
    )
    plain = TT.forward(cfg, params, toks)
    with DispatchContext(db, tasks=tasks) as ctx:
        out = TT.forward(cfg, params, toks)
    assert ctx.stats["hits"] > 0
    assert ctx.stats["attention_tuned"] == cfg.n_layers
    reasons = {r for row in ctx.stats_by_key().values() for r in row["reasons"]}
    assert "lowering_failed" not in reasons
    assert ctx.stats_by_key()["site:rmsnorm"]["reasons"] == {
        "not_in_slice": 2 * cfg.n_layers + 1
    }
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)


def test_untuned_attention_takes_the_default_fused_kernel():
    cfg = tcfg("smollm-135m", smoke=True)
    params = _f32_params(cfg)
    toks = torch.zeros((1, 16), dtype=torch.int64)
    plain = TT.forward(cfg, params, toks)
    with DispatchContext(Database(), tasks=[]) as ctx:
        out = TT.forward(cfg, params, toks)
    assert ctx.stats["attention_fused"] == cfg.n_layers
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)


def test_dispatched_dense_backward_is_the_plain_gradient(tuned):
    cfg, tasks, db, _ = tuned
    key = next(t.key for t in tasks if t.key.startswith("dense/k=48/m=32/n=96"))
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.standard_normal((1, 32, 48), dtype=np.float32))
    w = torch.from_numpy(r.standard_normal((48, 96), dtype=np.float32))
    x.requires_grad_(True)
    w.requires_grad_(True)
    with DispatchContext(db, tasks=tasks) as ctx:
        from repro_torch.models.layers import dense_op

        (dense_op(x, w) ** 2).sum().backward()
    assert ctx.hits_by_key[key] == 1
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    ((x @ w) ** 2).sum().backward()
    torch.testing.assert_close(gx, x.grad, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(gw, w.grad, rtol=1e-5, atol=1e-4)


def test_rejected_tile_is_a_lowering_failed_miss(tuned, monkeypatch):
    cfg, tasks, db, _ = tuned
    task = next(t for t in tasks if t.key.startswith("dense/"))
    from repro_torch.kernels import ScheduleRejected
    from repro_torch.kernels import matmul as mm

    def refuse(*a, **k):
        raise ScheduleRejected("shared_memory", "tile needs more shared memory")

    monkeypatch.setattr(mm, "launch_config", refuse)
    ctx = DispatchContext(db, tasks=[task])
    assert ctx.kernel(task.key) is None
    assert ctx.miss_reasons[task.key] == "lowering_failed"


def test_a_lowering_bug_propagates_and_is_no_miss(tuned, monkeypatch):
    """A ValueError that is not a schedule rejection (here: a shape that
    does not unpack) is a bug, and must not pass as a lowering_failed miss."""
    cfg, tasks, db, _ = tuned
    task = next(t for t in tasks if t.key.startswith("dense/"))
    from repro_torch.kernels import matmul as mm

    def bug(*a, **k):
        b, m = (1, 2, 3)  # noqa: F841  ValueError: too many values to unpack

    monkeypatch.setattr(mm, "launch_config", bug)
    ctx = DispatchContext(db, tasks=[task])
    with pytest.raises(ValueError, match="too many values"):
        ctx.kernel(task.key)
    assert task.key not in ctx.miss_reasons


def test_a_record_for_a_workload_of_a_later_slice_raises():
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.search.database import workload_key

    func = get_workload("sfm", m=16, n=16)
    key = workload_key("sfm", m=16, n=16)
    tr = SpaceGenerator(default_modules()).generate(func, seed=0).trace
    db = Database()
    db.put(TuningRecord(key, tr.to_json(), 1e-5))
    ctx = DispatchContext(db)
    if ctx._schedule_for(key, func)[0] is None:
        pytest.skip("seed 0 samples an invalid sfm trace")
    with pytest.raises(NotImplementedError):
        ctx.kernel(key)
