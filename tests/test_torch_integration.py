"""The slice end to end on the CPU: extract -> tune -> dispatch.

Task extraction must give the reference's keys and weights (the port
records hook calls on meta tensors where the reference walks a jaxpr).
Dispatch over a database the port tuned on the CPU must hit, and the
dispatched forward must equal the plain one: in float32 on the CPU both
run the same plain PyTorch products, up to the online-vs-full softmax of
attention (rtol/atol 1e-4).  The rmsnorm sites dispatch through the
structural lowering; with the same stored trace in both packages' databases
the dispatched smoke forward and its gradient equal the reference's
(float32, rtol/atol 1e-4 on logits of order 1, 1e-4 on gradients).
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro.configs.base import get_config as jcfg
from repro.integration.extract import DECODE_EXTRACTABLE_OPS as JDECODE_OPS
from repro.integration.extract import EXTRACTABLE_OPS as JOPS
from repro.integration.extract import extract_decode_task_specs as jextract_decode
from repro.integration.extract import extract_task_specs as jextract
from repro_torch.configs.base import get_config as tcfg
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.integration.extract import extract_decode_task_specs as textract_decode
from repro_torch.integration.extract import extract_task_specs as textract
from repro_torch.models import transformer as TT
from repro_torch.search.database import Database, TuningRecord
from repro_torch.search.evolutionary import SearchConfig

OPS = JOPS  # every op the reference extracts


@pytest.mark.parametrize("arch,smoke,seq", [
    ("smollm-135m", False, 32),
    ("smollm-135m", False, 256),
    ("gemma2-2b", True, 32),
    ("gemma2-2b", True, 1100),  # seq > the 1024 kv chunk: two chunk steps
    ("qwen1.5-110b", True, 16),
    ("whisper-medium", False, 256),
    ("whisper-medium", True, 16),
    ("qwen2-vl-2b", False, 256),
    ("qwen2-vl-2b", True, 16),
])
@pytest.mark.parametrize("dispatchable_only", [False, True])
def test_extracted_keys_and_weights_match_reference(arch, smoke, seq,
                                                    dispatchable_only):
    kw = dict(batch=1, seq=seq, ops=OPS, dispatchable_only=dispatchable_only)
    want = {t.key: t.weight for t in jextract(jcfg(arch, smoke=smoke), mesh=None, **kw)}
    got = {t.key: t.weight for t in textract(tcfg(arch, smoke=smoke), **kw)}
    assert got == want
    if arch == "smollm-135m" and seq == 32:
        assert got["dense/k=576/m=32/n=1536"] == 60
        assert got["attention/b=1/causal=1/d=64/h=9/kvh=3/s=32/softcap=0.0/window=0"] == 30
    if arch == "smollm-135m" and seq == 256:
        assert len(got) == (9 if dispatchable_only else 10)
        assert got["rmsnorm/d=576/eps=1e-06/tokens=256"] == 61
        assert got.get("sfm/m=2304/n=256") == (None if dispatchable_only else 30)
    if seq == 1100:
        assert got.get("sfm/m=4400/n=1024") == (None if dispatchable_only else 4)
    if not smoke and arch == "whisper-medium":
        assert len(got) == (17 if dispatchable_only else 20)
        # the encoder's 24 non-causal layers at the 1500 frames; q/k/v of the
        # cross-attention are plain einsums, found at m1500 (k, v) and m256 (q)
        assert got["attention/b=1/causal=0/d=64/h=16/kvh=16/s=1500/softcap=0.0/window=0"] == 24
        assert got["dense/k=1024/m=1500/n=1024"] == got["dense/k=1024/m=256/n=1024"] == 144
        assert got["batch_matmul/b=16/k=64/m=256/n=1024"] == 48
        assert got["rmsnorm/d=1024/eps=1e-06/tokens=1500"] == 49
        assert got["rmsnorm/d=1024/eps=1e-06/tokens=256"] == 73
    if not smoke and arch == "qwen2-vl-2b":
        assert len(got) == (9 if dispatchable_only else 10)
        assert got["attention/b=1/causal=1/d=128/h=12/kvh=2/s=256/softcap=0.0/window=0"] == 28


def test_extraction_refuses_ops_of_later_slices():
    """Every op the reference extracts is extracted now: rmsnorm sites are
    dispatchable, sfm sites a tuning target only, as in the reference."""
    from repro_torch.integration.extract import EXTRACTABLE_OPS

    assert EXTRACTABLE_OPS == JOPS
    specs = textract(tcfg("smollm-135m", smoke=True), ops=("dense", "rmsnorm", "sfm"))
    by_op = {t.op: t for t in specs}
    assert by_op["rmsnorm"].dispatchable and by_op["rmsnorm"].weight == 5
    assert not by_op["sfm"].dispatchable


@pytest.mark.parametrize("chunk,want", [
    (0, {"sfm/m=6/n=32": 2}),
    # the serve tick's softmax over the cache, B·H·chunk rows
    (8, {"sfm/m=6/n=32": 2, "sfm/m=48/n=32": 2}),
])
def test_decode_extraction_finds_the_cache_softmax_sites(chunk, want):
    """``decode_attention``'s plain softmax is an sfm site (m = B·H at a
    decode step, B·H·chunk at a serve tick; n = T), as the reference's
    jaxpr walk finds its ``exp``: keys, weights, structural hashes and
    dispatchability equal."""
    kw = dict(batch=2, max_seq=32, ops=("sfm",), min_task_elems=1, chunk=chunk)
    ref = jextract_decode(jcfg("smollm-135m", smoke=True), mesh=None, **kw)
    got = textract_decode(tcfg("smollm-135m", smoke=True), **kw)
    assert {t.key: t.weight for t in got} == {t.key: t.weight for t in ref} == want
    assert [(t.key, t.struct_hash, t.dispatchable) for t in got] == \
        [(t.key, t.struct_hash, t.dispatchable) for t in ref]


def _chip_smoke():
    """``chip_smoke.py`` as a module, for the depths and tiers it drives."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
PAGED = dict(paged=True, chunk=CS.SERVE_CHUNK, page_size=CS.SERVE_PAGE)
# the serving paths chip_smoke.py drives: (arch, layers, the extraction's
# kwargs); smollm-135m serves at its full 30 layers
SERVING_PATHS = [
    ("smollm-135m", 30, dict(PAGED, dispatchable_only=True)),
    ("olmoe-1b-7b", CS.MOE_LAYERS, PAGED),
    ("qwen2-vl-2b", CS.VL_LAYERS, dict()),
    ("gemma2-2b", CS.GEMMA_LAYERS, PAGED),
    ("whisper-medium", CS.WHISPER_LAYERS, dict()),
    ("mamba2-370m", CS.SSM_LAYERS, dict()),
]


@pytest.mark.parametrize("arch,layers,kw", SERVING_PATHS)
def test_decode_extraction_default_ops_leave_the_softmax_out(arch, layers, kw):
    """With the default ops (no sfm in either package) the cache softmax's
    sites change no key or weight of a serving path: each of
    ``chip_smoke.py``'s decode extractions equals the reference's."""
    import dataclasses

    from repro_torch.integration.extract import DECODE_EXTRACTABLE_OPS

    assert "sfm" not in DECODE_EXTRACTABLE_OPS and DECODE_EXTRACTABLE_OPS == JDECODE_OPS
    jc, tc = jcfg(arch), tcfg(arch)
    jc = dataclasses.replace(jc, n_layers=layers, enc_layers=layers if jc.enc_layers else 0)
    tc = dataclasses.replace(tc, n_layers=layers, enc_layers=layers if tc.enc_layers else 0)
    kw = dict(kw, batch=CS.SERVE_SLOTS, max_seq=CS.SERVE_MAX_SEQ)
    want = {t.key: t.weight for t in jextract_decode(jc, mesh=None, **kw)}
    got = {t.key: t.weight for t in textract_decode(tc, **kw)}
    assert got == want and not any(k.startswith("sfm/") for k in got)


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
    assert "lowering_failed" not in reasons and "not_in_slice" not in reasons
    # the smoke norm (32 x 48) is below min_task_elems, so extraction made
    # no task for it: its sites look the key up and miss, as in the
    # reference; test_rmsnorm_dispatch_... serves one
    norm_rows = [row for row in ctx.stats_by_key().values()
                 if row["site"] == "rmsnorm"]
    assert [row["reasons"] for row in norm_rows] == [
        {"unknown_key": 2 * cfg.n_layers + 1}
    ]
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
    """An sfm record lowers to K4 now (its plain version on the CPU)."""
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.workloads import get_workload
    from repro_torch.kernels import ref as kref
    from repro_torch.search.database import workload_key

    func = get_workload("sfm", m=16, n=16)
    key = workload_key("sfm", m=16, n=16)
    tr = SpaceGenerator(default_modules()).generate(func, seed=0).trace
    db = Database()
    db.put(TuningRecord(key, tr.to_json(), 1e-5))
    ctx = DispatchContext(db)
    assert ctx._schedule_for(key, func)[0] is not None
    kern = ctx.kernel(key)
    assert kern.meta["pallas_kernel"] == "row_softmax"
    assert "lowered_with" not in kern.meta
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((16, 16),
                                                                  dtype=np.float32))
    torch.testing.assert_close(kern.fn({"A": x})["Y"], kref.row_softmax(x))


def test_rmsnorm_dispatch_matches_the_reference_forward_and_gradient():
    import jax
    import jax.numpy as jnp

    from repro.core.modules import SpaceGenerator, default_modules
    from repro.core.workloads import get_workload as jget
    from repro.integration.dispatch import DispatchContext as JDispatch
    from repro.models import transformer as JT
    from repro.search.database import Database as JDatabase
    from repro.search.database import TuningRecord as JRecord
    from repro_torch.core.workloads import get_workload as tget
    from repro_torch.models.convert import params_from_jax
    from repro_torch.search.database import workload_key

    jc, tc = jcfg("smollm-135m", smoke=True), tcfg("smollm-135m", smoke=True)
    S = 16
    kw = dict(tokens=S, d=jc.d_model, eps=jc.norm_eps)
    key = workload_key("rmsnorm", **kw)
    tr = SpaceGenerator(default_modules()).generate(jget("rmsnorm", **kw), seed=2).trace
    jdb, tdb = JDatabase(), Database()
    jdb.put(JRecord(key, tr.to_json(), 1e-5))
    tdb.put(TuningRecord(key, tr.to_json(), 1e-5))
    jtask = type("T", (), dict(key=key, func=jget("rmsnorm", **kw)))
    ttask = type("T", (), dict(key=key, func=tget("rmsnorm", **kw)))

    jparams = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), JT.init_params(jc, jax.random.PRNGKey(0))
    )
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")
    r = np.random.default_rng(1)
    toks = r.integers(0, jc.vocab, (1, S)).astype(np.int32)
    proj = r.standard_normal((1, S, jc.vocab)).astype(np.float32)

    def jloss(p):
        with JDispatch(jdb, tasks=[jtask], backend="jnp"):
            logits = JT.forward(jc, p, tokens=jnp.asarray(toks))
        return (logits * proj).sum(), logits

    (_, jlogits), jgrad = jax.value_and_grad(jloss, has_aux=True)(jparams)

    ln = [tparams["final_ln"], tparams["layers"]["ln1"], tparams["layers"]["ln2"]]
    for t in ln:
        t.requires_grad_(True)
    with DispatchContext(tdb, tasks=[ttask]) as ctx:
        logits = TT.forward(tc, tparams, torch.from_numpy(toks).long())
    (logits * torch.from_numpy(proj)).sum().backward()
    assert ctx.hits_by_key[key] == 2 * tc.n_layers + 1
    assert ctx.kernel(key).meta == {"backend": "cuda", "lowered_with": "torch-fallback"}
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    want = [jgrad["final_ln"], jgrad["layers"]["ln1"], jgrad["layers"]["ln2"]]
    for t, g in zip(ln, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-4)
