"""Mesh-aware extraction and dispatch against the JAX package's.

Extraction under a mesh (``shard_sites``) must give the reference's
per-shard keys and weights exactly: smollm-135m at full width on a (data
2, model 3) mesh (the 9 keys the card serves), olmoe and whisper at smoke
size, and decode extraction.  Dispatch under a 2-device mesh (a data mesh
and a (data 1, model 2) mesh) must give the reference's outputs and
gradients (float32, rtol/atol 1e-5), ``stats`` and per-key notes exactly:
the reference runs in a subprocess on 2 fake CPU devices, the port on a
logical mesh that holds the CPU twice.  A missing per-shard record falls
back to the global one; the attention servability guard
(``MAX_STRUCTURAL_ATTN_SCORE_BYTES``) holds on the global and the mesh
path; a kernel error under the mesh propagates, a ``ScheduleRejected``
at launch too (the port's rule; the reference would note
``mesh_error``), while a per-shard schedule rejected at lowering is a
``mesh_error`` fallback to the global key."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs.base import get_config as jcfg
from repro.integration.extract import extract_decode_task_specs as jdecode
from repro.integration.extract import extract_task_specs as jextract
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.modules import SpaceGenerator, default_modules
from repro_torch.core.validator import validate_trace
from repro_torch.core.workloads import get_workload
from repro_torch.distributed import sharding as shd
from repro_torch.integration import dispatch as D
from repro_torch.integration.extract import (
    TaskSite, _resolve_mesh, extract_decode_task_specs, extract_task_specs,
    shard_sites)
from repro_torch.kernels import ScheduleRejected
from repro_torch.search.database import Database, TuningRecord, workload_key

TOL = dict(rtol=1e-5, atol=1e-5)

SMOLLM_MESH_KEYS = {
    "dense/k=576/m=256/n=512": 60,
    "dense/k=576/m=256/n=16384": 1,
    "dense/k=1536/m=256/n=192": 30,
    "dense/k=576/m=256/n=192": 60,
    "dense/k=576/m=256/n=64": 60,
    "attention/b=1/causal=1/d=64/h=3/kvh=1/s=256/softcap=0.0/window=0": 30,
    "batch_matmul/b=2/k=256/m=768/n=64": 30,
    "batch_matmul/b=2/k=64/m=768/n=256": 30,
    "rmsnorm/d=576/eps=1e-06/tokens=512": 61,
}


def meshes(shape, axes):
    """The reference's abstract mesh (Auto axes) and the port's."""
    return (AbstractMesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes)),
            shd.Mesh(None, axes, shape))


def weights(tasks):
    return {t.key: t.weight for t in tasks}


@pytest.mark.parametrize("dispatchable_only", [True, False])
def test_smollm_full_width_extraction_under_the_mesh(dispatchable_only):
    jm, tm = meshes((2, 3), ("data", "model"))
    kw = dict(batch=2, seq=256, dispatchable_only=dispatchable_only)
    want = weights(jextract(jcfg("smollm-135m"), mesh=jm, **kw))
    got = weights(extract_task_specs(tcfg("smollm-135m"), mesh=tm, **kw))
    assert got == want
    if dispatchable_only:
        assert got == SMOLLM_MESH_KEYS
    with shd.use_mesh(tm):  # mesh="auto" reads the active mesh
        assert weights(extract_task_specs(tcfg("smollm-135m"), **kw)) == want
    assert weights(extract_task_specs(tcfg("smollm-135m"), mesh=None, **kw)) == \
        weights(jextract(jcfg("smollm-135m"), mesh=None, **kw))


@pytest.mark.parametrize("arch,shape,axes", [
    ("olmoe-1b-7b", (2, 2), ("data", "model")),
    ("olmoe-1b-7b", (2,), ("model",)),
    ("whisper-medium", (2, 2), ("data", "model")),
    ("smollm-135m", (2, 2, 3), ("pod", "data", "model")),
])
def test_smoke_extraction_under_a_mesh(arch, shape, axes):
    jm, tm = meshes(shape, axes)
    for dispatchable_only in (True, False):
        kw = dict(batch=4, seq=32, dispatchable_only=dispatchable_only,
                  min_task_elems=16)
        assert weights(extract_task_specs(tcfg(arch, smoke=True), mesh=tm, **kw)) == \
            weights(jextract(jcfg(arch, smoke=True), mesh=jm, **kw))


@pytest.mark.parametrize("smoke,seq", [(True, 32), (False, 1500)])
def test_square_cross_attention_weight_matches_reference(smoke, seq):
    """At seq == the encoder's frames whisper's cross-attention is square
    and reaches the attention task: the reference weighs it by the
    encoder's layers, as an encoder record (the parent port halved the
    task's weight)."""
    kw = dict(batch=1, seq=seq, min_task_elems=16, mesh=None)
    assert weights(extract_task_specs(tcfg("whisper-medium", smoke=smoke), **kw)) == \
        weights(jextract(jcfg("whisper-medium", smoke=smoke), **kw))


@pytest.mark.parametrize("arch,kw", [
    ("smollm-135m", dict(batch=4, max_seq=64)),
    ("smollm-135m", dict(batch=4, max_seq=64, chunk=8, paged=True)),
    ("olmoe-1b-7b", dict(batch=4, max_seq=64)),
])
def test_decode_extraction_under_a_mesh(arch, kw):
    jm, tm = meshes((2, 2), ("data", "model"))
    assert weights(extract_decode_task_specs(tcfg(arch, smoke=True), mesh=tm, **kw)) == \
        weights(jdecode(jcfg(arch, smoke=True), mesh=jm, **kw))


def test_shard_sites_rewrites_counts_and_traces():
    from repro_torch.obs import RingBufferSink, configure_tracing, disable_tracing, metrics

    _, tm = meshes((2, 2), ("data", "model"))
    sites = [TaskSite("dense", dict(m=64, n=64, k=32), count=3.0, dispatchable=True),
             TaskSite("rmsnorm", dict(tokens=64, d=64, eps=1e-6), count=1.0)]
    before = metrics().get_counter("extract.shard", op="dense")
    sink = RingBufferSink()
    configure_tracing(sink)
    try:
        out = shard_sites(sites, tm)
    finally:
        disable_tracing()
    assert out[0].kwargs == dict(m=32, n=32, k=32)
    assert out[0].count == 3.0 and out[0].dispatchable
    assert out[1] is sites[1]  # rmsnorm: not mesh-servable, unchanged
    assert metrics().get_counter("extract.shard", op="dense") == before + 1
    (ev,) = sink.of_type("extract.shard")
    assert ev["shard_kwargs"] == dict(m=32, n=32, k=32)
    assert ev["axes"] == {"m": ["data"], "n": "model"}
    assert shard_sites(sites, None) == sites
    assert _resolve_mesh("auto") is None and _resolve_mesh(None) is None
    with shd.use_mesh(tm):
        assert _resolve_mesh("auto") is tm
        assert _resolve_mesh(None) is None


# ---------------------------------------------------------------------------
# dispatch under a 2-device mesh, against the reference on 2 fake devices
# ---------------------------------------------------------------------------


def valid_trace(op, kw):
    func = get_workload(op, **kw)
    gen = SpaceGenerator(default_modules(use_mxu=False))
    for seed in range(32):
        tr = gen.generate(func, seed=seed).trace
        if validate_trace(func, tr).ok:
            return tr.to_json()
    raise AssertionError(f"no valid schedule for {op} {kw}")


def _inputs(op, rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if op == "dense":
        return [f(2, 32, 16), f(16, 32)]
    if op == "dense_t":
        return [f(2, 32, 16), f(32, 16)]
    if op == "batch_matmul":
        return [f(4, 16, 8), f(4, 8, 16)]
    return [f(2, 4, 16, 8), f(2, 2, 16, 8), f(2, 2, 16, 8)]


def _global_kwargs(op):
    if op in ("dense", "dense_t"):
        return "dense", dict(m=64, n=32, k=16)
    if op == "batch_matmul":
        return "batch_matmul", dict(b=4, m=16, n=16, k=8)
    return "attention", dict(b=2, h=4, kvh=2, s=16, d=8, causal=1, window=0,
                             softcap=0.0)


MESH_AXES = {"data": ((2,), ("data",)), "model": ((1, 2), ("data", "model"))}
# (name, op, mesh, which records: per-shard, global or both)
DISPATCH_CASES = [
    ("dense_data", "dense", "data", "shard"),
    ("dense_model", "dense", "model", "shard"),
    ("dense_t_model", "dense_t", "model", "shard"),
    ("bmm_data", "batch_matmul", "data", "shard"),
    ("bmm_model", "batch_matmul", "model", "shard"),
    ("attn_data", "attention", "data", "shard"),
    ("attn_model", "attention", "model", "shard"),
    ("dense_missing_shard", "dense", "data", "global"),
    ("attn_missing_shard", "attention", "model", "global"),
]

_REF_SCRIPT = r"""
import json, sys, time
import jax, numpy as np, jax.numpy as jnp
assert len(jax.devices()) == 2, jax.devices()
from jax.sharding import Mesh
from repro.distributed.sharding import use_mesh
from repro.search.database import Database, TuningRecord
from repro.integration.dispatch import DispatchContext

spec = json.load(open(sys.argv[1]))
out = {}
for case in spec["cases"]:
    db = Database(None)
    for key, tr in case["records"].items():
        db.put(TuningRecord(key, tr, 1e-6, time.time()))
    ctx = DispatchContext(db, backend=case["backend"])
    shape, axes = case["mesh"]
    mesh = Mesh(np.array(jax.devices()).reshape(shape), tuple(axes))
    ins = [jnp.asarray(np.load(p)) for p in case["inputs"]]
    op = case["op"]

    def call(*a):
        if op == "dense":
            return ctx.dense(*a)
        if op == "dense_t":
            return ctx.dense(*a, transpose_w=True)
        if op == "batch_matmul":
            return ctx.batch_matmul(*a)
        return ctx.attention(*a, causal=True)

    with use_mesh(mesh):
        y = call(*ins)
        res = {"none": y is None, "stats": dict(ctx.stats),
               "by_key": ctx.stats_by_key()}
        if y is not None:
            np.save(case["prefix"] + "_out.npy", np.asarray(y, np.float32))
            gs = jax.grad(lambda *a: call(*a).astype(jnp.float32).sum(),
                          argnums=tuple(range(len(ins))))(*ins)
            for i, g in enumerate(gs):
                np.save(case["prefix"] + f"_g{i}.npy", np.asarray(g, np.float32))
    out[case["name"]] = res
print(json.dumps(out))
"""


def run_reference(tmp_path, cases):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"cases": cases}))
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(spec)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def port_call(ctx, op, ins):
    if op == "dense":
        return ctx.dense(*ins)
    if op == "dense_t":
        return ctx.dense(*ins, transpose_w=True)
    if op == "batch_matmul":
        return ctx.batch_matmul(*ins)
    return ctx.attention(*ins, causal=True)


def cpu_mesh(name):
    shape, axes = MESH_AXES[name]
    return shd.Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape),
                    axes)


def test_dispatch_under_a_two_device_mesh_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    cases, port = [], {}
    for name, op, mesh_name, which in DISPATCH_CASES:
        wl, kw = _global_kwargs(op)
        shape, axes = MESH_AXES[mesh_name]
        sw = shd.shard_workload(wl, kw, shd.Mesh(None, axes, shape))
        assert sw is not None and sw.kwargs != kw, name
        use = sw.kwargs if which == "shard" else kw
        records = {workload_key(wl, **use): valid_trace(wl, use)}
        arrays = _inputs(op, rng)
        paths = []
        for i, a in enumerate(arrays):
            paths.append(str(tmp_path / f"{name}_in{i}.npy"))
            np.save(paths[-1], a)
        cases.append(dict(name=name, op=op, mesh=[list(shape), list(axes)],
                          records=records, inputs=paths, backend="jnp",
                          prefix=str(tmp_path / name)))
        db = Database()
        for key, tr in records.items():
            db.put(TuningRecord(key, tr, 1e-6))
        ctx = D.DispatchContext(db)  # the cuda backend: CPU tensors run plain
        ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        with shd.use_mesh(cpu_mesh(mesh_name)):
            y = port_call(ctx, op, ins)
            y.float().sum().backward()
        port[name] = (y.detach(), [t.grad for t in ins], dict(ctx.stats),
                      ctx.stats_by_key())
    ref = run_reference(tmp_path, cases)
    for name, op, mesh_name, which in DISPATCH_CASES:
        y, grads, stats, by_key = port[name]
        want = ref[name]
        assert not want["none"], name
        torch.testing.assert_close(y, torch.from_numpy(np.load(tmp_path / f"{name}_out.npy")),
                                   **TOL)
        for i, g in enumerate(grads):
            torch.testing.assert_close(
                g, torch.from_numpy(np.load(tmp_path / f"{name}_g{i}.npy")), **TOL)
        assert stats == want["stats"], name
        assert by_key == want["by_key"], name
        if which == "shard":
            assert stats["mesh_sharded"] == 1
        else:  # no per-shard record: the global record serves
            assert stats["mesh_sharded"] == 0 and stats["hits"] == 1


# the attention servability guard: at b1 h16 s2048 the (b, h, s, s) f32
# score buffer is exactly the cap (served); at s2049 it crosses it
GUARD_S = 2049


def _guard_context(monkeypatch, kw, backend="torch"):
    key = workload_key("attention", **kw)
    db = Database()
    db.put(TuningRecord(key, valid_trace("attention", kw), 1e-6))
    ctx = D.DispatchContext(db, backend=backend)
    kern = ctx.kernel(key)
    assert kern is not None

    def never(_):
        raise AssertionError("a structurally lowered attention over the cap was served")

    monkeypatch.setattr(kern, "fn", never)
    return ctx, key


def _attn_inputs(b, h, s, d=8):
    q = torch.zeros((b, h, s, d))
    return q, torch.zeros((b, h, s, d)), torch.zeros((b, h, s, d))


def test_attention_guard_on_the_mesh_path_matches_reference(monkeypatch, tmp_path):
    """32 heads over model 2: the per-shard key (16 heads) crosses the cap,
    so the mesh path notes ``unservable`` and the global key (no record)
    misses, in both packages."""
    kw = dict(b=1, h=32, kvh=32, s=GUARD_S, d=8, causal=1, window=0, softcap=0.0)
    shard_kw = dict(kw, h=16, kvh=16)
    ctx, key = _guard_context(monkeypatch, shard_kw)
    with shd.use_mesh(cpu_mesh("model")):
        assert ctx.attention(*_attn_inputs(1, 32, GUARD_S), causal=True) is None
    paths = []
    for i, a in enumerate(_attn_inputs(1, 32, GUARD_S)):
        paths.append(str(tmp_path / f"guard_in{i}.npy"))
        np.save(paths[-1], a.numpy())
    ref = run_reference(tmp_path, [dict(
        name="guard", op="attention", mesh=[[1, 2], ["data", "model"]],
        records={key: valid_trace("attention", shard_kw)}, inputs=paths,
        backend="jnp", prefix=str(tmp_path / "guard"))])["guard"]
    assert ref["none"]
    assert ctx.stats == ref["stats"]
    assert ctx.stats_by_key() == ref["by_key"]
    assert ctx.stats_by_key()[key]["reasons"] == {"unservable": 1}


def test_kernel_error_under_the_mesh_propagates(monkeypatch):
    kw = dict(m=32, n=32, k=16)
    key = workload_key("dense", **kw)
    db = Database()
    db.put(TuningRecord(key, valid_trace("dense", kw), 1e-6))
    x, w = torch.randn(2, 32, 16), torch.randn(16, 32)
    ctx = D.DispatchContext(db)
    kern = ctx.kernel(key)

    def broken(_):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(kern, "fn", broken)
    with shd.use_mesh(cpu_mesh("data")), pytest.raises(RuntimeError, match="kernel failed"):
        ctx.dense(x, w)
    assert ctx.stats["hits"] == 0 and ctx.stats["mesh_sharded"] == 0

    def rejected(_):
        raise ScheduleRejected("grid", "too many steps")

    # a rejection at launch, after the kernel was lowered, is no fallback
    monkeypatch.setattr(kern, "fn", rejected)
    with shd.use_mesh(cpu_mesh("data")), pytest.raises(ScheduleRejected):
        ctx.dense(x, w)
    assert ctx.stats["hits"] == 0 and ctx.stats["misses"] == 0
    assert ctx.stats["mesh_sharded"] == 0


def test_a_per_shard_schedule_rejected_at_lowering_is_a_mesh_error(monkeypatch):
    """The per-shard record's schedule is rejected when it is lowered: the
    mesh path notes ``mesh_error`` under the per-shard key and the call
    falls through to the global key, which the context does not know and
    misses."""
    kw = dict(m=32, n=32, k=16)
    key = workload_key("dense", **kw)
    db = Database()
    db.put(TuningRecord(key, valid_trace("dense", kw), 1e-6))
    x, w = torch.randn(2, 32, 16), torch.randn(16, 32)

    class Rejecting:
        def lower(self, sch, workload_key=None):
            raise ScheduleRejected("grid", "too many steps")

    monkeypatch.setattr(D, "get_backend", lambda name: Rejecting())
    ctx = D.DispatchContext(db)
    with shd.use_mesh(cpu_mesh("data")):
        assert ctx.dense(x, w) is None
    assert ctx.miss_reasons[key] == "lowering_failed"
    assert ctx.stats_by_key()[key]["reasons"] == {"mesh_error": 1}
    global_key = workload_key("dense", m=64, n=32, k=16)
    assert ctx.stats_by_key()[global_key]["reasons"] == {"unknown_key": 1}
    assert ctx.stats["misses"] == 1 and ctx.stats["mesh_sharded"] == 0


def test_dispatched_loss_and_gradients_under_the_mesh_equal_plain():
    """smollm-smoke's loss under a (data 2, model 3) logical mesh with every
    per-shard key tuned equals the plain loss (float32, 1e-5 relative), and
    so does every gradient leaf (1e-5 of its max |g|).  The backward runs
    after both the context and the mesh are left, so remat's recompute must
    re-enter both: it hits the same per-shard keys again (the unembed is
    not recomputed)."""
    import dataclasses

    from repro_torch.models import transformer as TT
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = dataclasses.replace(tcfg("smollm-135m", smoke=True), dtype="float32")
    mesh = shd.Mesh(np.array(["cpu"] * 6, dtype=object).reshape(2, 3), ("data", "model"))
    B, S = 2, 16
    tasks = extract_task_specs(cfg, batch=B, seq=S, min_task_elems=16,
                               dispatchable_only=True, mesh=mesh)
    db = Database()
    for t in tasks:
        db.put(TuningRecord(t.key, valid_trace(t.op, t.kwargs), 1e-6))
    params = tree_map(lambda t: t.float(), TT.init_params(cfg, seed=0, device="cpu"))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S + 1), generator=g)}
    ctx = D.DispatchContext(db)
    with ctx, shd.use_mesh(mesh):
        loss = TT.loss_fn(cfg, params, batch)
    forward_sharded = ctx.stats["mesh_sharded"]
    assert forward_sharded > 0 and ctx.stats["misses"] == 0
    got = torch.autograd.grad(loss, leaves)
    # the recompute hits the per-shard keys again, with no miss; PyTorch's
    # checkpoint stops a layer's recompute once its last saved tensor is
    # packed, inside the layer's last dense, before that call counts its hit
    assert ctx.stats["misses"] == 0
    assert ctx.stats["mesh_sharded"] - forward_sharded == forward_sharded - 1 - cfg.n_layers
    plain = TT.loss_fn(cfg, params, batch)
    want = torch.autograd.grad(plain, leaves)
    assert abs(float(loss) - float(plain)) <= 1e-5 * abs(float(plain))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
