"""The port's decode path against the JAX package's, on the CPU.

K5 and K6 (``decode_flash_attention`` / ``paged_decode_flash_attention``):
on the CPU each wrapper runs its plain PyTorch version, held against the
Pallas kernels in interpret mode on the same seeded numpy inputs, float32,
atol/rtol 2e-6 (online vs whole-row softmax, different summation orders);
their launch plans (the split of the kv axis against the SM count) as
pure functions.
Above them: the decode lowering's snapped tiles and provenance meta against
``pallas_backend``'s, the model layer ``decode_attention`` (single token and
chunk staircase, with and without a window; rtol/atol 1e-5), its dispatch
through ``DispatchContext`` over a database the port tuned, and decode-task
extraction, whose keys and weights must equal the reference's.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.backends import pallas_backend as pb
from repro.configs.base import get_config as jcfg
from repro.core.modules import SpaceGenerator, default_modules
from repro.core.tir import random_inputs
from repro.core.validator import validate_trace as jvalidate
from repro.core.workloads import get_workload as jget
from repro.integration.extract import DECODE_EXTRACTABLE_OPS as JOPS
from repro.integration.extract import extract_decode_task_specs as jextract
from repro.kernels.flash_attention import decode_flash_attention as pallas_decode
from repro.kernels.flash_attention import (
    paged_decode_flash_attention as pallas_paged,
)
from repro.models import layers as JL
from repro_torch.backends import gpu_backend as gb
from repro_torch.backends.registry import get_backend
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.trace import Trace as TTrace
from repro_torch.core.validator import validate_trace as tvalidate
from repro_torch.core.workloads import get_workload as tget
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.integration.extract import extract_decode_task_specs as textract
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as TL
from repro_torch.search.database import Database
from repro_torch.search.evolutionary import SearchConfig

TOL = 2e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bias(lengths, T, window=0):
    pos = np.arange(T)[None, :]
    lv = np.asarray(lengths)[:, None]
    ok = pos < lv
    if window:
        ok &= pos > lv - 1 - window
    return np.where(ok, 0.0, -1e30).astype(np.float32)


def _decode_inputs(B, KVH, G, T, D, seed):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, KVH, G, D), dtype=np.float32)
    k = r.standard_normal((B, KVH, T, D), dtype=np.float32)
    v = r.standard_normal((B, KVH, T, D), dtype=np.float32)
    return q, k, v


@pytest.mark.parametrize("softcap,block_kv,window", [
    (None, 8, 0), (30.0, 16, 0), (None, 12, 10), (50.0, 48, 0),
])
def test_decode_plain_matches_pallas(softcap, block_kv, window):
    B, KVH, G, T, D = 3, 2, 3, 48, 16
    q, k, v = _decode_inputs(B, KVH, G, T, D, seed=block_kv)
    bias = _bias([T, 17, 1], T, window)  # ragged per-slot lengths
    want = np.asarray(pallas_decode(q, k, v, bias, softcap=softcap,
                                    block_kv=block_kv, interpret=True))
    n = fa.decode_flash_attention.launches
    got = fa.decode_flash_attention(_t(q), _t(k), _t(v), _t(bias),
                                    softcap=softcap, block_kv=block_kv)
    assert fa.decode_flash_attention.launches == n  # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def _paged_inputs(seed, softcap=None):
    B, KVH, G, D, T, ps = 3, 2, 3, 16, 32, 8
    P = T // ps
    n_pages = B * P + 2
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, KVH, G, D), dtype=np.float32)
    k_pool = r.standard_normal((n_pages, KVH, ps, D), dtype=np.float32)
    v_pool = r.standard_normal((n_pages, KVH, ps, D), dtype=np.float32)
    table = r.permutation(n_pages - 1)[: B * P].reshape(B, P).astype(np.int32)
    table[1, -1] = n_pages  # sentinel: unallocated tail page
    table[2, 2:] = n_pages
    bias = _bias([T, T - ps, 2 * ps - 3], T)
    return q, k_pool, v_pool, table, bias


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_paged_decode_plain_matches_pallas(softcap):
    q, kp, vp, table, bias = _paged_inputs(0)
    want = np.asarray(pallas_paged(q, kp, vp, table, bias, softcap=softcap,
                                   interpret=True))
    got = fa.paged_decode_flash_attention(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(bias), softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_paged_decode_equals_decode_on_the_gathered_view():
    q, kp, vp, table, bias = _paged_inputs(1)
    n_pages, KVH, ps, D = kp.shape
    B, P = table.shape
    idx = np.minimum(table, n_pages - 1)
    gk = kp[idx].transpose(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D)
    gv = vp[idx].transpose(0, 2, 1, 3, 4).reshape(B, KVH, P * ps, D)
    want = tref.decode_attention(_t(q), _t(gk), _t(gv), _t(bias))
    got = tref.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(table), _t(bias))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)


def test_decode_launch_config_follows_and_rejects():
    # the serving shape on 132 SMs: bkv 64 gives 4 tiles, fewer than the 11
    # splits the card wants, so a split is 24 rows, part of one tile
    cfg = fa.decode_launch_config(4, 3, 3, 256, 64, 64, 132)
    assert cfg["grid"] == (12, 11) and cfg["blocks"] == (64,)
    assert cfg["splits"] == 11 and cfg["rows_per_split"] == 24
    assert cfg["smem_bytes"] == fa.decode_smem_bytes(3, 64, 64)
    assert cfg["smem_bytes"] == 4 * (2 * 3 * 64 + 64 * 65 + 64 * 64 + 3 * 64 + 9)
    assert cfg["scratch_bytes"] == 4 * 12 * 11 * (2 * 3 + 3 * 64)
    with pytest.raises(ScheduleRejected) as e:
        fa.decode_launch_config(1, 1, 3, 4096, 64, 4096, 132)
    assert e.value.reason == "shared_memory"
    with pytest.raises(ScheduleRejected) as e:
        fa.decode_launch_config(1, 1, 3, 256, 64, 48, 132)
    assert e.value.reason == "divide"


# (B, KVH, T, bkv, sms) -> (rows a split, splits): ceil(sms / (B·KVH))
# splits a (batch, kv head) at least, whole tiles where there are enough
@pytest.mark.parametrize("B,KVH,T,bkv,sms,rows,splits", [
    (4, 3, 256, 16, 132, 16, 16),    # the serving shape: 192 CTAs of a tile
    (4, 3, 256, 8, 132, 16, 16),     # 32 tiles, two a split
    (4, 3, 256, 32, 132, 24, 11),    # 8 tiles: part of one a split
    (4, 3, 256, 128, 132, 24, 11),
    (4, 3, 256, 256, 132, 24, 11),   # one tile, split 11 ways
    (4, 3, 192, 16, 132, 16, 12),    # 12 tiles: 144 CTAs
    (4, 3, 192, 8, 132, 16, 12),     # 24 tiles, two a split
    (4, 3, 192, 96, 132, 18, 11),    # 11 splits, the last of 12 rows
    (4, 3, 256, 16, 16, 128, 2),     # a card of 16 SMs: 8 tiles a split
    (64, 3, 256, 16, 132, 256, 1),   # 192 (batch, kv head) pairs fill the card
    (2, 2, 100, 4, 132, 4, 25),      # 25 tiles, fewer than the 33 wanted
    (1, 1, 300, 1, 132, 2, 150),     # 300 tiles, two a split
    (1, 1, 16, 16, 132, 1, 16),      # 16 rows: one a split
])
def test_decode_splits_fill_one_wave_where_the_rows_allow(B, KVH, T, bkv, sms,
                                                          rows, splits):
    assert fa.decode_splits(B * KVH, T, bkv, sms) == (rows, splits)
    cfg = fa.decode_launch_config(B, KVH, 3, T, 64, bkv, sms)
    assert cfg["grid"] == (B * KVH, splits) and cfg["rows_per_split"] == rows
    # every split has rows, and the splits cover every row once
    assert (splits - 1) * rows < T <= splits * rows
    # a run of whole tiles, or part of one
    assert rows % bkv == 0 or rows < bkv
    assert cfg["scratch_bytes"] == (4 * B * KVH * splits * (6 + 3 * 64)
                                    if splits > 1 else 0)


def test_decode_splits_reach_one_wave_at_the_serving_shape_at_every_tile():
    for bkv in (d for d in range(1, 257) if 256 % d == 0):
        cfg = fa.decode_launch_config(4, 3, 3, 256, 64, bkv, 132)
        assert cfg["grid"][0] * cfg["grid"][1] >= 132


@pytest.mark.parametrize("sms", [132, 114, 16])
def test_decode_splits_leave_no_split_empty_over_the_whisper_cross_cache(sms):
    """whisper-medium's cross-attention decode: b4, 16 kv heads of one query
    head, D 64, T = 1500 encoder frames.  At every kv tile that divides 1500
    and fits in shared memory, each split has rows and the splits cover the
    cache once; a larger tile is rejected for shared memory."""
    T, taken = 1500, []
    for bkv in (d for d in range(1, T + 1) if T % d == 0):
        try:
            cfg = fa.decode_launch_config(4, 16, 1, T, 64, bkv, sms)
        except ScheduleRejected as e:
            assert e.reason == "shared_memory" and bkv > 375
            continue
        taken.append(bkv)
        rows, splits = cfg["rows_per_split"], cfg["splits"]
        assert (splits - 1) * rows < T <= splits * rows
        assert rows % bkv == 0 or rows < bkv
    assert taken == [d for d in range(1, 376) if T % d == 0]


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------

DECODE_CASES = [
    dict(b=2, h=4, kvh=2, t=48, d=8),
    dict(b=1, h=6, kvh=2, t=32, d=8, softcap=30.0),
]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("kw", DECODE_CASES)
def test_decode_lowering_blocks_meta_and_outputs_match_pallas_backend(kw, seed):
    jfunc = jget("attention_decode", **kw)
    tr = SpaceGenerator(default_modules(use_mxu=True)).generate(jfunc, seed=seed).trace
    jv = jvalidate(jfunc, tr)
    tv = tvalidate(tget("attention_decode", **kw), TTrace.from_json(tr.to_json()))
    assert jv.ok and tv.ok
    assert gb.extract_decode_kv_block(tv.schedule) == pb.extract_decode_kv_block(
        jv.schedule
    )
    jfn, jmeta = pb.lower_attention_decode(jv.schedule, interpret=True)
    low = get_backend("cuda").lower(tv.schedule)
    assert {k: v for k, v in low.meta.items() if k != "backend"} == jmeta
    assert low.meta["pallas_kernel"] == "decode_flash_attention"
    ins = random_inputs(jfunc, 0)
    want = np.asarray(jfn(ins)["O"])
    got = low.fn({k: _t(v) for k, v in ins.items()})["O"]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    plain = gb.plain(tget("attention_decode", **kw))({k: _t(v) for k, v in ins.items()})
    np.testing.assert_allclose(plain["O"].numpy(), want, rtol=2e-5, atol=2e-5)


def test_decode_lowering_without_tiles_uses_the_default_block():
    from repro_torch.core.schedule import Schedule

    func = tget("attention_decode", b=1, h=2, kvh=1, t=192, d=8)
    assert gb.supports(func)
    low = get_backend("cuda").lower(Schedule(func, seed=None))
    assert low.meta["pallas_blocks_snapped"] == [pb._best_divisor(192, 128)]
    assert low.meta["pallas_blocks_source"] == "default"


# ---------------------------------------------------------------------------
# the model layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 5])
@pytest.mark.parametrize("window,softcap", [(None, None), (6, None), (None, 20.0)])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_matches_reference(S, window, softcap, per_slot):
    B, H, KVH, T, D = 3, 6, 2, 16, 8
    r = np.random.default_rng(S)
    q = r.standard_normal((B, H, S, D), dtype=np.float32)
    k = r.standard_normal((B, KVH, T, D), dtype=np.float32)
    v = r.standard_normal((B, KVH, T, D), dtype=np.float32)
    length = np.asarray([3, 9, 16], np.int32) if per_slot else np.int32(7)
    kw = dict(window=window, softcap=softcap)
    want = np.asarray(JL.decode_attention(q, k, v, length=jnp.asarray(length), **kw))
    got = TL.decode_attention(_t(q), _t(k), _t(v), length=_t(length), **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tuned_decode():
    cfg = tcfg("smollm-135m", smoke=True)
    tasks = repro_torch.extract_decode_tasks(
        cfg, batch=2, max_seq=16, dispatchable_only=True, ops=("attention_decode",),
    )
    db = Database()
    search = SearchConfig(max_trials=3, init_random=2, population=3,
                          measure_per_round=2)
    repro_torch.TaskScheduler(
        tasks, database=db,
        config=repro_torch.TuneConfig(search=search, runner_spec="cached+local",
                                      backend="cuda", device="cpu"),
    ).tune(total_rounds=len(tasks))
    return cfg, tasks, db


def test_decode_dispatch_hits_and_equals_the_plain_path(tuned_decode):
    cfg, tasks, db = tuned_decode
    (task,) = tasks
    assert task.key == ("attention_decode/b=2/d=16/h=3/kvh=1/softcap=0.0/t=16")
    r = np.random.default_rng(0)
    q = _t(r.standard_normal((2, 3, 1, 16), dtype=np.float32))
    k = _t(r.standard_normal((2, 1, 16, 16), dtype=np.float32))
    v = _t(r.standard_normal((2, 1, 16, 16), dtype=np.float32))
    length = torch.tensor([4, 16], dtype=torch.int32)
    want = TL.decode_attention(q, k, v, length=length, window=3)
    ctx = DispatchContext(db, tasks=tasks)
    with ctx:
        got = TL.decode_attention(q, k, v, length=length, window=3)
        # a chunk and a non-default scale fall back to the plain path
        TL.decode_attention(q.expand(2, 3, 4, 16), k, v, length=length)
        TL.decode_attention(q, k, v, length=length, scale=0.5)
    assert ctx.stats["attention_decode_tuned"] == 1
    assert ctx.hits_by_key == {task.key: 1}
    reasons = {}
    for row in ctx.stats_by_key().values():
        reasons.update(row["reasons"])
    assert reasons == {"chunked_query": 1, "nondefault_scale": 1}
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_decode_dispatch_gradient_is_the_plain_versions(tuned_decode):
    _, tasks, db = tuned_decode
    r = np.random.default_rng(1)
    q = _t(r.standard_normal((2, 3, 1, 16), dtype=np.float32)).requires_grad_(True)
    k = _t(r.standard_normal((2, 1, 16, 16), dtype=np.float32))
    v = _t(r.standard_normal((2, 1, 16, 16), dtype=np.float32))
    length = torch.tensor([16, 7], dtype=torch.int32)
    with DispatchContext(db, tasks=tasks):
        TL.decode_attention(q, k, v, length=length).sum().backward()
    g_tuned = q.grad.clone()
    q.grad = None
    TL.decode_attention(q, k, v, length=length).sum().backward()
    np.testing.assert_allclose(g_tuned.numpy(), q.grad.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# decode-task extraction
# ---------------------------------------------------------------------------

OPS = JOPS  # every op the reference extracts from the decode trace


@pytest.mark.parametrize("arch,smoke,kw", [
    ("smollm-135m", False, dict(batch=4, max_seq=256, paged=True, chunk=32)),
    ("smollm-135m", True, dict(batch=2, max_seq=32)),
    ("gemma2-2b", True, dict(batch=2, max_seq=32, chunk=8)),
    ("qwen1.5-110b", True, dict(batch=3, max_seq=24, paged=True, page_size=8)),
    ("whisper-medium", False, dict(batch=4, max_seq=256)),
    ("whisper-medium", True, dict(batch=2, max_seq=32, paged=True, chunk=4)),
    ("qwen2-vl-2b", False, dict(batch=4, max_seq=256)),
    ("qwen2-vl-2b", True, dict(batch=2, max_seq=32, paged=True, chunk=4)),
])
@pytest.mark.parametrize("dispatchable_only", [False, True])
def test_decode_extraction_keys_and_weights_match_reference(arch, smoke, kw,
                                                           dispatchable_only):
    kw = dict(kw, ops=OPS, dispatchable_only=dispatchable_only)
    want = {t.key: t.weight for t in jextract(jcfg(arch, smoke=smoke), mesh=None, **kw)}
    got = {t.key: t.weight for t in textract(tcfg(arch, smoke=smoke), **kw)}
    assert got == want
    if arch == "smollm-135m" and not smoke:
        key = "attention_decode/b=4/d=64/h=9/kvh=3/softcap=0.0/t=256"
        assert got[key] == 30
        assert got["dense/k=576/m=128/n=1536"] == 60  # the 32-wide serve tick
        # the norm of every decode tick, and of every 32-wide serve tick
        assert got["rmsnorm/d=576/eps=1e-06/tokens=4"] == 61
        assert got["rmsnorm/d=576/eps=1e-06/tokens=128"] == 61
    if arch == "whisper-medium" and not smoke:
        # cross-attention over the 1500 encoder frames, self-attention over
        # the 256-position cache: K5's two shapes, 24 layers each
        assert len(got) == (9 if dispatchable_only else 11)
        assert got["attention_decode/b=4/d=64/h=16/kvh=16/softcap=0.0/t=1500"] == 24
        assert got["attention_decode/b=4/d=64/h=16/kvh=16/softcap=0.0/t=256"] == 24
    if arch == "qwen2-vl-2b" and not smoke:
        assert len(got) == (8 if dispatchable_only else 9)
        assert got["attention_decode/b=4/d=128/h=12/kvh=2/softcap=0.0/t=256"] == 28


def test_decode_extraction_refuses_ops_of_later_slices():
    """rmsnorm is extracted from the decode trace now, as in the reference."""
    from repro_torch.integration.extract import DECODE_EXTRACTABLE_OPS

    assert DECODE_EXTRACTABLE_OPS == JOPS
    specs = textract(tcfg("smollm-135m", smoke=True), ops=("dense", "rmsnorm"),
                     min_task_elems=0)
    norm = [t for t in specs if t.op == "rmsnorm"]
    assert [t.key for t in norm] == ["rmsnorm/d=48/eps=1e-06/tokens=4"]
    assert norm[0].weight == 5 and norm[0].dispatchable


def test_decode_task_flops_are_the_references():
    specs = textract(tcfg("smollm-135m", smoke=True), batch=2, max_seq=32)
    attn = next(t for t in specs if t.op == "attention_decode")
    kw = attn.kwargs
    assert attn.flops == 4 * kw["b"] * kw["h"] * kw["t"] * kw["d"]
    assert math.isclose(attn.weight, tcfg("smollm-135m", smoke=True).n_layers)
