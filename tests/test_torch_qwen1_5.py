"""qwen1.5-110b's path in the port against the JAX package's, on the CPU.

qwen1.5-110b is the widest model the port runs on the card: d_model 8192,
64 heads of head_dim 128 over 8 kv heads (GQA, G 8), d_ff 49152, vocab
152064, a bias on q, k and v.  D 128 is no compiled ``tc`` head dim of K3,
so its attention runs on K3's ``fma`` variant, and its decode attention
on K5 at D 128, G 8.  The card runs 6 of its 80 layers: one layer holds
1.36e9 parameters, and the forward's f32 check holds the bf16 and the f32
copy at once.

A narrow qwen1.5 keeps the real head_dim and group: 2 layers, d_model
1024, 8 heads of 128 over 1 kv head, d_ff 256, vocab 256, seq 48.  Its
parameters (the q, k and v biases among them) are drawn from a numpy seed
in the reference's shapes and carried into the port with
``models/convert.py:params_from_jax``; everything runs in float32.
Tolerances:

* logits (forward, dispatched forward, prefill and decode steps) within
  1e-5 of max |logit| (float32 sums in other orders through two layers);
* extraction at full width: keys, weights, structural hashes and
  dispatchability equal;
* which products have a schedule, the search's first tile, and K3's and
  K5's launch plans at D 128, G 8 are pure functions of the shape, held
  exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.integration import extract as JE
from repro.integration.dispatch import DispatchContext as JDispatch
from repro.models import transformer as JT
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.workloads import get_workload as tget
from repro_torch.integration import extract as TE
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.search.database import Database
from repro_torch.search.task_scheduler import TuneTask
from torch_parity_helpers import chip_smoke, configs, divisors as _divisors
from torch_parity_helpers import fields as _fields, numpy_params as _numpy_params
from torch_parity_helpers import reasons as _reasons, rel as _rel, stored as _stored
from torch_parity_helpers import tokens as _tokens

ARCH = "qwen1.5-110b"
TOL_REL = 1e-5
SEQ = 48
NARROW = dict(n_layers=2, d_model=1024, n_heads=8, n_kv_heads=1, head_dim=128, d_ff=256,
              vocab=256, dtype="float32")
# the card's depth and the full width's forward (batch 1, seq 256)
LAYERS = 6
FULL_ATTENTION = "attention/b=1/causal=1/d=128/h=64/kvh=8/s=256/softcap=0.0/window=0"
FULL_QO = "dense/k=8192/m=256/n=8192"
H100_SMS = 132

CS = chip_smoke()


def _configs():
    return configs(ARCH, **NARROW)


def _full():
    return (dataclasses.replace(jcfg(ARCH), n_layers=LAYERS),
            dataclasses.replace(tcfg(ARCH), n_layers=LAYERS))


@pytest.fixture(scope="module")
def narrow():
    jc, tc = _configs()
    npp = _numpy_params(jc)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def test_narrow_model_keeps_qwens_attention(narrow):
    jc, tc, _, tp = narrow
    assert tc.head_dim == 128 == jc.head_dim and tc.n_heads // tc.n_kv_heads == 8
    assert tc.qkv_bias and jc.qkv_bias
    assert float(tp["layers"]["attn"]["bq"].abs().max()) > 0  # the biases are drawn
    assert TT.window_period(TT.layer_windows(tc)) == 1 == JT.window_period(JT.layer_windows(jc))
    full = tcfg(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab) == (80, 8192, 64, 8, 128, 49152, 152064)
    assert full.head_dim not in fa.TC_HEAD_DIMS
    assert CS.QWEN15_LAYERS == LAYERS


def test_forward_matches_reference(narrow):
    jc, tc, jp, tp = narrow
    toks = _tokens(jc.vocab, (2, SEQ))
    want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    got = TT.forward(tc, tp, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, SEQ, jc.vocab)
    assert _rel(got, want) <= TOL_REL


def test_prefill_then_decode_steps_match_reference(narrow):
    jc, tc, jp, tp = narrow
    max_seq = SEQ + 8
    toks = _tokens(jc.vocab, (2, SEQ - 4), seed=2)
    jcache, tcache = JT.init_cache(jc, 2, max_seq), TT.init_cache(tc, 2, max_seq, device="cpu")
    jl, jcache = JT.prefill(jc, jp, jcache, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(tc, tp, tcache, torch.from_numpy(toks))
    assert _rel(tl, jl) <= TOL_REL
    nxt = np.array([[3], [5]], np.int32)
    for _ in range(4):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        assert _rel(tl, jl) <= TOL_REL
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
    assert _rel(tcache["k"], jcache["k"]) <= TOL_REL
    assert _rel(tcache["v"], jcache["v"]) <= TOL_REL


def test_dispatched_forward_matches_reference(narrow):
    """Under a DispatchContext whose database holds the attention and dense
    keys (the norm's left out, as the card run leaves it plain), the port
    serves the fused attention once a layer at G 8 and every dense site, q,
    k and v with their biases, with the plain versions on the CPU: the
    logits are the reference's dispatched forward's, and the (site,
    reason) pairs and the keys hit are the reference's.  The reference's
    scan traces its body once, so it counts a layer's key once, the port
    once a layer."""
    jc, tc, jp, tp = narrow
    specs = TE.extract_task_specs(tc, batch=1, seq=SEQ, min_task_elems=1,
                                  dispatchable_only=True)
    assert _fields(specs) == _fields(JE.extract_task_specs(
        jc, mesh=None, batch=1, seq=SEQ, min_task_elems=1, dispatchable_only=True))
    jdb, db, jtasks, tasks = _stored(specs, ("attention", "dense"))
    attn = [t.key for t in tasks if t.key.startswith("attention/")]
    assert attn == [f"attention/b=1/causal=1/d=128/h=8/kvh=1/s={SEQ}/softcap=0.0/window=0"]
    toks = _tokens(jc.vocab, (1, SEQ), seed=3)
    with JDispatch(jdb, tasks=jtasks) as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(db, tasks=tasks) as ctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks))
    assert _rel(got, want) <= TOL_REL
    assert _reasons(ctx) == _reasons(jctx) == {("rmsnorm", "unknown_key")}
    assert set(ctx.hits_by_key) == set(jctx.hits_by_key) == {t.key for t in tasks}
    assert ctx.hits_by_key[attn[0]] == tc.n_layers
    assert ctx.stats["attention_tuned"] == tc.n_layers and ctx.stats["attention_fused"] == 0
    # q and o share a key (n = d_model), k and v another (n = kvh·hd)
    d, kv = tc.d_model, tc.n_kv_heads * tc.head_dim
    assert ctx.hits_by_key[f"dense/k={d}/m={SEQ}/n={d}"] == 2 * tc.n_layers
    assert ctx.hits_by_key[f"dense/k={d}/m={SEQ}/n={kv}"] == 2 * tc.n_layers
    rows = ctx.stats_by_key()
    norm = f"rmsnorm/d={tc.d_model}/eps={tc.norm_eps}/tokens={SEQ}"
    assert rows[norm]["reasons"] == {"unknown_key": 2 * tc.n_layers + 1}


def test_dispatched_forward_with_the_card_runs_plain_keys(narrow):
    """The card run dispatches only the keys a schedule reaches: with the
    MLP's two keys and the unembed left out of the database as well (at
    full width they exceed the schedule caps), both packages miss the
    norm's 2·L + 1 sites, the MLP's 3·L and the unembed's one with
    ``unknown_key`` and nothing else, and their logits agree."""
    jc, tc, jp, tp = narrow
    specs = TE.extract_task_specs(tc, batch=1, seq=SEQ, min_task_elems=1,
                                  dispatchable_only=True)
    d, f, v = tc.d_model, tc.d_ff, tc.vocab
    plain = {f"dense/k={d}/m={SEQ}/n={f}", f"dense/k={f}/m={SEQ}/n={d}",
             f"dense/k={d}/m={SEQ}/n={v}"}
    assert plain <= {s.key for s in specs}
    jdb, db, jtasks, tasks = _stored([s for s in specs if s.key not in plain],
                                     ("attention", "dense"))
    toks = _tokens(jc.vocab, (1, SEQ), seed=4)
    with JDispatch(jdb, tasks=jtasks) as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(db, tasks=tasks) as ctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks))
    assert _rel(got, want) <= TOL_REL
    assert _reasons(ctx) == _reasons(jctx) == {("rmsnorm", "unknown_key"),
                                               ("dense", "unknown_key")}
    L = tc.n_layers
    misses = sum(row["reasons"].get("unknown_key", 0) for row in ctx.stats_by_key().values())
    assert misses == 5 * L + 2
    assert not set(ctx.hits_by_key) & plain


def test_full_width_forward_tasks():
    """The 10 forward tasks at 6 layers, batch 1, seq 256: the reference's,
    K3's key at D 128, G 8 once a layer, both chunked contractions and the
    sfm site (tuning targets: the fused attention replaces them), the
    unembed."""
    jc, tc = _full()
    got = TE.extract_task_specs(tc, batch=1, seq=256)
    assert _fields(got) == _fields(JE.extract_task_specs(jc, batch=1, seq=256))
    assert {t.key: t.weight for t in got} == {
        "dense/k=8192/m=256/n=8192": 12,  # q and o
        "dense/k=8192/m=256/n=1024": 12,  # k and v
        "dense/k=8192/m=256/n=49152": 12,  # wi and wg
        "dense/k=49152/m=256/n=8192": 6,
        "dense/k=8192/m=256/n=152064": 1,
        FULL_ATTENTION: 6,
        "batch_matmul/b=8/k=128/m=2048/n=256": 6,
        "batch_matmul/b=8/k=256/m=2048/n=128": 6,
        "sfm/m=16384/n=256": 6,
        "rmsnorm/d=8192/eps=1e-06/tokens=256": 13,
    }


@pytest.mark.parametrize("kw,n", [
    (dict(), 9),  # a decode step
    (dict(paged=True, chunk=32, page_size=16), 16),  # a paged tick, as the card tunes it
])
def test_full_width_decode_tasks(kw, n):
    """The decode tasks of 4 slots over 256 positions at 6 layers, as the
    card's serving phase extracts them: the reference's, with K5's key at
    D 128, G 8 and the m4 unembed over the 152064-wide table."""
    jc, tc = _full()
    kw = dict(kw, batch=4, max_seq=256)
    got = TE.extract_decode_task_specs(tc, **kw)
    assert _fields(got) == _fields(JE.extract_decode_task_specs(jc, **kw))
    keys = {t.key for t in got}
    assert len(got) == n
    assert "attention_decode/b=4/d=128/h=64/kvh=8/softcap=0.0/t=256" in keys
    assert "dense/k=8192/m=4/n=152064" in keys
    assert "dense/k=49152/m=4/n=8192" in keys


def test_schedule_caps_leave_the_widest_products_plain():
    """A tile holds at most 2^17 elements and a grid at most 2^18 tiles, so
    a product of more than 2^35 multiply-adds has no schedule
    (``chip_smoke.py:schedulable``): the forward's MLP (1.03e11) and
    unembed (3.19e11) and the serving chunk's MLP at m128 (5.15e10).  q and
    o at m256 sit at exactly half the cap, and every m4 product, the
    5.0e9 decode unembed among them, has a schedule."""
    jc, tc = _full()
    tile, grid = CS.schedule_caps()
    assert tile * grid == 2**35
    forward = TE.extract_task_specs(tc, batch=1, seq=256)
    tick = TE.extract_decode_task_specs(tc, batch=4, max_seq=256, paged=True, chunk=32,
                                        page_size=16)
    none = {t.key for t in forward + tick if not CS.schedulable(t)}
    assert none == {"dense/k=8192/m=256/n=49152", "dense/k=49152/m=256/n=8192",
                    "dense/k=8192/m=256/n=152064", "dense/k=8192/m=128/n=49152",
                    "dense/k=49152/m=128/n=8192"}
    assert 256 * 8192 * 8192 == 2**34
    assert all(CS.schedulable(t) for t in tick if "/m=4/" in t.key)


def test_forward_qo_search_draws_a_tile():
    """q and o at m256 k8192 n8192 (2^34 multiply-adds) take tiles of
    2^16 or 2^17 elements alone.  The card run's fresh search (seed 0, no
    other task in the database) rejects 6 of its first 8 candidates for the
    grid cap or the thread cap and times two, (128, 128, 8), a tc tile,
    and (4, 4096, 4), an fma tile; which is best is the timing's call.
    The timed tiles are read from what the runner measured: the database
    keeps a candidate only where it beats the best so far (as the
    reference's does), so on the CPU, where both tiles run the same plain
    product, the second tile reaches it only when its time is lower."""
    import math

    import repro_torch
    from repro_torch.backends.gpu_backend import MAX_GRID_STEPS
    from repro_torch.core.validator import MAX_TILE_ELEMS
    from repro_torch.kernels import matmul as mm
    from repro_torch.search.evolutionary import SearchConfig
    from repro_torch.search.measure import as_runner

    task = TuneTask(key=FULL_QO, func=tget("dense", m=256, n=8192, k=8192))
    runner = as_runner("cached+local", backend="cuda", device="cpu")
    timed, measure = {}, runner.inner.run

    def run(inputs):
        out = measure(inputs)
        for res in out:
            if res.ok:
                timed[tuple(res.meta["pallas_blocks_snapped"])] = res.latency_s
        return out

    runner.inner.run = run
    config = repro_torch.TuneConfig(
        search=SearchConfig(**CS.TUNE_SEARCH), runner_spec=runner,
        backend="cuda", device="cpu", warm_start=False)
    db = Database()
    sched = repro_torch.TaskScheduler([task], database=db, config=config)
    assert math.isfinite(sched.tune(total_rounds=1)[FULL_QO])
    assert set(timed) == {(128, 128, 8), (4, 4096, 4)}
    assert all(math.isfinite(t) for t in timed.values())
    assert tuple(db.best(FULL_QO).meta["pallas_blocks_snapped"]) in timed
    errors = [err for s in sched.searches for _, err in s.errors]
    assert len(errors) == 6
    assert all(err.startswith(("rejected (grid)", "rejected (threads)")) for err in errors)
    for blocks, var in (((128, 128, 8), "tc"), ((4, 4096, 4), "fma")):
        bm, bn, bk = blocks
        assert bm * bn * bk in (MAX_TILE_ELEMS // 2, MAX_TILE_ELEMS)
        assert (256 // bm) * (8192 // bn) * (8192 // bk) <= MAX_GRID_STEPS
        assert mm.launch_config(1, 256, 8192, 8192, blocks)["variant"] == var


def test_k3_takes_fma_at_head_dim_128_group_8_at_every_tile():
    """At qwen1.5's forward shape (1, 64, 256, 128) kvh 8 every tile the
    search can draw has the fma plan (grid (S/bq, H), 256 threads,
    ``smem_bytes``) or is refused for shared memory before any launch,
    exactly where its CTA exceeds 227 KB."""
    for bq in _divisors(256):
        for bkv in _divisors(256):
            assert fa.variant(128, bkv) == "fma"
            smem = fa.smem_bytes(bq, bkv, 128)
            assert smem == 4 * (2 * bq * 128 + bkv * 129 + bkv * 128 + bq * bkv + 3 * bq)
            if smem > fa.MAX_SMEM_BYTES:
                with pytest.raises(ScheduleRejected) as e:
                    fa.check_tile(1, 64, 8, 256, 128, bq, bkv)
                assert e.value.reason == "shared_memory"
                continue
            for sms in (1, H100_SMS):
                cfg = fa.launch_config(1, 64, 8, 256, 128, bq, bkv, sms)
                assert cfg["variant"] == "fma" and cfg["splits"] == 1
                assert cfg["grid"] == (256 // bq, 64) and cfg["threads"] == fa.THREADS
                assert cfg["smem_bytes"] == smem
    # the tiles the card tests and phase 3 run
    assert fa.check_tile(1, 64, 8, 256, 128, 32, 32)["smem_bytes"] == 70_144
    assert fa.check_tile(1, 64, 8, 256, 128, 8, 64)["smem_bytes"] == 76_128
    assert fa.check_tile(1, 64, 8, 256, 128, 64, 64)["smem_bytes"] == 148_480
    for bq, bkv in ((256, 128), (128, 256), (64, 256)):
        with pytest.raises(ScheduleRejected):
            fa.check_tile(1, 64, 8, 256, 128, bq, bkv)


# K5 at qwen1.5's tick (b4, 8 kv heads of 8 query heads, t 256, D 128) on
# 132 SMs: 32 (slot, kv head) pairs want 5 splits each; (rows, splits,
# shared memory) by kv tile.  At tiles 64 and 128 a split is part of one
# tile; tile 256 overflows shared memory
K5_PLANS = {
    1: (51, 6, 9_348), 2: (50, 6, 10_408), 4: (48, 6, 12_528), 8: (48, 6, 16_768),
    16: (48, 6, 25_248), 32: (32, 8, 42_208), 64: (52, 5, 76_128),
    128: (52, 5, 143_968),
}


@pytest.mark.parametrize("bkv", _divisors(256))
def test_k5_launch_plan_at_head_dim_128_group_8(bkv):
    if bkv not in K5_PLANS:
        assert fa.decode_smem_bytes(8, bkv, 128) == 279_648 > fa.MAX_SMEM_BYTES
        with pytest.raises(ScheduleRejected) as e:
            fa.decode_launch_config(4, 8, 8, 256, 128, bkv, H100_SMS)
        assert e.value.reason == "shared_memory"
        return
    rows, splits, smem = K5_PLANS[bkv]
    cfg = fa.decode_launch_config(4, 8, 8, 256, 128, bkv, H100_SMS)
    assert fa.decode_splits(4 * 8, 256, bkv, H100_SMS) == (rows, splits)
    assert cfg["grid"] == (32, splits) and cfg["rows_per_split"] == rows
    assert cfg["smem_bytes"] == fa.decode_smem_bytes(8, bkv, 128) == smem
    assert cfg["scratch_bytes"] == 4 * 32 * 8 * splits * (2 + 128)
    # a split that is part of one tile: its rows do not fill whole tiles
    assert (rows % bkv != 0) == (bkv >= 64)
