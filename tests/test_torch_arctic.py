"""arctic-480b's path in the port against the JAX package's, on the CPU.

arctic-480b is the widest model the port runs on the card: d_model 7168,
56 heads of head_dim 128 over 8 kv heads (GQA, G 7, an odd prime group),
128 experts top-2 of d_ff 4864 beside a dense residual MLP of d_ff 4864,
vocab 32000.  D 128 is no compiled ``tc`` head dim of K3, so its attention
runs on K3's ``fma`` variant and its decode attention on K5 at D 128, G 7.
At seq 256 an expert takes C = 8 tokens, and its products (3.57e10
multiply-adds) have no schedule under the tile and grid caps; a decode
tick's or a 32-token chunk's C is 4, so K2 serves its experts there at
batch 128.  The card runs 2 of its 35 layers in bf16 and 1 in f32.

A narrow arctic keeps the counts: 2 layers, 128 experts top-2, 56 heads of
8 over 8 kv heads, the dense residual, d_model 64, d_ff 32, vocab 256, seq
48 (C 4).  Its parameters are drawn from a numpy seed in the reference's
shapes and carried into the port with ``models/convert.py:params_from_jax``;
everything runs in float32.  Tolerances:

* logits (forward, dispatched forward, prefill and decode steps) within
  1e-5 of max |logit| (float32 sums in other orders through two layers);
* greedy streams of the paged scheduler, chunked prefill included: equal;
* extraction at full width: keys, weights, structural hashes and
  dispatchability equal;
* which products have a schedule, the tiles of the tick's expert products
  under both caps, K3's and K5's launch plans at D 128, G 7, the expert
  draw's shapes and dtypes, and the f32 cast of a parameter tree: exact;
* each expert's drawn standard deviation within 10 % of its fan-in scale
  (2048 or more draws an expert);
* the plain batched product over slices of a bf16 operand: within 1e-6
  of the product in one call (f32 sums of the same terms).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.integration import extract as JE
from repro.integration.dispatch import DispatchContext as JDispatch
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingScheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.tir import random_inputs
from repro_torch.core.workloads import get_workload as tget
from repro_torch.integration import extract as TE
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul as mm
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.search.database import Database
from repro_torch.search.measure.local import LocalBuilder, device_inputs
from repro_torch.search.measure.protocol import MeasureResult, Runner
from repro_torch.serving import ContinuousBatchingScheduler, ServeConfig
from torch_parity_helpers import chip_smoke, configs, divisors, fields, numpy_params
from torch_parity_helpers import reasons, rel, stored, tokens

ARCH = "arctic-480b"
TOL_REL = 1e-5
SEQ = 48
NARROW = dict(n_layers=2, d_model=64, n_heads=56, n_kv_heads=8, head_dim=8, d_ff=32,
              vocab=256, dtype="float32")
H100_SMS = 132
# the card's forward (batch 1, seq 256) and its expert products: C 8 there,
# C 4 at a tick (4 tokens) and a chunk (4 slots of 32)
FULL_ATTENTION = "attention/b=1/causal=1/d=128/h=56/kvh=8/s=256/softcap=0.0/window=0"
WI_TICK = "batch_matmul/b=128/k=7168/m=4/n=4864"
WO_TICK = "batch_matmul/b=128/k=4864/m=4/n=7168"

CS = chip_smoke()


def _full(layers):
    return (dataclasses.replace(jcfg(ARCH), n_layers=layers),
            dataclasses.replace(tcfg(ARCH), n_layers=layers))


@pytest.fixture(scope="module")
def narrow():
    jc, tc = configs(ARCH, **NARROW)
    npp = numpy_params(jc)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def test_narrow_model_keeps_arctics_counts(narrow):
    jc, tc, _, tp = narrow
    assert (tc.moe_experts, tc.moe_top_k, tc.moe_dense_residual) == (128, 2, True)
    assert tc.n_heads // tc.n_kv_heads == 7 == jc.n_heads // jc.n_kv_heads
    assert set(tp["layers"]) >= {"moe", "mlp"}
    assert TL.moe_capacity(SEQ, 2, 128, tc.moe_capacity_factor) == 4
    assert TT.window_period(TT.layer_windows(tc)) == 1 == JT.window_period(JT.layer_windows(jc))
    full = tcfg(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab, full.moe_experts, full.moe_top_k) == \
        (35, 7168, 56, 8, 128, 4864, 32000, 128, 2)
    assert full.head_dim not in fa.TC_HEAD_DIMS
    # C at the card's forward (256 tokens), a tick (4) and a chunk (128)
    assert [TL.moe_capacity(t, 2, 128, full.moe_capacity_factor) for t in (256, 4, 128)] \
        == [8, 4, 4]
    assert (CS.ARCTIC_LAYERS, CS.ARCTIC_F32_LAYERS, CS.ARCTIC_SERVE_LAYERS) == (2, 1, 1)


def test_forward_matches_reference(narrow):
    jc, tc, jp, tp = narrow
    toks = tokens(jc.vocab, (2, SEQ))
    want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    got = TT.forward(tc, tp, torch.from_numpy(toks))
    assert tuple(got.shape) == (2, SEQ, jc.vocab)
    assert rel(got, want) <= TOL_REL


def test_prefill_then_decode_steps_match_reference(narrow):
    jc, tc, jp, tp = narrow
    max_seq = SEQ + 8
    toks = tokens(jc.vocab, (2, SEQ - 4), seed=2)
    jcache, tcache = JT.init_cache(jc, 2, max_seq), TT.init_cache(tc, 2, max_seq, device="cpu")
    jl, jcache = JT.prefill(jc, jp, jcache, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(tc, tp, tcache, torch.from_numpy(toks))
    assert rel(tl, jl) <= TOL_REL
    nxt = np.array([[3], [5]], np.int32)
    for _ in range(4):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        assert rel(tl, jl) <= TOL_REL
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
    assert rel(tcache["k"], jcache["k"]) <= TOL_REL
    assert rel(tcache["v"], jcache["v"]) <= TOL_REL


def test_paged_serving_streams_equal_reference(narrow):
    """The card's serving tier at narrow width: 4 slots, 16-token pages,
    32-token prefill chunks, 6 requests (two wait for a slot), greedy; every
    model call routes its chunk's and its decode lanes' tokens through the
    128 experts at C 4."""
    jc, tc, jp, tp = narrow
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jc.vocab, int(n)).astype(np.int32)
               for n in rng.integers(20, 70, 6)]
    mode = dict(max_slots=4, max_seq=128, paged=True, page_size=16, prefill_chunk=32)
    streams = []
    for Sched, Config, c, p in ((JScheduler, JServeConfig, jc, jp),
                                (ContinuousBatchingScheduler, ServeConfig, tc, tp)):
        sched = Sched(c, p, config=Config(**mode))
        reqs = [sched.submit(x, max_new_tokens=6) for x in prompts]
        sched.run()
        streams.append(([list(r.generated) for r in reqs], dict(sched.stats)))
    (want, jstats), (got, stats) = streams
    assert got == want and all(len(s) == 6 for s in got)
    for k in ("prefill_tokens", "decode_tokens", "decode_steps", "prefill_chunks",
              "mixed_ticks", "pages_reserved"):
        assert stats[k] == jstats[k], k
    assert stats["mixed_ticks"] > 0


def test_dispatched_forward_matches_reference(narrow):
    """Under a DispatchContext whose database holds the attention, dense and
    expert keys (the norm's left out, as the card run leaves it plain), the
    port serves the fused attention at G 7, every dense site and the three
    expert products at the narrow b128 key (K2, plain on the CPU): the
    logits are the reference's dispatched forward's, and the (site, reason)
    pairs and the keys hit are the reference's."""
    jc, tc, jp, tp = narrow
    specs = TE.extract_task_specs(tc, batch=1, seq=SEQ, min_task_elems=1,
                                  dispatchable_only=True)
    assert fields(specs) == fields(JE.extract_task_specs(
        jc, mesh=None, batch=1, seq=SEQ, min_task_elems=1, dispatchable_only=True))
    jdb, db, jtasks, tasks = stored(specs, ("attention", "dense", "batch_matmul"))
    d, f = tc.d_model, tc.d_ff
    wi, wo = f"batch_matmul/b=128/k={d}/m=4/n={f}", f"batch_matmul/b=128/k={f}/m=4/n={d}"
    assert {wi, wo} <= {t.key for t in tasks}
    toks = tokens(jc.vocab, (1, SEQ), seed=3)
    with JDispatch(jdb, tasks=jtasks) as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(db, tasks=tasks) as ctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks))
    assert rel(got, want) <= TOL_REL
    assert reasons(ctx) == reasons(jctx) == {("rmsnorm", "unknown_key")}
    assert set(ctx.hits_by_key) == set(jctx.hits_by_key)
    L = tc.n_layers
    assert ctx.hits_by_key[wi] == 2 * L and ctx.hits_by_key[wo] == L
    attn = f"attention/b=1/causal=1/d=8/h=56/kvh=8/s={SEQ}/softcap=0.0/window=0"
    assert ctx.hits_by_key[attn] == L and ctx.stats["attention_tuned"] == L


def test_dispatched_forward_with_the_card_runs_plain_keys(narrow):
    """The card's forward dispatches only the keys a schedule reaches: with
    the expert products and the unembed left out of the database too (at
    full width and seq 256 they exceed the schedule caps), both packages
    miss the norm's 2·L + 1 sites, the experts' 3·L and the unembed's one
    with ``unknown_key`` and nothing else, and their logits agree; the
    dense residual MLP's three products are served."""
    jc, tc, jp, tp = narrow
    specs = TE.extract_task_specs(tc, batch=1, seq=SEQ, min_task_elems=1,
                                  dispatchable_only=True)
    d, f, v = tc.d_model, tc.d_ff, tc.vocab
    plain = {f"batch_matmul/b=128/k={d}/m=4/n={f}", f"batch_matmul/b=128/k={f}/m=4/n={d}",
             f"dense/k={d}/m={SEQ}/n={v}"}
    assert plain <= {s.key for s in specs}
    jdb, db, jtasks, tasks = stored([s for s in specs if s.key not in plain],
                                    ("attention", "dense", "batch_matmul"))
    toks = tokens(jc.vocab, (1, SEQ), seed=4)
    with JDispatch(jdb, tasks=jtasks) as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(db, tasks=tasks) as ctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks))
    assert rel(got, want) <= TOL_REL
    assert reasons(ctx) == reasons(jctx)
    assert {r for _, r in reasons(ctx)} == {"unknown_key"}
    L = tc.n_layers
    misses = sum(row["reasons"].get("unknown_key", 0) for row in ctx.stats_by_key().values())
    assert misses == 5 * L + 2
    assert not set(ctx.hits_by_key) & plain
    # q and o, k and v, the dense residual's wi and wg, then its wo
    assert ctx.hits_by_key[f"dense/k={d}/m={SEQ}/n={f}"] == 2 * L
    assert ctx.hits_by_key[f"dense/k={f}/m={SEQ}/n={d}"] == L


def test_full_width_forward_tasks():
    """The 14 forward tasks at 2 layers, batch 1, seq 256: the reference's,
    the expert products at C 8, K3's key at D 128, G 7 once a layer, both
    chunked contractions and the two softmaxes (tuning targets), the
    router's product, the unembed."""
    jc, tc = _full(CS.ARCTIC_LAYERS)
    got = TE.extract_task_specs(tc, batch=1, seq=256)
    assert fields(got) == fields(JE.extract_task_specs(jc, batch=1, seq=256))
    assert len(got) == CS.ARCTIC_FORWARD_TASKS == 14
    assert {t.key: t.weight for t in got} == {
        "batch_matmul/b=128/k=7168/m=8/n=4864": 4,  # wi and wg
        "batch_matmul/b=128/k=4864/m=8/n=7168": 2,
        "dense/k=7168/m=256/n=7168": 4,  # q and o
        "dense/k=7168/m=256/n=1024": 4,  # k and v
        "dense/k=7168/m=256/n=4864": 4,  # the dense residual's wi and wg
        "dense/k=4864/m=256/n=7168": 2,
        "dense/k=7168/m=256/n=32000": 1,
        "dense/k=7168/m=256/n=128": 2,  # the router
        FULL_ATTENTION: 2,
        "batch_matmul/b=8/k=128/m=1792/n=256": 2,
        "batch_matmul/b=8/k=256/m=1792/n=128": 2,
        "sfm/m=14336/n=256": 2,
        "sfm/m=256/n=128": 2,
        "rmsnorm/d=7168/eps=1e-06/tokens=256": 5,
    }
    assert set(CS.ARCTIC_TUNING_ONLY) <= {t.key for t in got}


@pytest.mark.parametrize("layers", [1, 2])
def test_full_width_paged_tick_tasks(layers):
    """The 20 tasks of a paged tick (4 slots over 256 positions, 32-token
    chunks, 16-token pages), as the card's serving phase extracts them:
    the reference's, the expert products at C 4 (the tick's and the
    chunk's), K5's key at D 128, G 7 and the m4 unembed."""
    jc, tc = _full(layers)
    kw = dict(batch=4, max_seq=256, paged=True, chunk=32, page_size=16)
    got = TE.extract_decode_task_specs(tc, **kw)
    assert fields(got) == fields(JE.extract_decode_task_specs(jc, **kw))
    keys = {t.key for t in got}
    assert len(got) == CS.ARCTIC_SERVE_TASKS == 20
    assert {WI_TICK, WO_TICK, "dense/k=7168/m=4/n=32000",
            "attention_decode/b=4/d=128/h=56/kvh=8/softcap=0.0/t=256"} <= keys
    assert set(CS.ARCTIC_SERVE_TUNING_ONLY) <= keys
    weights = {t.key: t.weight for t in got}
    assert weights[WI_TICK] == 4 * layers and weights[WO_TICK] == 2 * layers


def test_schedule_caps_leave_the_forward_experts_and_unembed_plain():
    """A tile holds at most 2^17 elements and a grid at most 2^18 tiles, so
    a product of more than 2^35 multiply-adds has no schedule
    (``chip_smoke.py:schedulable``): the forward's expert products at C 8
    (128·8·7168·4864 = 3.57e10) and its unembed (5.87e10).  Every product
    of a paged tick, the b128 expert products at C 4 (1.785e10) among them,
    has one."""
    _, tc = _full(CS.ARCTIC_LAYERS)
    tile, grid = CS.schedule_caps()
    assert tile * grid == 2**35
    forward = TE.extract_task_specs(tc, batch=1, seq=256)
    tick = TE.extract_decode_task_specs(tc, batch=4, max_seq=256, paged=True, chunk=32,
                                        page_size=16)
    none = {t.key for t in forward if not CS.schedulable(t)}
    assert none == {"batch_matmul/b=128/k=7168/m=8/n=4864",
                    "batch_matmul/b=128/k=4864/m=8/n=7168", "dense/k=7168/m=256/n=32000"}
    assert 128 * 8 * 7168 * 4864 > 2**35 > 128 * 4 * 7168 * 4864
    assert all(CS.schedulable(t) for t in tick)


@pytest.mark.parametrize("key", [WI_TICK, WO_TICK])
def test_tick_expert_products_have_tiles_under_both_caps(key):
    """The batch of 128 takes 7 of the grid cap's 18 bits: of the divisor
    tiles (bm, bn, bk) of a b128 m4 expert product, few fit both the tile
    cap and the grid cap, and each that does gets a launch plan on K2's
    splitk variant (M 4) or is refused for shared memory or threads."""
    from repro_torch.backends.gpu_backend import MAX_GRID_STEPS
    from repro_torch.core.validator import MAX_TILE_ELEMS
    from repro_torch.search.database import parse_workload_key

    kw = parse_workload_key(key)[1]
    B, M, N, K = kw["b"], kw["m"], kw["n"], kw["k"]
    tiles = [(bm, bn, bk) for bm in divisors(M) for bn in divisors(N) for bk in divisors(K)]
    fit = [t for t in tiles if t[0] * t[1] * t[2] <= MAX_TILE_ELEMS
           and B * (M // t[0]) * (N // t[1]) * (K // t[2]) <= MAX_GRID_STEPS]
    planned = []
    for blocks in fit:
        try:
            plan = mm.launch_config(B, M, N, K, blocks)
        except ScheduleRejected as e:
            assert e.reason in ("shared_memory", "threads")
            continue
        assert plan["variant"] == "splitk"
        planned.append(blocks)
    assert len(tiles) == 1188 and 0 < len(fit) < len(tiles) // 10
    assert planned
    # the tiles phase 3f runs
    assert {(4, 608, 32), (4, 896, 32)} & set(planned)


class _Lowering(Runner):
    """Lowers each candidate as a local runner does and runs nothing: a
    lowered candidate gets one fixed latency, a rejected one its reason."""

    name = "lowering"
    backend = "cuda"

    def __init__(self):
        self.builder = LocalBuilder(backend="cuda")
        self.tiles = []

    def run(self, inputs):
        out = []
        for br in self.builder.build(inputs):
            if not br.ok:
                out.append(MeasureResult(float("inf"), br.error))
                continue
            res = MeasureResult(1e-3)
            res.meta = dict(br.meta)
            self.tiles.append(tuple(br.meta["pallas_blocks_snapped"]))
            out.append(res)
        return out

    def stats(self):
        return {}


def test_cold_search_draws_a_tile_for_the_tick_expert_products():
    """The serving phase's tuning of the two b128 m4 expert products, on a
    runner that lowers each candidate (the grid, tile, shared-memory and
    thread checks) and times nothing: the first round's 8 candidates of
    each are all rejected, and the further searches of ``COLD_WIDE``
    candidates a round draw a tile under both caps for each within
    ``COLD_SEARCHES`` seeds; every failure is a rejection."""
    import repro_torch
    from repro_torch.search.evolutionary import SearchConfig
    from repro_torch.search.task_scheduler import TuneTask

    tasks = [TuneTask(key=k, func=tget("batch_matmul", b=128, m=4, n=n, k=kk))
             for k, n, kk in ((WI_TICK, 4864, 7168), (WO_TICK, 7168, 4864))]
    first = _Lowering()
    sched = repro_torch.TaskScheduler(tasks, database=Database(), config=repro_torch.TuneConfig(
        search=SearchConfig(**CS.TUNE_SEARCH), runner_spec=first, backend="cuda",
        device="cpu", warm_start=False))
    assert not any(map(math.isfinite, sched.tune(total_rounds=2).values()))
    assert not first.tiles
    runner = _Lowering()
    tuned, best = CS.phase_tune(tcfg(ARCH), Database(), extract=lambda: tasks, tag="cold",
                                runner_spec=runner, cold_width=CS.COLD_WIDE,
                                unschedulable=())
    assert {t.key for t in tuned} == {WI_TICK, WO_TICK}
    assert all(math.isfinite(best[k]) for k in (WI_TICK, WO_TICK))
    assert {b[1] for b in runner.tiles} & set(divisors(4864))
    assert {b[1] for b in runner.tiles} & set(divisors(7168))


def test_k3_takes_fma_at_head_dim_128_group_7_at_every_tile():
    """At arctic's forward shape (1, 56, 256, 128) kvh 8 every tile the
    search can draw has the fma plan (grid (S/bq, H), 256 threads,
    ``smem_bytes``) or is refused for shared memory before any launch,
    exactly where its CTA exceeds 227 KB: 63 tiles and 18."""
    ok = []
    for bq in divisors(256):
        for bkv in divisors(256):
            assert fa.variant(128, bkv) == "fma"
            smem = fa.smem_bytes(bq, bkv, 128)
            if smem > fa.MAX_SMEM_BYTES:
                with pytest.raises(ScheduleRejected) as e:
                    fa.check_tile(1, 56, 8, 256, 128, bq, bkv)
                assert e.value.reason == "shared_memory"
                continue
            for sms in (1, H100_SMS):
                cfg = fa.launch_config(1, 56, 8, 256, 128, bq, bkv, sms)
                assert cfg["variant"] == "fma" and cfg["splits"] == 1
                assert cfg["grid"] == (256 // bq, 56) and cfg["threads"] == fa.THREADS
                assert cfg["smem_bytes"] == smem
            ok.append((bq, bkv))
    assert len(ok) == 63


# K5 at arctic's tick (b4, 8 kv heads of 7 query heads, t 256, D 128) on
# 132 SMs: 32 (slot, kv head) pairs; (rows, splits, shared memory) by kv
# tile.  At tiles 64 and 128 a split is part of one tile; tile 256
# overflows shared memory
K5_PLANS = {
    1: (51, 6, 8_308), 2: (50, 6, 9_364), 4: (48, 6, 11_476), 8: (48, 6, 15_700),
    16: (48, 6, 24_148), 32: (32, 8, 41_044), 64: (52, 5, 74_836),
    128: (52, 5, 142_420),
}


@pytest.mark.parametrize("bkv", divisors(256))
def test_k5_launch_plan_at_head_dim_128_group_7(bkv):
    if bkv not in K5_PLANS:
        assert fa.decode_smem_bytes(7, bkv, 128) == 277_588 > fa.MAX_SMEM_BYTES
        with pytest.raises(ScheduleRejected) as e:
            fa.decode_launch_config(4, 8, 7, 256, 128, bkv, H100_SMS)
        assert e.value.reason == "shared_memory"
        return
    rows, splits, smem = K5_PLANS[bkv]
    cfg = fa.decode_launch_config(4, 8, 7, 256, 128, bkv, H100_SMS)
    assert fa.decode_splits(4 * 8, 256, bkv, H100_SMS) == (rows, splits)
    assert cfg["grid"] == (32, splits) and cfg["rows_per_split"] == rows
    assert cfg["smem_bytes"] == fa.decode_smem_bytes(7, bkv, 128) == smem


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
def test_moe_init_draws_expert_by_expert(arch):
    """``moe_init`` draws each expert's (D, F) slice straight into the bf16
    stack: the shapes and dtypes are the reference's, each expert's
    standard deviation is its fan-in scale (1/sqrt(D) for wi and wg,
    1/sqrt(F) for wo), no two experts draw the same values, and two draws
    from one seed are equal."""
    cfg = tcfg(arch, smoke=True)
    L, D, E, F_ = cfg.n_layers, cfg.d_model, cfg.moe_experts, cfg.d_ff
    a = TT.init_params(cfg, seed=0, device="cpu")["layers"]["moe"]
    b = TT.init_params(cfg, seed=0, device="cpu")["layers"]["moe"]
    shapes = dict(router=(L, D, E), wi=(L, E, D, F_), wg=(L, E, D, F_), wo=(L, E, F_, D))
    for name, t in a.items():
        assert tuple(t.shape) == shapes[name]
        assert t.dtype == (torch.float32 if name == "router" else torch.bfloat16)
        assert torch.equal(t, b[name])
    for name, scale in (("wi", D**-0.5), ("wg", D**-0.5), ("wo", F_**-0.5)):
        std = a[name].float().reshape(L, E, -1).std(-1)
        assert bool(((std / scale - 1).abs() < 0.1).all()), (name, std)
        flat = a[name].reshape(L * E, -1)
        assert len({tuple(r[:8].tolist()) for r in flat}) == L * E


def test_plain_bmm_over_slices_of_a_bf16_operand(monkeypatch):
    """Above ``PLAIN_BMM_SLICE_ELEMS`` elements of a low-precision b the
    plain batched product casts and multiplies slices of the batch axis:
    the same f32 product as one call, within 1e-6."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(10, 4, 24, generator=g).to(torch.bfloat16)
    b = torch.randn(10, 24, 16, generator=g).to(torch.bfloat16)
    whole = torch.matmul(a.float(), b.float())
    monkeypatch.setattr(TL, "PLAIN_BMM_SLICE_ELEMS", 3 * 24 * 16)
    got = TL.bmm_op(a, b)
    assert got.dtype == torch.float32 and got.shape == whole.shape
    assert float((got - whole).abs().max()) <= 1e-6 * float(whole.abs().max())
    b32 = b.float()
    assert torch.equal(TL.bmm_op(a, b32), torch.matmul(a.float(), b32))


def test_device_inputs_off_the_card_are_random_inputs():
    """Off the card a runner's timing inputs are ``random_inputs(func, 0)``
    exactly, as the parity tests draw them."""
    func = tget("batch_matmul", b=3, m=4, n=5, k=6)
    got = device_inputs(func, torch.device("cpu"))
    want = random_inputs(func, 0)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], torch.from_numpy(v))


def test_cast_f32_casts_leaf_by_leaf_in_place():
    """``chip_smoke.py:cast_f32_`` gives the values of a whole-tree cast,
    in the tree it was given, every leaf f32."""
    cfg = tcfg(ARCH, smoke=True)
    params = TT.init_params(cfg, seed=0, device="cpu")
    want = CS._tree_map(lambda t: t.float(), params)
    got = CS.cast_f32_(params)
    assert got is params
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(want)
    assert len(flat_got) == len(flat_want)
    for x, y in zip(flat_got, flat_want):
        assert x.dtype == torch.float32 and torch.equal(x, y)
