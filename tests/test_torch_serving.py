"""The port's serving path against the JAX package's, on the CPU.

``jax.random`` cannot be reproduced in torch, so the reference initialises
the parameters and ``models/convert.py`` carries them across.  Everything
runs in float32 (``dataclasses.replace(cfg, dtype="float32")`` and float32
parameters): ``prefill`` / ``decode_step`` / ``serve_step`` logits agree
within rtol/atol 1e-4 (logits of order 1, different float32 summation
orders), and the greedy token streams of ``ServingEngine`` and of the
scheduler (contiguous, paged, chunked) are equal to the reference's.  The
paged arena's page accounting follows ``tests/test_paged_serving.py``, and
an idle lane must never write a page owned by a live request.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.models import transformer as JT
from repro.serving import ContinuousBatchingScheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JEngine
from repro_torch.configs.base import get_config as tcfg
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serving import (
    ContinuousBatchingScheduler,
    KVArena,
    PagedKVArena,
    ServeConfig,
    ServingEngine,
    SlotPool,
)
from repro_torch.serving.config import coerce_serve_config
from repro_torch.serving.kv import snap_page_size

TOL = 1e-4
MAX_SEQ = 32
SLOTS = 2
PAGE = 8
CHUNK = 4


def _f32_pair(arch):
    jc = dataclasses.replace(jcfg(arch, smoke=True), dtype="float32")
    tc = dataclasses.replace(tcfg(arch, smoke=True), dtype="float32")
    jp = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32), JT.init_params(jc, jax.random.PRNGKey(0))
    )
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module", params=["smollm-135m", "gemma2-2b", "qwen2-vl-2b"])
def pair(request):
    return _f32_pair(request.param)


@pytest.fixture(scope="module")
def smollm():
    return _f32_pair("smollm-135m")


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# model serving functions
# ---------------------------------------------------------------------------


def test_prefill_then_decode_steps_match_reference(pair):
    jc, tc, jp, tp = pair
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 8)).astype(np.int32)
    jcache, tcache = JT.init_cache(jc, 2, 24), TT.init_cache(tc, 2, 24, device="cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    jl, jcache = JT.prefill(jc, jp, jcache, tokens=jnp.asarray(toks))
    tl, tcache = TT.prefill(tc, tp, tcache, torch.from_numpy(toks))
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    assert int(tcache["pos"]) == int(jcache["pos"]) == 8
    nxt = np.array([[3], [5]], np.int32)
    for _ in range(3):
        jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(nxt))
        tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(nxt))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)
    _close(tcache["v"], jcache["v"])


def test_decode_step_with_per_slot_positions_matches_reference(smollm):
    jc, tc, jp, tp = smollm
    r = np.random.default_rng(2)
    jcache = dict(JT.init_cache(jc, 3, 16))
    kv = r.standard_normal(jcache["k"].shape).astype(np.float32)
    jcache["k"], jcache["v"] = jnp.asarray(kv), jnp.asarray(kv[..., ::-1].copy())
    jcache["pos"] = jnp.asarray([0, 5, 15], jnp.int32)  # 15: wraps the ring
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    toks = r.integers(0, jc.vocab, (3, 1)).astype(np.int32)
    jl, jcache = JT.decode_step(jc, jp, jcache, jnp.asarray(toks))
    tl, tcache = TT.decode_step(tc, tp, tcache, torch.from_numpy(toks))
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    assert tcache["pos"].tolist() == [1, 6, 16]


def _paged_caches(jc, n_slots, max_seq, ps, table, pos, seed):
    """The same paged cache for both packages, pools filled with noise."""
    r = np.random.default_rng(seed)
    kv_len = JT.cache_max_len(jc, max_seq)
    n_pages = n_slots * (kv_len // ps)
    shape = (jc.n_layers, n_pages, jc.n_kv_heads, ps, jc.head_dim)
    jcache = {
        "k": jnp.asarray(r.standard_normal(shape).astype(np.float32)),
        "v": jnp.asarray(r.standard_normal(shape).astype(np.float32)),
        "page_table": jnp.asarray(table, jnp.int32),
        "pos": jnp.asarray(pos, jnp.int32),
    }
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    return jcache, tcache


@pytest.mark.parametrize("paged", [False, True])
def test_serve_step_mixed_tick_matches_reference(pair, paged):
    jc, tc, jp, tp = pair
    B, C = 3, 4
    if paged:
        # slot 0: 2 pages; slot 1: 1 page + sentinel tail; slot 2: idle
        table = np.array([[0, 3], [1, 6], [6, 6]], np.int32)
        jcache, tcache = _paged_caches(jc, B, 16, 8, table, [5, 2, 0], seed=3)
    else:
        jcache = dict(JT.init_cache(jc, B, 16))
        jcache["pos"] = jnp.asarray([5, 2, 0], jnp.int32)
        tcache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    r = np.random.default_rng(4)
    toks = r.integers(0, jc.vocab, (B, C)).astype(np.int32)
    valid = np.array([1, 4, 0], np.int32)  # decode lane, chunk lane, idle lane
    for _ in range(2):
        jl, jcache = JT.serve_step(jc, jp, jcache, jnp.asarray(toks), jnp.asarray(valid))
        tl, tcache = TT.serve_step(tc, tp, tcache, torch.from_numpy(toks),
                                   torch.from_numpy(valid))
        _close(tl[:2], jl[:2])  # lane 2 is idle: its logits are never sampled
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
        assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist()


def test_idle_lane_never_writes_a_live_page(smollm):
    jc, tc, jp, tp = smollm
    # slot 0 is live on pages 0-1; slot 1 was released (sentinel row) and
    # still carries tokens and a position, as a freed lane does mid-tick
    table = np.array([[0, 1], [4, 4]], np.int32)
    _, tcache = _paged_caches(jc, 2, 16, 8, table, [3, 9], seed=5)
    before = tcache["k"].clone(), tcache["v"].clone()
    toks = torch.tensor([[7, 0, 0, 0], [8, 9, 10, 11]])
    # lane 1 idle (valid 0), then a lane whose page-table row is all sentinel
    for valid in ([1, 0], [0, 4]):
        _, tcache = TT.serve_step(tc, tp, tcache, toks, torch.tensor(valid))
    for new, old in zip((tcache["k"], tcache["v"]), before):
        changed = (new != old).flatten(2).any(-1)  # (L, n_pages)
        # only slot 0's one decode write, at position 3 of page 0
        assert changed[:, 0].all() and not changed[:, 1:].any()
        assert torch.equal(new[:, 0, :, :3], old[:, 0, :, :3])
        assert torch.equal(new[:, 0, :, 4:], old[:, 0, :, 4:])


def test_page_view_clamps_the_sentinel():
    pool = torch.arange(3 * 1 * 2 * 1, dtype=torch.float32).reshape(3, 1, 2, 1)
    table = torch.tensor([[2, 0], [3, 3]], dtype=torch.int32)
    view = TT.page_view(pool, table)
    want = np.asarray(JT.page_view(jnp.asarray(pool.numpy()), jnp.asarray(table.numpy())))
    np.testing.assert_array_equal(view.numpy(), want)


# ---------------------------------------------------------------------------
# engine and scheduler: greedy token streams
# ---------------------------------------------------------------------------


def _engine_streams(Engine, Config, cfg, params, prompts, budgets, slots):
    eng = Engine(cfg, params, config=Config(max_slots=slots, max_seq=MAX_SEQ))
    for p, b in zip(prompts, budgets):
        eng.submit(p, max_new_tokens=b)
    return [list(r.generated) for r in eng.run()], eng


def test_engine_streams_equal_reference(smollm):
    jc, tc, jp, tp = smollm
    prompts = _prompts(jc.vocab, [6, 4, 8])
    budgets = [3, 5, 2]
    want, _ = _engine_streams(JEngine, JServeConfig, jc, jp, prompts, budgets, 2)
    got, eng = _engine_streams(ServingEngine, ServeConfig, tc, tp, prompts, budgets, 2)
    assert got == want
    assert eng.stats["decode_tokens"] == sum(budgets) - len(budgets)
    assert eng.decode_tok_s > 0 and eng.prefill_tok_s > 0


SCHED_MODES = [
    dict(paged=False, prefill_chunk=0),
    dict(paged=False, prefill_chunk=CHUNK),
    dict(paged=True, prefill_chunk=0, page_size=PAGE),
    dict(paged=True, prefill_chunk=CHUNK, page_size=PAGE),
]


def _sched_streams(Sched, Config, cfg, params, prompts, budgets, mode):
    sched = Sched(cfg, params, config=Config(max_slots=SLOTS, max_seq=MAX_SEQ, **mode))
    reqs = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.run()
    return [list(r.generated) for r in reqs], sched


@pytest.mark.parametrize("mode", SCHED_MODES,
                         ids=["contiguous", "contiguous-chunked", "paged",
                              "paged-chunked"])
def test_scheduler_streams_equal_reference(smollm, mode):
    jc, tc, jp, tp = smollm
    # 3 requests through 2 slots: one waits, then takes a recycled slot
    prompts = _prompts(jc.vocab, [6, 13, 5], seed=1)
    budgets = [4, 3, 5]
    want, jsched = _sched_streams(JScheduler, JServeConfig, jc, jp, prompts,
                                  budgets, mode)
    got, sched = _sched_streams(ContinuousBatchingScheduler, ServeConfig, tc, tp,
                                prompts, budgets, mode)
    assert got == want
    for k in ("prefill_tokens", "decode_tokens", "decode_steps", "admitted",
              "released", "prefill_chunks", "mixed_ticks", "pages_reserved"):
        assert sched.stats[k] == jsched.stats[k], k
    assert not sched.pending()
    if mode["paged"]:
        assert sched.arena.free_pages == sched.arena.total_pages


def test_scheduler_under_dispatch_serves_every_decode_tick_through_the_kernel(smollm):
    import repro_torch
    from repro_torch.integration.dispatch import DispatchContext
    from repro_torch.search.database import Database
    from repro_torch.search.evolutionary import SearchConfig

    _, tc, _, tp = smollm
    tasks = repro_torch.extract_decode_tasks(
        tc, batch=SLOTS, max_seq=MAX_SEQ, paged=True, chunk=CHUNK,
        page_size=PAGE, dispatchable_only=True, ops=("attention_decode",),
    )
    db = Database()
    repro_torch.TaskScheduler(tasks, database=db, config=repro_torch.TuneConfig(
        search=SearchConfig(max_trials=2, init_random=2, population=2,
                            measure_per_round=2),
        runner_spec="cached+local", backend="cuda", device="cpu",
    )).tune(total_rounds=1)
    mode = dict(paged=True, prefill_chunk=CHUNK, page_size=PAGE)
    prompts = _prompts(tc.vocab, [6, 9], seed=2)
    want, plain = _sched_streams(ContinuousBatchingScheduler, ServeConfig, tc, tp,
                                 prompts, [4, 4], mode)
    ctx = DispatchContext(db, tasks=tasks)
    got, sched = _sched_streams(ContinuousBatchingScheduler, ServeConfig, tc, tp,
                                prompts, [4, 4], dict(mode, dispatch=ctx))
    assert got == want
    # every layer of every decode-only tick went through the kernel path;
    # ticks that carried a prefill chunk fell back to the plain staircase
    decode_only = sched.stats["decode_steps"] - sched.stats["mixed_ticks"]
    assert decode_only > 0
    assert ctx.stats["attention_decode_tuned"] == tc.n_layers * decode_only
    reasons = {r for row in ctx.stats_by_key().values() for r in row["reasons"]}
    assert "lowering_failed" not in reasons and "chunked_query" in reasons


def test_request_streams_tokens_while_the_scheduler_runs(smollm):
    _, tc, _, tp = smollm
    (prompt,) = _prompts(tc.vocab, [5])
    sched = ContinuousBatchingScheduler(tc, tp, config=ServeConfig(
        max_slots=1, max_seq=MAX_SEQ, paged=True, page_size=PAGE,
        prefill_chunk=CHUNK))
    r = sched.submit(prompt, max_new_tokens=4)
    streamed = list(r.tokens())
    assert streamed == r.generated and len(streamed) == 4 and r.done
    assert r.ttft_s is not None and r.latency_s >= r.ttft_s


# ---------------------------------------------------------------------------
# config, slots and page accounting
# ---------------------------------------------------------------------------


def test_serve_config_is_the_one_way_in():
    assert coerce_serve_config(None, "X") == ServeConfig()
    sc = ServeConfig(max_slots=3)
    got = coerce_serve_config(sc, "X")
    assert got == sc and got is not sc
    with pytest.raises(TypeError):
        coerce_serve_config({"max_slots": 3}, "X")
    with pytest.raises(TypeError):
        ServingEngine(tcfg("smollm-135m", smoke=True), {}, max_batch=2)
    for bad in (dict(max_slots=0), dict(page_size=0), dict(prefill_chunk=-1)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    assert ServeConfig(max_slots=4, prefill_chunk=8).tick_budget == 12
    mamba = tcfg("mamba2-370m", smoke=True)
    off = ServeConfig(prefill_chunk=8).resolved_for(mamba)
    assert off.paged is False and off.prefill_chunk == 0
    assert ServeConfig().resolved_for(tcfg("smollm-135m")).paged is True


def test_snap_page_size_and_slot_pool():
    assert snap_page_size(32, 16) == 16
    assert snap_page_size(32, 12) == 8
    assert snap_page_size(30, 16) == 15
    assert snap_page_size(7, 16) == 7
    pool = SlotPool(2)
    assert pool.alloc() == 0 and pool.alloc() == 1 and pool.free == 0
    with pytest.raises(IndexError):
        pool.alloc()
    pool.release(1)
    with pytest.raises(ValueError):
        pool.release(1)


@pytest.fixture(scope="module")
def model():
    return build_model(tcfg("smollm-135m", smoke=True))


def test_paged_arena_reserve_release_accounting(model):
    arena = PagedKVArena(model, SLOTS, MAX_SEQ, page_size=PAGE, device="cpu")
    total = arena.total_pages
    assert arena.free_pages == total
    assert arena.pages_needed(PAGE + 1) == 2
    assert arena.reserve(0, PAGE + 1) == 2 and arena.free_pages == total - 2
    row = arena.cache["page_table"][0].numpy()
    assert (row[:2] < total).all() and (row[2:] == total).all()
    with pytest.raises(ValueError):
        arena.reserve(0, 4)  # double reservation
    arena.release_slot(0)
    assert arena.free_pages == total
    assert (arena.cache["page_table"][0].numpy() == total).all()


def test_paged_arena_exhaustion_gates_admission(model):
    arena = PagedKVArena(model, SLOTS, MAX_SEQ, page_size=PAGE, total_pages=3,
                         device="cpu")
    assert arena.can_admit(PAGE * 2) and not arena.can_admit(PAGE * 4)
    arena.reserve(0, PAGE * 2)
    assert not arena.can_admit(PAGE * 2)
    with pytest.raises(IndexError):
        arena.reserve(1, PAGE * 2)
    arena.release_slot(0)
    assert arena.can_admit(PAGE * 2)


def test_paged_arena_release_zeroes_only_owned_pages(model):
    arena = PagedKVArena(model, SLOTS, MAX_SEQ, page_size=PAGE, device="cpu")
    arena.reserve(0, PAGE * 2)
    arena.reserve(1, PAGE)
    p1 = int(arena.cache["page_table"][1][0])
    arena.cache["k"][:, p1] = 7.0
    arena.release_slot(0)
    assert float((arena.cache["k"][:, p1] - 7.0).abs().max()) == 0
    arena.release_slot(1)
    assert float(arena.cache["k"].abs().max()) == 0


def test_paged_arena_rejects_non_attention_model():
    with pytest.raises(ValueError, match="pure-attention"):
        PagedKVArena(build_model(tcfg("mamba2-370m", smoke=True)), SLOTS, MAX_SEQ,
                     device="cpu")


def test_contiguous_release_clears_the_written_prefix(model):
    arena = KVArena(model, SLOTS, MAX_SEQ, device="cpu")
    rc = model.init_cache(1, MAX_SEQ, device="cpu")
    used = 5
    rc["k"][:, :, :, :used] = 3.0
    rc["v"][:, :, :, :used] = 3.0
    rc["pos"] = torch.tensor(used, dtype=torch.int32)
    arena.load_slot(0, rc)
    assert float(arena.cache["k"][:, 0].abs().max()) == 3.0
    arena.release_slot(0, used=used)
    assert float(arena.cache["k"][:, 0].abs().max()) == 0
    assert float(arena.cache["v"][:, 0].abs().max()) == 0
    assert int(arena.positions[0]) == 0


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def test_launch_serve_runs_on_the_cpu(capsys):
    from repro_torch.launch.serve import main

    reqs = main(["--device", "cpu", "--requests", "3", "--prompt-len", "6",
                 "--new-tokens", "3", "--max-batch", "2"])
    assert len(reqs) == 3 and all(len(r.generated) == 3 for r in reqs)
    assert "decode" in capsys.readouterr().out


def test_serving_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    jp = JT.init_params(jcfg("smollm-135m", smoke=True), jax.random.PRNGKey(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(tcfg("smollm-135m", smoke=True), 1, 8)
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--requests", "1"])
