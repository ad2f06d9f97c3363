"""stablelm-3b's path in the port against the JAX package's, on the CPU.

stablelm-3b is the first model the port runs on the card at its whole depth
(32 layers) with 32 heads of head_dim 80 over 32 kv heads (MHA, G 1).
No compiled ``tc`` head dim of K3 is 80, so its attention runs on K3's
``fma`` variant, and its decode attention on K5 at D 80, G 1.

A narrow stablelm keeps the real head_dim: 2 layers, d_model 160, 2 heads
of 80 over 2 kv heads, d_ff 320, vocab 256, seq 48.  Its parameters are
drawn from a numpy seed in the reference's shapes and carried into the
port with ``models/convert.py:params_from_jax``; everything runs in
float32.  Tolerances:

* logits (forward, dispatched forward, prefill and decode steps) within
  1e-5 of max |logit| (float32 sums in other orders through two layers);
* extraction: keys, weights, structural hashes and dispatchability equal;
* K3's and K5's launch plans at D 80 are pure functions of the shape, held
  exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jcfg
from repro.core.workloads import get_workload as jget
from repro.integration import extract as JE
from repro.integration.dispatch import DispatchContext as JDispatch
from repro.models import transformer as JT
from repro.search.database import Database as JDatabase
from repro.search.database import TuningRecord as JRecord
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.workloads import get_workload as tget
from repro_torch.integration import extract as TE
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.kernels import ScheduleRejected
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.search.database import Database, TuningRecord
from repro_torch.search.task_scheduler import TuneTask

TOL_REL = 1e-5
SEQ = 48
NARROW = dict(n_layers=2, d_model=160, n_heads=2, n_kv_heads=2, head_dim=80, d_ff=320,
              vocab=256, dtype="float32")
# the full width's forward (batch 1, seq 256) and its unembed
FULL_ATTENTION = "attention/b=1/causal=1/d=80/h=32/kvh=32/s=256/softcap=0.0/window=0"
FULL_UNEMBED = "dense/k=2560/m=256/n=50304"
H100_SMS = 132


def _configs():
    return (dataclasses.replace(jcfg("stablelm-3b"), **NARROW),
            dataclasses.replace(tcfg("stablelm-3b"), **NARROW))


def _numpy_params(jc, seed=0):
    """float32 parameters in the reference's shapes: matrices N(0, 1) at
    fan-in scale, norm weights 1 + N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        shape = tuple(spec.shape)
        if "ln" in path[-1].key:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, JT.param_specs(jc))


@pytest.fixture(scope="module")
def narrow():
    jc, tc = _configs()
    npp = _numpy_params(jc)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def _fields(specs):
    return sorted((t.key, t.weight, t.struct_hash, t.dispatchable) for t in specs)


def _reasons(ctx):
    return {(row["site"], r) for row in ctx.stats_by_key().values() for r in row["reasons"]}


def test_narrow_model_keeps_stablelms_attention():
    jc, tc = _configs()
    assert tc.head_dim == 80 == jc.head_dim and tc.n_heads == tc.n_kv_heads
    assert TT.window_period(TT.layer_windows(tc)) == 1 == JT.window_period(JT.layer_windows(jc))
    full = tcfg("stablelm-3b")
    assert (full.n_layers, full.head_dim, full.n_heads, full.n_kv_heads) == (32, 80, 32, 32)
    assert full.head_dim not in fa.TC_HEAD_DIMS


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


def _stored(specs, ops):
    """Both packages' databases with the same stored trace (its JSON) for
    each task of ``ops``, the first the port's space generates that its
    validator accepts, and each package's tasks for them."""
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.validator import validate_trace

    jdb, db, jtasks, tasks = JDatabase(), Database(), [], []
    for t in (s for s in specs if s.op in ops):
        func = tget(t.op, **t.kwargs)
        gen = SpaceGenerator(default_modules())
        tr = next(tr for tr in (gen.generate(func, seed=s).trace for s in range(32))
                  if validate_trace(func, tr).ok)
        jdb.put(JRecord(t.key, tr.to_json(), 1e-5))
        db.put(TuningRecord(t.key, tr.to_json(), 1e-5))
        jtasks.append(type("T", (), dict(key=t.key, func=jget(t.op, **t.kwargs))))
        tasks.append(TuneTask(key=t.key, func=func))
    return jdb, db, jtasks, tasks


def test_dispatched_forward_matches_reference(narrow):
    """Under a DispatchContext whose database holds the attention and dense
    keys (the norm's left out, as the card run leaves it plain), the port
    serves the fused attention once a layer and every dense site, with the
    plain versions on the CPU: the logits are the reference's dispatched
    forward's, and the (site, reason) pairs and the keys hit are the
    reference's.  The reference's scan traces its body once, so it counts
    a layer's key once, the port once a layer."""
    jc, tc, jp, tp = narrow
    specs = TE.extract_task_specs(tc, batch=1, seq=SEQ, min_task_elems=1,
                                  dispatchable_only=True)
    assert _fields(specs) == _fields(JE.extract_task_specs(
        jc, mesh=None, batch=1, seq=SEQ, min_task_elems=1, dispatchable_only=True))
    jdb, db, jtasks, tasks = _stored(specs, ("attention", "dense"))
    attn = [t.key for t in tasks if t.key.startswith("attention/")]
    assert attn == [f"attention/b=1/causal=1/d=80/h=2/kvh=2/s={SEQ}/softcap=0.0/window=0"]
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
    rows = ctx.stats_by_key()
    norm = f"rmsnorm/d={tc.d_model}/eps={tc.norm_eps}/tokens={SEQ}"
    assert rows[norm]["reasons"] == {"unknown_key": 2 * tc.n_layers + 1}


def test_full_width_forward_tasks():
    """The 9 forward tasks at batch 1, seq 256: the reference's, K3's key at
    D 80 once a layer, both chunked contractions (tuning targets: the fused
    attention replaces them), the unembed."""
    jc, tc = jcfg("stablelm-3b"), tcfg("stablelm-3b")
    got = TE.extract_task_specs(tc, batch=1, seq=256)
    assert _fields(got) == _fields(JE.extract_task_specs(jc, batch=1, seq=256))
    by_key = {t.key: t.weight for t in got}
    assert len(got) == 9
    assert by_key[FULL_ATTENTION] == 32 and by_key[FULL_UNEMBED] == 1
    assert by_key["dense/k=2560/m=256/n=2560"] == 128  # q, k, v and o: MHA
    assert by_key["rmsnorm/d=2560/eps=1e-06/tokens=256"] == 65


@pytest.mark.parametrize("kw,n", [
    (dict(), 8),  # a decode step
    (dict(paged=True, chunk=32, page_size=16, dispatchable_only=True), 11),  # a paged tick
])
def test_full_width_decode_tasks(kw, n):
    """The decode tasks of 4 slots over 256 positions, as the card's serving
    phase extracts them: the reference's, with K5's key at D 80, G 1."""
    jc, tc = jcfg("stablelm-3b"), tcfg("stablelm-3b")
    kw = dict(kw, batch=4, max_seq=256)
    got = TE.extract_decode_task_specs(tc, **kw)
    assert _fields(got) == _fields(JE.extract_decode_task_specs(jc, **kw))
    keys = {t.key for t in got}
    assert len(got) == n
    assert "attention_decode/b=4/d=80/h=32/kvh=32/softcap=0.0/t=256" in keys
    assert "dense/k=2560/m=4/n=50304" in keys


def _divisors(n):
    return [d for d in range(1, n + 1) if n % d == 0]


def test_k3_takes_fma_at_head_dim_80_at_every_tile():
    """At D 80 every kv tile is ``fma``, a multiple of 8 too; at stablelm's
    forward shape (1, 32, 256, 80) kvh 32 every tile the search can draw has
    the fma plan (grid (S/bq, H), 256 threads, ``smem_bytes``) or is
    refused for shared memory before any launch, exactly where its CTA
    exceeds 227 KB."""
    for bkv in _divisors(256):
        assert fa.variant(80, bkv) == "fma"
    assert fa.variant(64, 64) == "tc"  # the rule's other side
    for bq in _divisors(256):
        for bkv in _divisors(256):
            smem = fa.smem_bytes(bq, bkv, 80)
            assert smem == 4 * (2 * bq * 80 + bkv * 81 + bkv * 80 + bq * bkv + 3 * bq)
            if smem > fa.MAX_SMEM_BYTES:
                with pytest.raises(ScheduleRejected) as e:
                    fa.check_tile(1, 32, 32, 256, 80, bq, bkv)
                assert e.value.reason == "shared_memory"
                continue
            for sms in (1, H100_SMS):
                cfg = fa.launch_config(1, 32, 32, 256, 80, bq, bkv, sms)
                assert cfg["variant"] == "fma" and cfg["splits"] == 1
                assert cfg["grid"] == (256 // bq, 32) and cfg["threads"] == fa.THREADS
                assert cfg["smem_bytes"] == smem
    # the tiles the card tests and phase 3 run
    assert fa.check_tile(1, 32, 32, 256, 80, 32, 32)["smem_bytes"] == 45_568
    assert fa.check_tile(1, 32, 32, 256, 80, 64, 64)["smem_bytes"] == 99_328
    with pytest.raises(ScheduleRejected):
        fa.check_tile(1, 32, 32, 256, 80, 256, 128)


@pytest.mark.parametrize("bkv", _divisors(256))
def test_k5_launch_plan_at_head_dim_80_group_1(bkv):
    """K5 at stablelm's tick (b4, 32 kv heads of one query head, t 256, D
    80): 128 (batch, kv head) pairs want two splits each on 132 SMs, of 128
    rows at every tile; the shared memory of a CTA is ``decode_smem_bytes``
    and every tile fits."""
    cfg = fa.decode_launch_config(4, 32, 1, 256, 80, bkv, H100_SMS)
    rows, splits = fa.decode_splits(4 * 32, 256, bkv, H100_SMS)
    assert (rows, splits) == (128, 2)
    assert cfg["grid"] == (128, splits) and cfg["rows_per_split"] == rows
    assert cfg["smem_bytes"] == fa.decode_smem_bytes(1, bkv, 80) <= fa.MAX_SMEM_BYTES
    assert cfg["scratch_bytes"] == 4 * 128 * splits * (2 + 80)


def test_forward_unembed_search_finding():
    """The forward unembed, m256 k2560 n50304, needs 3.30e10 multiply-adds,
    4 % under the caps' product (2^17 tile elements x 2^18 grid steps): a
    tile must hold 125,770-131,072 elements with bn dividing 50304.  The
    search the card run makes (a fresh search and three reseeded ones, each
    given its patience, here with no other task in the database) draws no
    such tile in the fresh search and the first two reseeds, whose every
    candidate the lowering rejects before timing; the third reseed draws
    (4, 1572, 20), an fma tile of 393 threads.  On the card, where the
    searches also follow measured times, the tile drawn changed from run
    to run, so ``chip_smoke.py`` leaves the unembed plain
    (``STABLELM_UNEMBED`` among its plain keys) and times K1 at the fixed
    tile (256, 128, 4), valid under both caps."""
    import repro_torch
    from repro_torch.backends.gpu_backend import MAX_GRID_STEPS
    from repro_torch.core.validator import MAX_TILE_ELEMS
    from repro_torch.kernels import matmul as mm
    from repro_torch.search.evolutionary import SearchConfig

    M, K, N = 256, 2560, 50304
    assert 0.95 * MAX_TILE_ELEMS * MAX_GRID_STEPS < M * N * K < MAX_TILE_ELEMS * MAX_GRID_STEPS
    task = TuneTask(key=FULL_UNEMBED, func=tget("dense", m=M, n=N, k=K))
    search = SearchConfig(max_trials=32, init_random=8, population=16,
                          measure_per_round=8, rollout_factor=2)
    drawn = {}
    for seed in range(4):
        config = repro_torch.TuneConfig(
            search=dataclasses.replace(search, seed=seed), runner_spec="cached+local",
            backend="cuda", device="cpu", warm_start=False)
        db = Database()
        sched = repro_torch.TaskScheduler([task], database=db, config=config)
        for _ in range(config.patience + 1):
            if sched.tune(total_rounds=1)[FULL_UNEMBED] < float("inf"):
                drawn[seed] = tuple(db.best(FULL_UNEMBED).meta["pallas_blocks_snapped"])
                break
        errors = [err for s in sched.searches for _, err in s.errors]
        assert errors and all(err.startswith("rejected (grid)") for err in errors)
    assert drawn == {3: (4, 1572, 20)}
    for blocks in ((4, 1572, 20), (256, 128, 4)):
        bm, bn, bk = blocks
        assert bm * bn * bk <= MAX_TILE_ELEMS
        assert (M // bm) * (N // bn) * (K // bk) <= MAX_GRID_STEPS
        assert mm.launch_config(1, M, N, K, blocks)["variant"] == "fma"
    assert mm.launch_config(1, M, N, K, (4, 1572, 20))["threads"] == 393
