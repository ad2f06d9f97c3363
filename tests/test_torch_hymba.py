"""hymba-1.5b's path in the port against the JAX package's, on the CPU.

hymba is the one model whose window pattern has no period: global attention
at the first, middle and last layers, a window elsewhere.  The reference
then traces the window through its layer scan, and its dispatch hooks keep
the chunked attention path (``fallback traced_window``), whose two
contractions dispatch through ``bmm_op`` (K2 on the card).  The port marks
such windows :class:`~repro_torch.models.layers.TracedWindow` and takes the
same path.

Every depth of 4 or less has a period (it may equal the depth), so these
tests run hymba's smoke widths at depth 6, windows (0, 16, 16, 0, 16, 0),
where a 2-layer smoke would hide the difference.  Parameters are drawn from
a numpy seed in the reference's shapes and carried into the port with
``models/convert.py:params_from_jax``; everything runs in float32.
Tolerances: the dispatched logits within 1e-5 of max |logit| of the
reference's dispatched forward (float32 sums in other orders through six
layers); greedy streams equal token for token; dispatch outcomes, task keys,
weights and cache shapes equal.
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
from repro.serving import ContinuousBatchingScheduler as JScheduler
from repro.serving import ServeConfig as JServeConfig
from repro_torch.configs.base import get_config as tcfg
from repro_torch.core.workloads import get_workload as tget
from repro_torch.integration import extract as TE
from repro_torch.integration.dispatch import DispatchContext
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.search.database import Database, TuningRecord
from repro_torch.search.task_scheduler import TuneTask
from repro_torch.serving import ContinuousBatchingScheduler, KVArena, ServeConfig

DEPTH = 6
SEQ = 32
TOL_REL = 1e-5
# the two contractions of the chunked attention at the smoke widths: B·KVH
# = 2, G·S = 2·32, head_dim 16, one 32-key chunk
SMOKE_BMM = ("batch_matmul/b=2/k=16/m=64/n=32", "batch_matmul/b=2/k=32/m=64/n=16")
# and at full width, batch 1, seq 256: B·KVH = 5, G·S = 5·256, head_dim 64
FULL_BMM = ("batch_matmul/b=5/k=256/m=1280/n=64", "batch_matmul/b=5/k=64/m=1280/n=256")


def _configs(arch="hymba-1.5b", layers=DEPTH):
    return (dataclasses.replace(jcfg(arch, smoke=True), n_layers=layers, dtype="float32"),
            dataclasses.replace(tcfg(arch, smoke=True), n_layers=layers, dtype="float32"))


def _numpy_params(jc, seed=0):
    """float32 parameters in the reference's shapes: matrices N(0, 1) at
    fan-in scale, norm weights 1 + N(0, 0.1), the SSD's per-head vectors
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(path, spec):
        shape = tuple(spec.shape)
        if len(shape) >= 2 and "ln" not in path[-1].key:
            return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(np.float32)
        base = 1.0 if "ln" in path[-1].key else 0.0
        return (base + 0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, JT.param_specs(jc))


def _pair(arch="hymba-1.5b", layers=DEPTH):
    jc, tc = _configs(arch, layers)
    npp = _numpy_params(jc)
    return jc, tc, jax.tree_util.tree_map(jnp.asarray, npp), params_from_jax(npp, device="cpu")


@pytest.fixture(scope="module")
def hymba():
    return _pair()


def _tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (1, SEQ)).astype(np.int32)


def _reasons(ctx):
    return {(row["site"], r) for row in ctx.stats_by_key().values() for r in row["reasons"]}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


def test_hymba_windows_have_no_period_at_every_depth_over_4():
    for layers in range(1, 33):
        jc, tc = _configs(layers=layers)
        windows = TT.layer_windows(tc)
        assert windows.tolist() == JT.layer_windows(jc).tolist()
        traced = TT.window_period(windows) is None
        assert traced == (JT.window_period(JT.layer_windows(jc)) is None) == (layers > 4)
        got = TT._windows(tc)
        assert all(isinstance(w, TL.TracedWindow) for w in got) == traced
        assert [int(w or 0) for w in got] == windows.tolist()


def test_aperiodic_windows_keep_the_chunked_path_as_the_reference(hymba):
    """(a) The fault: with an empty database the port looked the fused
    attention key up, missed and launched the backend's fused attention
    (``backend_fused``), where the reference keeps the chunked path
    (``traced_window``) and looks up its two contractions."""
    jc, tc, jp, tp = hymba
    toks = _tokens(jc.vocab)
    with JDispatch(JDatabase()) as jctx:
        JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(Database()) as ctx:
        TT.forward(tc, tp, torch.from_numpy(toks).long())
    got = _reasons(ctx)
    assert got == _reasons(jctx)
    assert ("attention", "traced_window") in got
    assert ("attention", "backend_fused") not in got
    assert ctx.stats["attention_fused"] == 0 == jctx.stats.get("attention_fused", 0)
    rows = ctx.stats_by_key()
    assert rows["site:attention"]["reasons"] == {"traced_window": DEPTH}
    for key in SMOKE_BMM:  # once a layer in the port's loop
        assert rows[key]["reasons"] == {"unknown_key": DEPTH}


def _tune(tasks, db):
    import repro_torch
    from repro_torch.search.evolutionary import SearchConfig

    repro_torch.TaskScheduler(tasks, database=db, config=repro_torch.TuneConfig(
        search=SearchConfig(max_trials=2, init_random=2, population=2,
                            measure_per_round=2),
        runner_spec="cached+local", backend="cuda", device="cpu",
    )).tune(total_rounds=len(tasks))


def _copy_db(db):
    jdb = JDatabase()
    for key in db.keys():
        rec = db.best(key)
        jdb.put(JRecord(key, rec.trace_json, rec.latency_s))
    return jdb


def _fields(specs):
    return sorted((t.key, t.weight, t.struct_hash, t.dispatchable) for t in specs)


def test_tuned_contractions_are_served_at_every_layer(hymba):
    """(b) Both contractions extracted at the smoke shape, tuned, and
    stored in both packages' databases: the port hits each once a layer
    (the reference's scan traces its body once, so once in all) and its
    logits are the reference's dispatched forward's."""
    jc, tc, jp, tp = hymba
    kw = dict(batch=1, seq=SEQ, min_task_elems=1, dispatchable_only=True)
    specs = TE.extract_task_specs(tc, **kw)
    assert _fields(specs) == _fields(JE.extract_task_specs(jc, mesh=None, **kw))
    bmm = [t for t in specs if t.op == "batch_matmul"]
    assert sorted(t.key for t in bmm) == sorted(SMOKE_BMM)
    assert not [t for t in specs if t.op == "attention"]
    tasks = [TuneTask(key=t.key, func=tget(t.op, **t.kwargs), weight=t.weight) for t in bmm]
    db = Database()
    _tune(tasks, db)
    assert sorted(db.keys()) == sorted(SMOKE_BMM)
    jtasks = [type("T", (), dict(key=t.key, func=jget(t.op, **t.kwargs))) for t in bmm]
    toks = _tokens(jc.vocab, seed=2)
    with JDispatch(_copy_db(db), tasks=jtasks) as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(db, tasks=tasks) as ctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks).long())
    for key in SMOKE_BMM:
        assert ctx.hits_by_key[key] == DEPTH
        assert jctx.hits_by_key[key] == 1
    assert ctx.stats["attention_fused"] == 0
    assert _rel(got, want) <= TOL_REL


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma2-2b"])
def test_periodic_models_keep_their_fused_attention(arch):
    """(c) The repair's guard: a model whose window pattern has a period
    keeps int windows, hits its tuned ``attention`` keys once a layer
    (K3 on the card) and notes the reference's outcomes: the same (site,
    reason) pairs and the same keys hit.  The reference's scan traces its
    body once, so it counts a key once a period, the port once a layer."""
    from repro.core.modules import SpaceGenerator, default_modules

    jc, tc, jp, tp = _pair(arch, layers=2)
    assert TT.window_period(TT.layer_windows(tc)) is not None
    specs = TE.extract_task_specs(tc, batch=1, seq=SEQ, min_task_elems=1,
                                  dispatchable_only=True)
    attn = [t for t in specs if t.op == "attention"]
    assert attn
    jdb, db, jtasks, tasks = JDatabase(), Database(), [], []
    for i, t in enumerate(specs):
        func = jget(t.op, **t.kwargs)
        if t.op == "attention":
            tr = SpaceGenerator(default_modules()).generate(func, seed=i).trace
            jdb.put(JRecord(t.key, tr.to_json(), 1e-5))
            db.put(TuningRecord(t.key, tr.to_json(), 1e-5))
        jtasks.append(type("T", (), dict(key=t.key, func=func)))
        tasks.append(type("T", (), dict(key=t.key, func=tget(t.op, **t.kwargs))))
    toks = _tokens(jc.vocab, seed=3)
    with JDispatch(jdb, tasks=jtasks) as jctx:
        want = JT.forward(jc, jp, tokens=jnp.asarray(toks))
    with DispatchContext(db, tasks=tasks) as ctx:
        got = TT.forward(tc, tp, torch.from_numpy(toks).long())
    assert _reasons(ctx) == _reasons(jctx)
    assert set(ctx.hits_by_key) == set(jctx.hits_by_key) == {t.key for t in attn}
    windows = [int(w) if 0 < w < SEQ else 0 for w in TT.layer_windows(tc)]
    for t in attn:
        assert ctx.hits_by_key[t.key] == windows.count(t.kwargs["window"])
    assert ctx.stats["attention_tuned"] == tc.n_layers
    assert not {r for _, r in _reasons(ctx)} & {"traced_window", "backend_fused"}
    assert _rel(got, want) <= 1e-4


def _prompts(vocab, lens, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def test_slot_arena_streams_cross_the_window_as_the_reference(hymba):
    """(d) Three requests through two arena slots, each decoding past the
    16-token window (one prefills past it), under the port's dispatch
    context with an empty database: the reference's greedy tokens, and
    every decode attention call notes ``traced_window``."""
    jc, tc, jp, tp = hymba
    max_seq = 48
    prompts = _prompts(jc.vocab, [20, 9, 14])
    budgets = [10, 12, 8]
    jsched = JScheduler(jc, jp, config=JServeConfig(max_slots=2, max_seq=max_seq))
    jreqs = [jsched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    jsched.run()
    ctx = DispatchContext(Database())
    sched = ContinuousBatchingScheduler(tc, tp, config=ServeConfig(
        max_slots=2, max_seq=max_seq, dispatch=ctx))
    assert isinstance(sched.arena, KVArena) and set(sched.arena.cache) == {
        "pos", "k", "v", "state"}
    reqs = [sched.submit(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    sched.run()
    assert [list(r.generated) for r in reqs] == [list(r.generated) for r in jreqs]
    assert all(len(p) + b > jc.local_window for p, b in zip(prompts, budgets))
    rows = ctx.stats_by_key()
    assert rows["site:attention_decode"]["reasons"] == {
        "traced_window": DEPTH * sched.stats["decode_steps"]}
    assert rows["site:attention"]["reasons"] == {"traced_window": DEPTH * len(prompts)}
    assert ctx.stats["attention_fused"] == 0 and ctx.stats["attention_decode_tuned"] == 0


@pytest.mark.parametrize("max_seq", [256, 1152])
def test_full_width_cache_outlasts_the_window(max_seq):
    """hymba's global layers keep the whole context: the stacked cache is
    ``max_seq`` long, past the 1024-token window, as in the reference."""
    jc, tc = jcfg("hymba-1.5b"), tcfg("hymba-1.5b")
    assert TT.cache_max_len(tc, max_seq) == JT.cache_max_len(jc, max_seq) == max_seq
    want = jax.eval_shape(lambda: JT.init_cache(jc, 4, max_seq))
    got = TT.init_cache(tc, 4, max_seq, device="meta")
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == tuple(want[name].shape), name
        assert str(got[name].dtype).replace("torch.", "") == str(want[name].dtype), name


def test_full_width_forward_tasks_carry_both_contractions():
    """The 20 forward tasks at batch 1, seq 256: the reference's, with the
    two K2 keys at weight 32 (one a layer) and no fused attention task."""
    jc, tc = jcfg("hymba-1.5b"), tcfg("hymba-1.5b")
    got = TE.extract_task_specs(tc, batch=1, seq=256)
    assert _fields(got) == _fields(JE.extract_task_specs(jc, batch=1, seq=256))
    assert len(got) == 20
    by_key = {t.key: t for t in got}
    for key in FULL_BMM:
        assert by_key[key].weight == 32 and by_key[key].dispatchable
    assert not [t for t in got if t.op == "attention"]


def test_full_width_decode_tasks_at_a_cache_past_the_window():
    """The decode tasks at the serving phase's cache length, 1152: the
    reference's, none of them ``attention_decode`` (its window is
    traced)."""
    max_seq = 1152
    jc, tc = jcfg("hymba-1.5b"), tcfg("hymba-1.5b")
    got = TE.extract_decode_task_specs(tc, batch=4, max_seq=max_seq)
    assert _fields(got) == _fields(JE.extract_decode_task_specs(jc, batch=4,
                                                                max_seq=max_seq))
    assert not [t for t in got if t.op == "attention_decode"]


def test_forward_unembed_search_draws_no_tile():
    """Why the card run leaves the forward unembed (m256 k1600 n32001)
    plain: 32001 = 3 x 10667 with 10667 prime, so K1's bn is 1 or 3 (a
    wider tile needs more than its 512 threads), and under the grid cap a
    tile then needs bm·bk >= 16,667.  The search the card runs (a fresh
    search and three reseeded ones, each given its patience, through the
    lowering's checks, which need no card) draws no such tile: every
    candidate is rejected before it is timed.  The decode unembed (m4)
    has tiles that its search reaches, and is tuned."""
    import repro_torch
    from repro_torch.search.evolutionary import SearchConfig

    key = "dense/k=1600/m=256/n=32001"
    task = TuneTask(key=key, func=tget("dense", m=256, n=32001, k=1600))
    search = SearchConfig(max_trials=32, init_random=8, population=16,
                          measure_per_round=8, rollout_factor=2)
    errors = []
    for seed in range(4):
        config = repro_torch.TuneConfig(
            search=dataclasses.replace(search, seed=seed), runner_spec="cached+local",
            backend="cuda", device="cpu", warm_start=False)
        sched = repro_torch.TaskScheduler([task], database=Database(), config=config)
        for _ in range(config.patience + 1):
            assert sched.tune(total_rounds=1)[key] == float("inf")
        errors += [err for s in sched.searches for _, err in s.errors]
    assert errors
    assert all(err.startswith(("rejected (", "invalid trace")) for err in errors)
    assert any(err.startswith("rejected (grid)") and "(256, 3, 64)" in err
               for err in errors)


@pytest.mark.parametrize("seed", range(4))
def test_train_step_product_of_65536_batches_is_tuned(seed):
    """The train step at batch 8, seq 128 extracts a batched product of
    65536 batches (m1 k1 n25, a tuning target of the SSD mixer).  One K2
    launch covers at most 65,535 batches (the card's grid y), so the
    wrapper runs it as two; the search's first round, for every seed the
    card run uses, reaches a tile the lowering accepts: bn 25, the only
    one under the grid-steps cap."""
    import repro_torch
    from repro_torch.kernels import matmul as mm
    from repro_torch.search.evolutionary import SearchConfig

    key = "batch_matmul/b=65536/k=1/m=1/n=25"
    task = TuneTask(key=key, func=tget("batch_matmul", b=65536, m=1, n=25, k=1))
    search = SearchConfig(max_trials=32, init_random=8, population=16,
                          measure_per_round=8, rollout_factor=2, seed=seed)
    config = repro_torch.TuneConfig(search=search, runner_spec="cached+local",
                                    backend="cuda", device="cpu", warm_start=False)
    db = Database()
    sched = repro_torch.TaskScheduler([task], database=db, config=config)
    assert sched.tune(total_rounds=1)[key] < float("inf")
    blocks = tuple(db.best(key).meta["pallas_blocks_snapped"])
    assert blocks == (1, 25, 1)
    cfg = mm.launch_config(65536, 1, 25, 1, blocks)
    assert cfg["variant"] == "splitk" and cfg["grid"] == (1, 65535, 1)
    assert mm.batches_per_launch("splitk", 65536, 1) == 65535
    errors = [err for s in sched.searches for _, err in s.errors]
    assert all(err.startswith("rejected (grid)") for err in errors)


# ---------------------------------------------------------------------------
# the train step: remat through the hybrid layer, K2's gradient
# ---------------------------------------------------------------------------

# the loss within 1e-5 of itself; each gradient leaf within 5e-4 of its max
# |g|.  The smoke hybrid is ill-conditioned in float32: one-ulp noise in its
# parameters alone moves the logits by 1.7e-5-3.7e-5 of max |logit| at
# this batch, so the two packages' sums in other orders put the forward
# 7e-5 apart and the gradients up to 1.8e-4 of a leaf's max |g| (dt_bias)
TOL_LOSS = 1e-5
TOL_GRAD = 5e-4
TRAIN_B = 2


def _loss_batch(vocab, seed=5):
    """Tokens (2, 33) from a numpy seed.  Seeds 5 and 7 give finite
    gradients in both packages; 1, 3 and 6 do not, in both alike
    (``test_overflowing_ssd_decay_gives_the_references_nan_gradients``)."""
    return np.random.default_rng(seed).integers(0, vocab, (TRAIN_B, SEQ + 1)).astype(np.int32)


def _stored_contractions(jc, tc):
    """The two chunked contractions of the train step's forward (batch 2,
    seq 32), each with the same stored trace (its JSON) in both packages'
    databases: the first the port's space generates that its validator
    accepts."""
    from repro_torch.core.modules import SpaceGenerator, default_modules
    from repro_torch.core.validator import validate_trace

    kw = dict(batch=TRAIN_B, seq=SEQ, min_task_elems=1, dispatchable_only=True)
    specs = [t for t in TE.extract_task_specs(tc, **kw) if t.op == "batch_matmul"]
    assert _fields(specs) == _fields([t for t in JE.extract_task_specs(jc, mesh=None, **kw)
                                      if t.op == "batch_matmul"])
    jdb, db, jtasks, tasks = JDatabase(), Database(), [], []
    for t in specs:
        func = tget(t.op, **t.kwargs)
        gen = SpaceGenerator(default_modules())
        tr = next(tr for tr in (gen.generate(func, seed=s).trace for s in range(32))
                  if validate_trace(func, tr).ok)
        jdb.put(JRecord(t.key, tr.to_json(), 1e-5))
        db.put(TuningRecord(t.key, tr.to_json(), 1e-5))
        jtasks.append(type("T", (), dict(key=t.key, func=jget(t.op, **t.kwargs))))
        tasks.append(TuneTask(key=t.key, func=func))
    return JDispatch(jdb, tasks=jtasks), DispatchContext(db, tasks=tasks), specs


def _close_grads(jg, tg, tol):
    from repro_torch.training.optimizer import tree_leaves

    jl, tl = jax.tree_util.tree_leaves(jg), tree_leaves(tg)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a, b = np.asarray(a, np.float32), b.detach().float().numpy()
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol * max(np.abs(a).max(), 1e-30)


@pytest.mark.parametrize("dispatch", [False, True])
def test_loss_and_every_gradient_match_the_reference(hymba, dispatch):
    """hymba's ``loss_fn`` (per-layer remat through the hybrid layer) and
    every gradient leaf at depth 6, against the reference's
    ``jax.value_and_grad`` of its loss; with ``dispatch`` both run under a
    DispatchContext holding the chunked attention's two contractions (K2
    on the card, the plain version here), whose gradient is the plain
    product's.  The six leaves that reach the loss only through the SSD
    scan get a non-zero gradient."""
    from repro_torch.training.train_loop import value_and_grad

    jc, tc, jp, tp = hymba
    toks = _loss_batch(jc.vocab)
    jctx, ctx, specs = _stored_contractions(jc, tc) if dispatch else (None, None, [])
    with jctx if dispatch else _null():
        jl, jg = jax.value_and_grad(
            lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}))(jp)
    with ctx if dispatch else _null():
        tl, tg = value_and_grad(lambda p, b: TT.loss_fn(tc, p, b), tp,
                                {"tokens": torch.from_numpy(toks)})
    assert abs(float(tl) - float(jl)) <= TOL_LOSS * abs(float(jl))
    _close_grads(jg, tg, TOL_GRAD)
    for name in ("wx", "wB", "wC", "wdt", "A_log", "dt_bias"):
        assert float(tg["layers"]["ssd"][name].abs().max()) > 0
    if dispatch:
        # each contraction once a layer in the forward and once in remat's
        # recompute; the reference's scan traces its body once
        assert ctx.hits_by_key == {t.key: 2 * DEPTH for t in specs}
        assert set(jctx.hits_by_key) == {t.key for t in specs}


def _null():
    import contextlib

    return contextlib.nullcontext()


def test_remat_recompute_keeps_the_traced_window_as_the_reference(hymba):
    """The (site, reason) pairs of the remat forward and its recompute,
    ``traced_window`` among them, are the reference's under
    ``jax.value_and_grad``.  Backward runs after leaving the ``with`` block,
    as autograd's device thread sees it: the recompute re-enters the
    context with the layer's :class:`~repro_torch.models.layers.TracedWindow`,
    so every layer's attention notes ``traced_window`` twice, each
    contraction hits twice, and the gradients are those of a backward run
    inside the block."""
    from repro_torch.training.optimizer import tree_leaves, tree_map
    from repro_torch.training.train_loop import value_and_grad

    jc, tc, jp, tp = hymba
    toks = _loss_batch(jc.vocab, seed=7)
    jctx, ctx, specs = _stored_contractions(jc, tc)
    with jctx:
        jax.value_and_grad(lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}))(jp)
    batch = {"tokens": torch.from_numpy(toks)}
    with ctx:
        want_loss, want = value_and_grad(lambda p, b: TT.loss_fn(tc, p, b), tp, batch)
    assert _reasons(ctx) == _reasons(jctx)
    assert ("attention", "traced_window") in _reasons(ctx)
    assert ctx.stats_by_key()["site:attention"]["reasons"] == {"traced_window": 2 * DEPTH}
    _, ctx, _ = _stored_contractions(jc, tc)
    live = tree_map(lambda p: p.detach().requires_grad_(True), tp)
    with ctx:
        loss = TT.loss_fn(tc, live, batch)
    fwd = ctx.stats_by_key()["site:attention"]["reasons"]
    assert fwd == {"traced_window": DEPTH}
    loss.backward()
    assert ctx.stats_by_key()["site:attention"]["reasons"] == {"traced_window": 2 * DEPTH}
    assert ctx.hits_by_key == {t.key: 2 * DEPTH for t in specs}
    assert ctx.stats["attention_fused"] == 0
    assert torch.equal(loss.detach(), want_loss)
    for g, w in zip(tree_leaves(tree_map(lambda p: p.grad, live)), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_overflowing_ssd_decay_gives_the_references_nan_gradients(hymba):
    """A reference behaviour the port reproduces: the plain chunked scan
    masks the decay above the diagonal after its exp
    (``torch.where(tri, exp(diff), 0)``, ``kernels/ref.py:ssd_chunk_pass``,
    as ``jnp.where`` in the reference's), so where a chunk's summed decays
    overflow exp there, the masked branch's gradient is 0 x inf.  At these
    tokens both packages' losses are finite and their gradients NaN at the
    same elements."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import value_and_grad

    jc, tc, jp, tp = hymba
    toks = _loss_batch(jc.vocab, seed=1)
    jl, jg = jax.value_and_grad(
        lambda p: JT.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}))(jp)
    tl, tg = value_and_grad(lambda p, b: TT.loss_fn(tc, p, b), tp,
                            {"tokens": torch.from_numpy(toks)})
    assert np.isfinite(float(jl)) and abs(float(tl) - float(jl)) <= TOL_LOSS * abs(float(jl))
    want = jax.tree_util.tree_leaves(jg)
    got = [g for _, g in ckpt._flatten_with_paths(tg)]
    assert sum(int(np.isnan(np.asarray(a)).sum()) for a in want) > 0
    for a, b in zip(want, got):
        assert np.array_equal(np.isnan(np.asarray(a)), torch.isnan(b).numpy())
